"""The elastic shrink of the torch package against the JAX package's, on
the CPU: twins of the JAX package's ``tests/test_elastic.py``.

The JAX package shrinks a mesh of 8 virtual devices to 6 or 7; the port
shrinks a gloo world of 4 processes to 3 (``reform_mesh`` builds a
process group over the survivors; the excluded rank enters it and
leaves). One world runs every supervised case (``supervised_solve``
world task), each rank with the same fault plan: the acceptance shrink
(DEVICE_LOST of rank 3 at iteration 3, with the telemetry stream), the
``min_devices`` gate (degrade), and a persistent shard hang attributed
by the probe and shrunk out. Every answer is held to the JAX package's
fault-free sharded solve of the same problem; the block tier's case
(``block`` over the world's mesh, K 8 -> 9 after the shrink) to its
``mesh=None`` solve. A second world of 4 runs
the same rung on the row-sharded tier (``sparse-iterative`` over the
world's mesh) on a storm instance whose 175 rows split unevenly over 4
and then over the 3 survivors. The building blocks —
mesh re-formation and the health probes over the simulated-loss
registry — are checked in-process on local meshes.
"""

import json

import jax
import numpy as np
import pytest

from distributedlpsolver_tpu.ipm import solve as jsolve
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.parallel import make_hybrid_mesh as jmake_hybrid_mesh
from distributedlpsolver_tpu.parallel import make_mesh as jmake_mesh
from distributedlpsolver_tpu.parallel import reform_mesh as jreform_mesh
from distributedlpsolver_tpu_torch.distributed.launcher import run_world
from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib
from distributedlpsolver_tpu_torch.parallel import runtime
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

_PROBLEM = dict(m=20, n=45, seed=3)
_SUP = {"backoff_base": 0.001}
# The block tier's case (the fourth of the world): K = 8 blocks, two a rank
# over 4, then 3 a survivor over 3 with one dead block (K 8 -> 9).
_BLOCK = dict(instance="block", blocks=8, block_m=10, block_n=24, link=6, seed=3, sparse=False)
# Every rank hangs at iteration 4 while rank 3 is in the mesh; the nap
# outlasts the world, so an abandoned step never wakes into a collective.
_HANG = {"kind": "hang", "iteration": 4, "shard": 3, "times": None, "hang_seconds": 600.0}


@pytest.fixture(autouse=True)
def _clean_registry():
    runtime.restore_devices()
    yield
    runtime.restore_devices()


@pytest.fixture(scope="module")
def reference_result():
    """The JAX package's fault-free sharded solve (its 8 virtual devices)."""
    return jsolve(jgen.random_dense_lp(**_PROBLEM), backend="sharded", fused_loop=False)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """One gloo world of 4 ranks on the CPU running every supervised case."""
    work = tmp_path_factory.mktemp("shrink4")
    log = str(work / "telemetry.rank{rank}.jsonl")
    cases = [
        {**_PROBLEM, "faults": [{"kind": "device_lost", "iteration": 3, "device_ids": [3]}],
         "supervisor": _SUP, "log_jsonl": log},
        {**_PROBLEM, "faults": [{"kind": "device_lost", "iteration": 2, "device_ids": [1]}],
         "supervisor": {**_SUP, "min_devices": 4}},
        {**_PROBLEM, "faults": [_HANG],
         "supervisor": {**_SUP, "adaptive_timeout": True, "timeout_floor": 2.0,
                        "timeout_warmup": 3, "hang_shard_threshold": 2, "max_retries": 8}},
        {**_BLOCK, "backend": "block", "supervisor": _SUP,
         "faults": [{"kind": "device_lost", "iteration": 3, "device_ids": [3]}]},
    ]
    res = run_world("supervised_solve", {"cases": cases}, world_size=4, workdir=str(work),
                    device="cpu", timeout=300)
    return {rank: out["cases"] for rank, out in res.items()}, log


# A storm instance whose rows split unevenly over 4 (44, 44, 44, 43) and
# over the 3 survivors (59, 59, 57).
_STORM = dict(instance="storm", scenarios=7, block_m=25, block_n=36, first_stage_n=24, seed=3)
# The row-sharded tier's other registered names (cases 2 and 3 of the world).
_ALIASES = ("inexact-ipm", "sparse-pcg")


@pytest.fixture(scope="module")
def sparse_world4(tmp_path_factory):
    """One gloo world of 4 running the row-sharded tier's supervised cases:
    the loss of rank 3 at iteration 3, the same under ``min_devices=4``, and
    the loss again under the tier's other two names."""
    work = tmp_path_factory.mktemp("shrink4_sparse")
    case = {**_STORM, "backend": "sparse-iterative", "supervisor": _SUP,
            "faults": [{"kind": "device_lost", "iteration": 3, "device_ids": [3]}]}
    cases = [case, {**case, "supervisor": {**_SUP, "min_devices": 4}},
             *({**case, "backend": alias} for alias in _ALIASES)]
    res = run_world("supervised_solve", {"cases": cases}, world_size=4, workdir=str(work),
                    device="cpu", timeout=300)
    return {rank: out["cases"] for rank, out in res.items()}


@pytest.fixture(scope="module")
def sparse_reference():
    """The JAX package's single-device sparse-iterative solve."""
    spec = {k: v for k, v in _STORM.items() if k not in ("instance", "scenarios")}
    return jsolve(jgen.storm_sparse_lp(_STORM["scenarios"], **spec), backend="sparse-iterative",
                  tol=1e-8)


def _close(a, b, tol):
    return abs(a - b) <= tol * (1.0 + abs(b))


# -- mesh re-formation --------------------------------------------------------------


def test_reform_mesh_excludes_devices():
    mesh = mesh_lib.make_mesh(axis_names=("cols",), devices=["cpu"] * 8)
    jmesh = jmake_mesh()
    lost = list(mesh.device_ids)[-2:]
    smaller, jsmaller = mesh_lib.reform_mesh(mesh, exclude=lost), jreform_mesh(jmesh, exclude=[6, 7])
    assert smaller.size == jsmaller.devices.size == 6
    assert smaller.axis_names == jsmaller.axis_names == ("cols",)
    assert not set(smaller.device_ids) & set(lost)
    # Objects with an ``id`` are read by it, as the JAX package reads devices.
    class Dev:
        id = 0

    assert mesh_lib.reform_mesh(mesh, exclude=[Dev()]).device_ids == tuple(range(1, 8))


def test_reform_mesh_refuses_empty():
    mesh = mesh_lib.make_mesh(axis_names=("cols",), devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="no devices"):
        mesh_lib.reform_mesh(mesh, exclude=list(mesh.device_ids))


def test_reform_mesh_collapses_hybrid_to_1d():
    hybrid = mesh_lib.make_mesh((2, 4), axis_names=("hosts", "cols"), devices=["cpu"] * 8)
    smaller = mesh_lib.reform_mesh(hybrid, exclude=[0])
    jsmaller = jreform_mesh(jmake_hybrid_mesh(ici_parallelism=4, dcn_parallelism=2), exclude=[0])
    assert smaller.shape_tuple == jsmaller.devices.shape == (7,)
    assert smaller.axis_names == jsmaller.axis_names == ("cols",)


def test_a_shrunk_world_does_not_reform_again(monkeypatch):
    """A world's re-form is a collective of the whole world; once a shrink
    has excluded ranks (they left the solve), the survivors' mesh cannot
    enter ``new_group`` again: it raises instead of hanging."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    survivors = mesh_lib.Mesh((3,), ("cols",), "cpu", rank=0, group=object(),
                              pg_backend="gloo", ids=[0, 1, 2])
    with pytest.raises(ValueError, match="ranks that left"):
        mesh_lib.reform_mesh(survivors, exclude=[2])


# -- health probes -----------------------------------------------------------------


def test_probe_flags_simulated_loss():
    mesh = mesh_lib.make_mesh(axis_names=("batch",), devices=["cpu"] * len(jax.devices()))
    healthy, unhealthy = runtime.probe_mesh(mesh)
    assert unhealthy == [] and healthy == list(mesh.device_ids)
    runtime.simulate_device_loss([2, 5])
    healthy, unhealthy = runtime.probe_mesh(mesh)
    assert sorted(unhealthy) == [2, 5] and len(healthy) == mesh.size - 2
    runtime.restore_devices([2])
    assert runtime.probe_mesh(mesh)[1] == [5]
    # One registry: the plane's device-keyed losses share it.
    from distributedlpsolver_tpu_torch.utils import accel

    accel.simulate_device_loss(["cpu"])
    assert runtime.simulated_lost_devices() == frozenset({5, "cpu"})
    assert accel.probe_devices(["cpu"], deadline=0.5)[1] == [mesh_lib.torch.device("cpu")]


# -- the acceptance scenario (4 -> 3) --------------------------------------------------


def test_device_loss_shrinks_mesh_and_converges(world4, reference_result):
    """Injected loss of rank 3 of 4: the survivors finish via the SHRINK
    rung on the sharded backend (no fallback), with one x among them,
    within 1e-8 of the fault-free objective; rank 3 entered the re-form
    and left."""
    res, _ = world4
    left = res[3][0]
    assert left["left"] is True and left["faults"][0]["action"] == "shrink:4->3"
    shas = set()
    for rank in (0, 1, 2):
        r = res[rank][0]
        assert r["left"] is False and r["status"] == "optimal" and r["backend"] == "sharded"
        assert [f["kind"] for f in r["faults"]] == ["device_lost"]
        f = r["faults"][0]
        assert f["action"] == "shrink:4->3" and f["devices"] == [3]
        assert f["recovery_overhead_s"] > 0.0
        assert _close(r["objective"], reference_result.objective, 1e-8)
        shas.add(r["x_sha256"])
    assert len(shas) == 1


def test_device_loss_below_min_devices_degrades(world4):
    """With min_devices above the survivor count the SHRINK rung is gated
    off and every rank degrades to ``cuda`` (the JAX package's ``tpu``)."""
    res, _ = world4
    for rank in range(4):
        r = res[rank][1]
        assert r["status"] == "optimal" and r["backend"] == "cuda"
        assert r["faults"][0]["action"] == "degrade:cuda"


def test_persistent_shard_hang_attributed_and_shrunk(world4, reference_result):
    """'Shard 3 always hangs': two watchdog timeouts the probe attributes
    to rank 3 promote it to a loss — rollback first, then the shrink;
    the survivors finish on 3 ranks."""
    res, _ = world4
    for rank in (0, 1, 2):
        r = res[rank][2]
        assert r["status"] == "optimal" and r["backend"] == "sharded"
        assert [f["kind"] for f in r["faults"]] == ["hang", "hang"]
        assert r["faults"][0]["action"] == "rollback"
        assert r["faults"][1]["action"] == "shrink:4->3" and r["faults"][1]["devices"] == [3]
        assert _close(r["objective"], reference_result.objective, 1e-6)
        assert r["wall_s"] < 120.0  # the 600 s naps were abandoned
    assert res[3][2]["left"] is True


def test_fault_and_resume_events_in_jsonl(world4):
    """Rank 0's telemetry stream carries the fault classification and the
    resume with its recovery overhead, among the iteration records of
    every attempt (append mode); the excluded rank's carries its shrink."""
    res, log = world4
    records = [json.loads(ln) for ln in open(log.format(rank=0)).read().splitlines()]
    events = [rec for rec in records if "event" in rec]
    iters = [rec for rec in records if "event" not in rec]
    fault_ev = [e for e in events if e["event"] == "fault"]
    resume_ev = [e for e in events if e["event"] == "resume"]
    assert len(fault_ev) == 1 and len(resume_ev) == 1
    assert fault_ev[0]["kind"] == "device_lost" and fault_ev[0]["action"] == "shrink:4->3"
    assert fault_ev[0]["devices"] == [3] and fault_ev[0]["rank"] == 0
    assert resume_ev[0]["recovery_overhead_s"] > 0.0
    assert resume_ev[0]["recovery_overhead_s"] == pytest.approx(
        res[0][0]["faults"][0]["recovery_overhead_s"], abs=1e-6)
    assert [rec["iter"] for rec in iters][:2] == [1, 2]
    left = [json.loads(ln) for ln in open(log.format(rank=3)).read().splitlines()]
    assert [e["action"] for e in left if e.get("event") == "fault"] == ["shrink:4->3"]


def test_block_device_loss_shrinks_blocks_and_converges(world4):
    """The loss of rank 3 of 4 on ``block``: the survivors re-split the K
    axis over 3 (``reshard``: 8 blocks padded to 9 with a dead one), resume
    from rank 0's checkpoint and finish OPTIMAL on the tier with one x among
    them, within 1e-8 of the JAX package's ``mesh=None`` objective; rank 3
    entered the re-form and left."""
    ref = jsolve(jgen.block_angular_lp(8, 10, 24, 6, seed=3, sparse=False), backend="block",
                 tol=1e-8)
    res, _ = world4
    left = res[3][3]
    assert left["left"] is True and left["faults"][0]["action"] == "shrink:4->3"
    shas = set()
    for rank in (0, 1, 2):
        r = res[rank][3]
        assert r["left"] is False and r["status"] == "optimal" and r["backend"] == "block"
        (f,) = r["faults"]
        assert f["kind"] == "device_lost" and f["action"] == "shrink:4->3"
        assert f["devices"] == [3] and f["recovery_overhead_s"] > 0.0
        assert _close(r["objective"], ref.objective, 1e-8)
        shas.add(r["x_sha256"])
    assert len(shas) == 1


# -- the row-sharded tier (sparse-iterative) ---------------------------------------


def test_sparse_iterative_device_loss_shrinks_rows_and_converges(sparse_world4,
                                                                 sparse_reference):
    """The loss of rank 3 of 4 on ``sparse-iterative``: the survivors
    re-split the rows over 3 (``reshard``), resume from rank 0's checkpoint
    and finish OPTIMAL on the tier with one x among them, within 1e-8 of
    the JAX package's objective; rank 3 entered the re-form and left."""
    left = sparse_world4[3][0]
    assert left["left"] is True and left["faults"][0]["action"] == "shrink:4->3"
    shas = set()
    for rank in (0, 1, 2):
        r = sparse_world4[rank][0]
        assert r["left"] is False and r["status"] == "optimal"
        assert r["backend"] == "sparse-iterative"
        (f,) = r["faults"]
        assert f["kind"] == "device_lost" and f["action"] == "shrink:4->3"
        assert f["devices"] == [3] and f["recovery_overhead_s"] > 0.0
        assert _close(r["objective"], sparse_reference.objective, 1e-8)
        shas.add(r["x_sha256"])
    assert len(shas) == 1


def test_sparse_iterative_below_min_devices_degrades_alike(sparse_world4, sparse_reference):
    """With ``min_devices=4`` the shrink is gated off and every rank takes
    the same degradation (the host rung, the backend being on the CPU)."""
    for rank in range(4):
        r = sparse_world4[rank][1]
        assert r["left"] is False and r["status"] == "optimal"
        assert r["backend"] == "cpu-sparse"
        assert [f["action"] for f in r["faults"]] == ["degrade:cpu-sparse"]
        assert _close(r["objective"], sparse_reference.objective, 1e-8)
    assert len({sparse_world4[rank][1]["x_sha256"] for rank in range(4)}) == 1


@pytest.mark.parametrize("case", [2, 3], ids=_ALIASES)
def test_sparse_iterative_aliases_take_the_worlds_mesh(sparse_world4, case):
    """Under ``inexact-ipm`` and ``sparse-pcg`` the case builds the same
    row-sharded backend on the world's mesh: the loss of rank 3 shrinks the
    rows to the 3 survivors, and the answer is the canonical name's, bit
    for bit."""
    assert sparse_world4[3][case]["left"] is True
    for rank in (0, 1, 2):
        r = sparse_world4[rank][case]
        assert r["status"] == "optimal" and r["backend"] == "sparse-iterative"
        assert [f["action"] for f in r["faults"]] == ["shrink:4->3"]
        assert r["x_sha256"] == sparse_world4[rank][0]["x_sha256"]
