"""The port's column-sharded dense backend (``sharded``) against the JAX
package's, on the CPU.

The JAX ``ShardedJaxBackend`` runs on a mesh of K of the conftest's 8
virtual devices; the port's runs on gloo worlds of K = 2 and 4 processes
launched through the port's launcher (one world of each size for the
whole module, ``sharded_cases``), and as a world of one in-process. On
the JAX package's own cases (``tests/test_sharded.py``): status and
iterations equal, objectives within 1e-8 relative, and every rank of a
world holding the same x bits. The sharded ``LinOps`` are held to the
dense ones at 1e-12 on shards of a padded, uneven n; the mesh, the world
config and the backend's names and refusals are checked in-process, and
the supervisor's ladder is held to the JAX package's where it now takes
the ``sharded`` rung.
"""

import numpy as np
import pytest
import torch

import jax
from distributedlpsolver_tpu import supervisor as jsup
from distributedlpsolver_tpu.backends.sharded import ShardedJaxBackend
from distributedlpsolver_tpu.ipm import solve as jsolve
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.parallel import make_mesh as jmake_mesh
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.backends.dense import _make_ops
from distributedlpsolver_tpu_torch.backends.sharded import ShardedTorchBackend, StageClock
from distributedlpsolver_tpu_torch.distributed import world as world_lib
from distributedlpsolver_tpu_torch.distributed.launcher import run_world
from distributedlpsolver_tpu_torch.ipm import SolverConfig, Status, solve
from distributedlpsolver_tpu_torch.models import random_dense_lp, random_general_lp, to_interior_form
from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib
from distributedlpsolver_tpu_torch.supervisor import supervisor as sup_mod
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"
TOL = 1e-8

# The JAX package's sharded cases: (generator, m, n, seed).
CASES = [("dense", 24, 64, 0), ("dense", 24, 64, 3), ("general", 20, 40, 1), ("dense", 15, 37, 2)]
IDS = [f"{g}_{m}x{n}_s{s}" for g, m, n, s in CASES]
LINOPS = {"check": "linops", "m": 15, "n": 37, "seed": 2, "vec_seed": 7}
# A 2-D mesh over the world of 4: columns over the inner axis of 2.
HYBRID = {"m": 24, "n": 64, "seed": 0, "tol": TOL, "hybrid": [2, 2]}
# The sharded PCG (tests/test_torch_sharded_pcg.py): a reference mesh
# instance forced, and the three-phase plan of the TPU schedule.
PCG_CASES = [
    {"m": 48, "n": 120, "seed": 11, "tol": TOL, "solve_mode": "pcg"},
    {"m": 40, "n": 100, "seed": 1, "tol": TOL, "solve_mode": "pcg", "schedule_platform": "tpu"},
]
PCG_IDS = ["pcg_48x120_s11", "tpu_pcg_40x100_s1"]


def _port_problem(g, m, n, s):
    return (random_dense_lp if g == "dense" else random_general_lp)(m, n, seed=s)


def _jax_problem(g, m, n, s):
    return (jgen.random_dense_lp if g == "dense" else jgen.random_general_lp)(m, n, seed=s)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One gloo world of each size for the module: every case, and the
    LinOps check, through ``sharded_cases``."""
    cases = [{"instance": g, "m": m, "n": n, "seed": s, "tol": TOL} for g, m, n, s in CASES]
    out = {}
    for k in (2, 4):
        extra = [HYBRID] if k == 4 else []
        out[k] = run_world("sharded_cases",
                           {"cases": cases + extra + PCG_CASES + [LINOPS]}, world_size=k,
                           workdir=str(tmp_path_factory.mktemp(f"world{k}")), device=CPU,
                           timeout=240)
    return out


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX sharded backend on meshes of 1, 2 and 4 virtual devices."""
    out = {}
    for k in (1, 2, 4):
        for case in CASES:
            be = ShardedJaxBackend(mesh=jmake_mesh(devices=jax.devices()[:k]))
            out[k, case] = jsolve(_jax_problem(*case), backend=be, tol=TOL)
    return out


@pytest.fixture(scope="module")
def jax_sharded_pcg():
    """The JAX sharded backend's PCG on meshes of 2 and 4 virtual devices
    (the TPU schedule's case under its platform gate, forced open)."""
    out = {}
    for k in (2, 4):
        for i, case in enumerate(PCG_CASES):
            be = ShardedJaxBackend(mesh=jmake_mesh(devices=jax.devices()[:k]))
            p = jgen.random_dense_lp(case["m"], case["n"], seed=case["seed"])
            with pytest.MonkeyPatch.context() as mp:
                if case.get("schedule_platform") == "tpu":
                    mp.setattr(jax, "default_backend", lambda: "tpu")
                r = jsolve(p, backend=be, tol=TOL, solve_mode="pcg", use_pallas=False)
            # The JAX package reports phases on its segmented routes alone.
            phases = [(ph["mode"], ph["iters"]) for ph in getattr(be, "phase_report", [])]
            out[k, i] = r, phases or [("pcg", r.iterations)]
    return out


def _close(a, b):
    return abs(a - b) <= TOL * max(1.0, abs(b))


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gloo_world_matches_the_jax_sharded_backend(worlds, jax_sharded, k, case):
    ref = jax_sharded[k, case]
    res = worlds[k]
    assert sorted(res) == list(range(k))
    outs = [res[r]["cases"][CASES.index(case)] for r in range(k)]
    assert len({o["x_sha256"] for o in outs}) == 1  # every rank, the same x bits
    for rank, o in enumerate(outs):
        assert o["status"] == ref.status.value == "optimal", (rank, o)
        assert o["iterations"] == ref.iterations, (rank, o["iterations"], ref.iterations)
        assert _close(o["objective"], ref.objective), (rank, o["objective"], ref.objective)
        assert res[rank]["world_size"] == k and res[rank]["pg_backend"] == "gloo"


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("i", range(len(PCG_CASES)), ids=PCG_IDS)
def test_gloo_world_pcg_matches_the_jax_sharded_backend(worlds, jax_sharded_pcg, k, i):
    """The sharded PCG over gloo worlds of 2 and 4 (each rank its block
    and its ``L⁻¹`` slab): every rank the same x bits and the JAX sharded
    backend's status, iterations, phases and objective on its mesh of k."""
    ref, ref_phases = jax_sharded_pcg[k, i]
    at = len(CASES) + (k == 4) + i  # the world of 4 runs HYBRID first
    outs = [worlds[k][r]["cases"][at] for r in range(k)]
    assert len({o["x_sha256"] for o in outs}) == 1
    for rank, o in enumerate(outs):
        assert o["status"] == ref.status.value == "optimal", (rank, o)
        assert o["iterations"] == ref.iterations, (rank, o["iterations"], ref.iterations)
        assert _close(o["objective"], ref.objective), (rank, o["objective"], ref.objective)
        assert [(ph["mode"], ph["iters"]) for ph in o["phase_report"]] == ref_phases
        assert o["cg_report"]["solves"] > 0 and o["cg_report"]["cg_live"] > 0
        assert o["shard_shape"] == [PCG_CASES[i]["m"], PCG_CASES[i]["n"] // k]


def test_a_hybrid_mesh_splits_columns_over_its_inner_axis(worlds):
    """``make_hybrid_mesh(2, 2)`` over the world of 4: columns split over
    the inner axis (its fibers' process groups reduce), replicated over
    the outer; the JAX sharded backend on the same (2, 2) mesh."""
    from distributedlpsolver_tpu.parallel.mesh import make_mesh as jmesh

    be = ShardedJaxBackend(mesh=jmesh((2, 2), ("hosts", "cols"), devices=jax.devices()[:4]))
    ref = jsolve(jgen.random_dense_lp(24, 64, seed=0), backend=be, tol=TOL)
    outs = [worlds[4][r]["cases"][len(CASES)] for r in range(4)]
    assert [o["shard_shape"] for o in outs] == [[24, 32]] * 4
    assert len({o["x_sha256"] for o in outs}) == 1
    for o in outs:
        assert o["status"] == ref.status.value == "optimal" and o["iterations"] == ref.iterations
        assert _close(o["objective"], ref.objective)


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_linops_match_the_dense_ones_on_uneven_shards(worlds, k):
    """n = 37 pads to a multiple of k (zero columns); each rank's matvec,
    rmatvec, regularized M and solve equal the dense LinOps' on the
    padded matrix at 1e-12, and every rank holds the same bits."""
    outs = [worlds[k][r]["cases"][-1] for r in range(k)]
    o = outs[0]
    n_pad = o["n_padded"]
    assert n_pad % k == 0 and n_pad > 37
    assert [tuple(x["cols"]) for x in outs] == [(r * n_pad // k, (r + 1) * n_pad // k)
                                                for r in range(k)]
    for key in ("matvec", "rmatvec", "M", "solve", "ranks"):
        assert all(x[key] == o[key] for x in outs[1:]), key
    assert o["ranks"] == list(range(k))  # World.allgather, rank-ordered on every rank
    inf = to_interior_form(random_dense_lp(LINOPS["m"], LINOPS["n"], seed=LINOPS["seed"]))
    A = np.hstack([np.asarray(inf.A), np.zeros((inf.m, n_pad - inf.n))])
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    ops = _make_ops(t(A), o["reg"], torch.float64, SolverConfig().refine_steps)
    factors = ops.factorize(t(o["d"]))
    dense = {"matvec": ops.matvec(t(o["v"])), "rmatvec": ops.rmatvec(t(o["y"])), "M": factors[1],
             "solve": ops.solve(factors, t(o["r"]))}
    for key, want in dense.items():
        got = t(o[key])
        assert (got - want).norm() <= 1e-12 * want.norm(), key


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_world_of_one_in_process(jax_sharded, case):
    """Without a process group the sharded backend is a world of one: the
    dense backend's bits, and the JAX sharded backend's verdict on one
    device."""
    be = get_backend("sharded", device=CPU)
    r = solve(_port_problem(*case), backend=be, tol=TOL)
    rd = solve(_port_problem(*case), backend=get_backend("cuda", device=CPU), tol=TOL)
    ref = jax_sharded[1, case]
    assert r.status == Status.OPTIMAL and r.status.value == ref.status.value
    assert r.iterations == rd.iterations == ref.iterations
    assert np.array_equal(r.x, rd.x)
    assert _close(r.objective, ref.objective)
    assert be.mesh.size == 1 and be.mesh.group is None


@pytest.mark.parametrize("name", ["sharded", "tpu-sharded", "mesh"])
def test_the_names_resolve_and_the_unported_seams_raise(name):
    """``prec_sharding`` (item 5b-1, once refused) is the column split of
    the mesh's variable axis, known from setup on; the block tier's PCG
    is still refused (item 5b). ``reshard`` (item 13b, once refused) hands
    back a fresh backend on the given mesh, on the same device, that
    solves as the original does."""
    be = get_backend(name, device=CPU)
    assert isinstance(be, ShardedTorchBackend) and be.name == "sharded"
    with pytest.raises(RuntimeError, match="setup"):
        be.prec_sharding()
    be.setup(to_interior_form(random_dense_lp(12, 30, seed=1)), SolverConfig())
    prec = be.prec_sharding()
    assert (prec.mesh, prec.axis, prec.dim) == (be.mesh, "cols", 1)
    with pytest.raises(NotImplementedError, match="item 5b"):
        solve(random_dense_lp(12, 30, seed=1), backend=get_backend("block", device=CPU),
              solve_mode="pcg")
    mesh = mesh_lib.make_mesh(device=CPU)
    fresh = be.reshard(mesh)
    assert isinstance(fresh, ShardedTorchBackend) and fresh is not be
    assert fresh.mesh is mesh and fresh.device == be.device
    p = random_dense_lp(12, 30, seed=1)
    assert np.array_equal(solve(p, backend=fresh, tol=TOL).x, solve(p, backend=be, tol=TOL).x)


def test_the_stage_clock_is_one_switch_for_capture():
    """Setting ``clock`` decides capture: a clocked step runs uncaptured
    and says why, whether the clock was set before setup or after, and
    taking the clock away lets the loop capture again. The clock changes
    no bit of the answer."""
    p = random_dense_lp(16, 40, seed=0)
    be = ShardedTorchBackend(device=CPU)
    assert be.capture and be.capture_off_reason is None
    be.clock = StageClock(be.device)
    assert not be.capture and "stage clock" in be.capture_off_reason
    r = solve(p, backend=be, tol=TOL)
    assert not be.capture and be.clock.report()["calls"]["k1"] > 0
    be.clock = None
    assert be.capture and be.capture_off_reason is None
    rd = solve(p, backend=get_backend("cuda", device=CPU), tol=TOL)
    assert r.iterations == rd.iterations and np.array_equal(r.x, rd.x)


def test_make_mesh_without_a_world():
    m = mesh_lib.make_mesh(device=CPU)
    assert (m.size, m.shape, m.rank, m.device.type) == (1, {"cols": 1}, 0, "cpu")
    assert m.col_range(10) == (0, 10) and not mesh_lib.is_multiprocess(m)
    with pytest.raises(ValueError, match="device count"):
        mesh_lib.make_mesh((3,), device=CPU)
    with pytest.raises(ValueError, match="axis names"):
        mesh_lib.make_mesh((1, 1), axis_names=("cols",), device=CPU)
    # reform_mesh (item 13b, once refused): excluding nothing keeps the
    # world of one; excluding its one member leaves no devices.
    assert mesh_lib.reform_mesh(m).size == 1
    with pytest.raises(ValueError, match="no devices"):
        mesh_lib.reform_mesh(m, exclude=[0])
    A = np.arange(12.0).reshape(2, 6)
    assert np.array_equal(mesh_lib.col_sharding(m).local(A), A)
    assert np.array_equal(mesh_lib.replicated(m).local(A), A)


def test_a_mesh_shape_other_than_the_world_size_raises():
    """``SolverConfig.mesh_shape`` is honoured over the world's ranks: a
    shape that does not tile them raises at setup (``make_mesh``'s rule)."""
    be = get_backend("sharded", device=CPU)
    with pytest.raises(ValueError, match="device count"):
        solve(random_dense_lp(8, 20, seed=0), backend=be, mesh_shape=(3,))
    r = solve(random_dense_lp(8, 20, seed=0), backend=get_backend("sharded", device=CPU),
              mesh_shape=(1,), mesh_axis="cols")
    assert r.status == Status.OPTIMAL


@pytest.mark.parametrize("cfg, match", [
    (world_lib.WorldConfig(device=CPU, local_devices=2), "one process per"),
    (world_lib.WorldConfig(device=CPU, pg_backend="nccl"), "nccl backend needs CUDA"),
    (world_lib.WorldConfig(device=CPU, pg_backend="mpi"), "unknown process-group"),
    (world_lib.WorldConfig(device=CPU, world_size=2), "coordinator"),
])
def test_world_config_refusals(cfg, match):
    with pytest.raises(ValueError, match=match):
        world_lib.init_world(cfg)


def test_world_env_contract(monkeypatch):
    for k, v in {"DLPS_COORDINATOR": "127.0.0.1:9", "DLPS_RANK": "1", "DLPS_WORLD_SIZE": "3",
                 "DLPS_DEVICE": "cpu", "DLPS_PG_BACKEND": "gloo", "DLPS_WORLD_GEN": "2"}.items():
        monkeypatch.setenv(k, v)
    cfg = world_lib.WorldConfig.from_env()
    assert (cfg.coordinator, cfg.rank, cfg.world_size, cfg.device, cfg.pg_backend,
            cfg.generation) == ("127.0.0.1:9", 1, 3, "cpu", "gloo", 2)
    assert world_lib.pg_backend_for(cfg, torch.device("cpu")) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        world_lib.rank_device(world_lib.WorldConfig())


def _ladders(port_backend, jax_backend, plan_kw):
    out = []
    for mod, backend, problem in (
        (sup_mod, port_backend, random_dense_lp(20, 45, seed=3)),
        (jsup, jax_backend, jgen.random_dense_lp(20, 45, seed=3)),
    ):
        plan = [mod.InjectedFault(mod.FaultKind[k], **v) for k, v in plan_kw]
        cfg = mod.SupervisorConfig(backoff_base=0.001, fault_plan=plan)
        out.append(mod.supervised_solve(problem, backend=backend, supervisor=cfg))
    return out


@pytest.mark.parametrize("port, jax_name, rung", [
    # The sharded backend's own ladder, then its next rung (cuda / tpu).
    (lambda: get_backend("sharded", device=CPU), "sharded", ("cuda", "tpu")),
    # Registering sharded puts it first on auto's chain, as in the JAX package.
    (lambda: get_backend("auto", device=CPU), "auto", ("sharded", "sharded")),
])
def test_the_ladder_matches_the_jax_supervisor(port, jax_name, rung):
    plan = [("NUMERICAL", {"iteration": 4, "times": 4})]
    rt, rj = _ladders(port(), jax_name, plan)
    actions = ["rollback", "rollback+reg_bump", "recenter"]
    assert [f.action for f in rt.faults] == actions + [f"degrade:{rung[0]}"]
    assert [f.action for f in rj.faults] == actions + [f"degrade:{rung[1]}"]
    assert rt.status.value == rj.status.value == "optimal"
    assert (rt.backend, rj.backend) == rung
    assert abs(rt.objective - rj.objective) <= 1e-6 * (1 + abs(rj.objective))


def test_a_hang_on_a_sharded_solve_probes_and_rolls_back():
    """A HANG on a mesh backend probes the mesh's devices; healthy, the
    ladder goes on with a rollback, as the JAX supervisor's elastic
    attribution does (not run side by side here: the JAX sharded step's
    first compile alone can outlast a short deadline)."""
    deadline = 0.25
    plan = [sup_mod.InjectedFault(sup_mod.FaultKind.HANG, iteration=3, hang_seconds=20 * deadline)]
    cfg = sup_mod.SupervisorConfig(backoff_base=0.001, fault_plan=plan, step_timeout=deadline)
    r = sup_mod.supervised_solve(random_dense_lp(20, 45, seed=3),
                                 backend=get_backend("sharded", device=CPU), supervisor=cfg)
    ref = solve(random_dense_lp(20, 45, seed=3), backend=get_backend("cuda", device=CPU))
    assert [(f.kind.value, f.action, f.iteration) for f in r.faults] == [("hang", "rollback", 3)]
    assert r.status == Status.OPTIMAL and r.backend == "sharded"
    assert abs(r.objective - ref.objective) <= 1e-6 * (1 + abs(ref.objective))


def test_init_distributed_without_a_world():
    from distributedlpsolver_tpu_torch.parallel import runtime

    assert runtime.init_distributed() == {"process_id": 0, "num_processes": 1,
                                          "local_devices": 1, "global_devices": 1}
    assert runtime.is_primary() and runtime.current_world() is None


def test_supervision_over_a_world_of_processes_is_refused(monkeypatch):
    """Supervision over a world of processes (item 13b, once refused):
    every rank takes rank 0's checkpoint path (a broadcast), and a retry
    waits at a barrier before it reads the file. Here the world is faked
    around one process: the broadcast hands back rank 0's path and the
    solve, faulted once, rolls back and converges."""
    from distributedlpsolver_tpu_torch.parallel import runtime
    from distributedlpsolver_tpu_torch.supervisor import FaultKind, InjectedFault, SupervisorConfig

    shared, barriers = [], []
    monkeypatch.setattr(runtime, "world", lambda: {"num_processes": 2, "process_id": 0})
    monkeypatch.setattr(sup_mod, "_shared_value", lambda v, in_world: shared.append(v) or v)
    monkeypatch.setattr(runtime, "barrier", lambda mesh=None: barriers.append(mesh))
    plan = [InjectedFault(FaultKind.CRASH, iteration=3)]
    r = sup_mod.supervised_solve(random_dense_lp(8, 20, seed=0),
                                 backend=get_backend("sharded", device=CPU),
                                 supervisor=SupervisorConfig(fault_plan=plan, backoff_base=0.0))
    assert r.status == Status.OPTIMAL and [f.action for f in r.faults] == ["rollback"]
    assert len(shared) == 1 and shared[0] is not None
    assert barriers  # the retry waited for rank 0's checkpoint
