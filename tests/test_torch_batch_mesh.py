"""The batch-axis mesh of the torch package against the JAX package's, on
the CPU.

The JAX package splits a bucket's lanes over a mesh of the conftest's 8
virtual host devices; the port over a local mesh that names the CPU
device K times (``parallel/mesh.py``), each executor solving its lane
block through its own program. Twins of the JAX package's
``tests/test_serve_pipeline.py::TestMeshBucketDispatch``, its service's
mesh dispatch and reshard, and ``tests/test_batched.py::
test_batch_sharded_over_mesh``, plus the PDHG bucket over a mesh: on the
same seeded inputs the port over meshes of 2 and 4 gives the unsharded
port's bits (each lane is masked on its own), and the JAX package's
status, iterations and objectives at the JAX tests' tolerances.
"""

import json

import jax
import numpy as np
import pytest

from distributedlpsolver_tpu.backends import batched as jbatched
from distributedlpsolver_tpu.backends import first_order as jfo
from distributedlpsolver_tpu.ipm.config import SolverConfig as JaxConfig
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.parallel import make_mesh as jmake_mesh
from distributedlpsolver_tpu_torch.backends import batched as tb
from distributedlpsolver_tpu_torch.backends import first_order as tfo
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.ipm import SolverConfig, Status, solve
from distributedlpsolver_tpu_torch.models import generators as tgen
from distributedlpsolver_tpu_torch.models import random_request_stream
from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib
from distributedlpsolver_tpu_torch.serve import BucketSpec, BucketTable, ServiceConfig, SolveService
from distributedlpsolver_tpu_torch.serve.autotune import (
    AutotuneConfig,
    autotune_ladder,
    load_request_shapes,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

WAIT = 300


def _mesh(k: int):
    return mesh_lib.make_mesh((k,), axis_names=("batch",), devices=["cpu"] * k)


def _jmesh(k: int):
    return jmake_mesh((k,), axis_names=("batch",), devices=jax.devices()[:k])


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)) / (1.0 + np.abs(np.asarray(b)))


# -- the mesh ------------------------------------------------------------------


def test_a_local_mesh_names_its_devices_and_blocks():
    m = _mesh(4)
    assert m.is_local and m.size == 4 and m.device_ids == (0, 1, 2, 3)
    assert not mesh_lib.is_multiprocess(m)
    assert [(lo, hi) for _, lo, hi in m.lane_blocks(8)] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError, match="divisible"):
        m.lane_blocks(6)
    assert mesh_lib.batch_sharding(m, 3).dim == 0
    assert m.key != _mesh(2).key


def test_mesh_devices_beyond_the_cards_raise(monkeypatch):
    """On cards a local mesh names distinct cards: more than the process
    has raises with the JAX package's message (the chip machine's one
    card turns ``mesh_devices=2`` into this error, never a fallback)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="mesh_devices=2 but only 1 local devices"):
        mesh_lib.local_devices(2, "cuda")
    assert mesh_lib.local_devices(3, "cpu") == [mesh_lib.torch.device("cpu")] * 3


# -- TestMeshBucketDispatch twins ------------------------------------------------


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_bucket_matches_unsharded_and_the_jax_package(k):
    bt, bj = tgen.random_batched_lp(8, 10, 30, seed=11), jgen.random_batched_lp(8, 10, 30, seed=11)
    active = np.array([True] * 6 + [False] * 2)
    r0 = tb.solve_bucket(bt, active, device="cpu")
    r1 = tb.solve_bucket(bt, active, mesh=_mesh(k))
    rj = jbatched.solve_bucket(bj, active, JaxConfig(), mesh=_jmesh(k))
    for lane in range(6):
        assert r1.status[lane] == r0.status[lane] == Status.OPTIMAL
        assert rj.status[lane].value == "optimal"
    # Each lane is masked on its own: the blocks give the unsharded bits.
    np.testing.assert_array_equal(r1.x, r0.x)
    np.testing.assert_array_equal(r1.iterations, r0.iterations)
    np.testing.assert_array_equal(r1.iterations[:6], rj.iterations[:6])
    np.testing.assert_allclose(r1.x[:6], rj.x[:6], atol=1e-8, rtol=1e-8)
    assert _rel(r1.objective[:6], rj.objective[:6]).max() <= 1e-8
    row = r1.phase_report[0]
    assert row["executors"] == k and row["mesh_devices"] == k
    assert row["bodies"] == max(row["executor_bodies"]) and row["captured"] is False


def test_batch_not_divisible_by_mesh_raises():
    with pytest.raises(ValueError, match="divisible"):
        tb.solve_bucket(tgen.random_batched_lp(6, 8, 24, seed=1), np.ones(6, bool), mesh=_mesh(4))


def test_preplaced_bucket_reuses_program():
    """place_bucket (the pack stage) + solve_bucket land on the program the
    direct call built: one per (bucket, mesh), then flat."""
    mesh = _mesh(2)
    batch, active = tgen.random_batched_lp(8, 8, 24, seed=2), np.ones(8, bool)
    tb.solve_bucket(batch, active, mesh=mesh)
    size0 = tb.bucket_cache_size()
    placed, act = tb.place_bucket(batch, active, mesh=mesh)
    assert isinstance(placed.A, tuple) and len(placed.A) == 2 and placed.A[0].shape[0] == 4
    warm, wm = tb.place_warm(None, None, (8, 8, 24), mesh=mesh)
    r = tb.solve_bucket(placed, act, mesh=mesh, warm=warm, warm_mask=wm)
    assert tb.bucket_cache_size() == size0
    assert r.n_optimal == 8 and r.phase_report[0]["built"] is False
    # The same bucket unsharded is another key: it builds once more.
    tb.solve_bucket(batch, active, device="cpu")
    assert tb.bucket_cache_size() == size0 + 1


def test_bucket_table_enforces_device_divisibility():
    t = BucketTable(batch=6, devices=4)
    assert t.batch == 8 and t.spec_for(8, 24).batch == 8
    with pytest.raises(ValueError, match="divisible"):
        BucketTable([BucketSpec(8, 32, 6)], devices=4)


def test_warm_lanes_over_a_mesh_are_the_unsharded_ones():
    """Warm lanes placed over a mesh reach each block's slots: the same
    per-slot ``warm_used`` and bits as the unsharded warm dispatch."""
    batch, active = tgen.random_batched_lp(4, 8, 24, seed=5), np.ones(4, bool)
    cold = tb.solve_bucket(batch, active, device="cpu")
    prior = tb.IPMState(cold.x, cold.y, cold.s, cold.w, cold.z)
    mask = np.array([True, False, True, True])
    r0 = tb.solve_bucket(batch, active, warm=prior, warm_mask=mask, device="cpu")
    r1 = tb.solve_bucket(batch, active, mesh=_mesh(2), warm=prior, warm_mask=mask)
    np.testing.assert_array_equal(r1.warm_used, r0.warm_used)
    assert r0.warm_used.tolist() == [True, False, True, True]
    np.testing.assert_array_equal(r1.x, r0.x)


# -- test_batched.py::test_batch_sharded_over_mesh twin ---------------------------


def test_batch_sharded_over_mesh():
    b16t, b16j = tgen.random_batched_lp(16, 16, 40, seed=3), jgen.random_batched_lp(16, 16, 40, seed=3)
    r_mesh = tb.solve_batched(b16t, mesh=_mesh(4))
    r_ref = tb.solve_batched(b16t, device="cpu")
    rj = jbatched.solve_batched(b16j, mesh=jmake_mesh(axis_names=("batch",)))
    assert r_mesh.n_optimal == 16 == rj.n_optimal
    np.testing.assert_allclose(r_mesh.objective, r_ref.objective, rtol=1e-9)
    np.testing.assert_allclose(r_mesh.objective, rj.objective, rtol=1e-9)
    np.testing.assert_array_equal(r_mesh.iterations, rj.iterations)
    assert sorted({ph["executor"] for ph in r_mesh.phase_report}) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="divisible"):
        tb.solve_batched(tgen.random_batched_lp(12, 16, 40, seed=3), mesh=_mesh(8))
    with pytest.raises(ValueError, match="chunk 6 not divisible"):
        tb.solve_batched(b16t, mesh=_mesh(4), chunk=6)


# -- the PDHG bucket over a mesh ---------------------------------------------------


@pytest.mark.parametrize("k", [2, 4])
def test_pdhg_bucket_over_a_mesh_keeps_each_lanes_start(k):
    """Each lane keeps its start row ``seeds[k]`` of the WHOLE bucket's
    table (``pdhg_seed(name, B)``), so its answer does not depend on the
    mesh width: the unsharded bits, and the JAX package's statuses,
    iterations and x at its bucket parity tolerance."""
    B = 8
    bt, bj = tgen.random_batched_lp(B, 16, 64, seed=3), jgen.random_batched_lp(B, 16, 64, seed=3)
    active = np.ones(B, dtype=bool)
    active[-1] = False
    seeds = np.array([tfo.pdhg_seed(f"req-{i}", B) for i in range(B - 1)] + [B - 1])
    r0 = tfo.solve_pdhg_bucket(bt, active, SolverConfig(tol=1e-4), device="cpu", seeds=seeds)
    r1 = tfo.solve_pdhg_bucket(bt, active, SolverConfig(tol=1e-4), mesh=_mesh(k), seeds=seeds)
    np.testing.assert_array_equal(r1.x, r0.x)
    np.testing.assert_array_equal(r1.iterations, r0.iterations)
    assert [s.value for s in r1.status] == [s.value for s in r0.status]
    # The JAX engine over its mesh, each slot on its own index.
    rj = jfo.solve_pdhg_bucket(bj, active, JaxConfig(tol=1e-4), mesh=_jmesh(k))
    rs = tfo.solve_pdhg_bucket(bt, active, SolverConfig(tol=1e-4), mesh=_mesh(k))
    assert [s.value for s in rs.status] == [s.value for s in rj.status]
    np.testing.assert_array_equal(rs.iterations, rj.iterations)
    np.testing.assert_allclose(rs.x, rj.x, rtol=0, atol=1e-8)
    size = tb.bucket_cache_size()
    tfo.solve_pdhg_bucket(bt, active, SolverConfig(tol=1e-4), mesh=_mesh(k), seeds=seeds)
    assert tb.bucket_cache_size() == size


# -- the service over a mesh (TestServiceIntegration twins) -----------------------


def test_mesh_dispatch_autotune_swap_zero_warm_recompiles_200(tmp_path):
    """``bucket_cache_size()`` stays flat across a warm 200-request run
    under mesh dispatch on a post-autotune ladder, and the answers match
    the one-device solo solves at 1e-8."""
    log = tmp_path / "svc.jsonl"
    cfg = ServiceConfig(batch=8, flush_s=0.02, mesh_devices=2, log_jsonl=str(log))
    with SolveService(cfg, device="cpu") as svc:
        assert svc.mesh_devices == 2
        cold = [svc.submit(p) for p in random_request_stream(48, seed=31)]
        assert svc.drain(timeout=WAIT)
        assert all(f.result(timeout=30).status is Status.OPTIMAL for f in cold)
        specs, report = autotune_ladder(
            load_request_shapes(str(log)), current=list(svc.scheduler.table.specs()),
            config=AutotuneConfig(devices=2, batch=8))
        assert report["mean_shape_waste_after"] <= report["mean_shape_waste_before"]
        assert svc.apply_ladder(specs) == len(specs)
        cache0 = tb.bucket_cache_size()
        problems = list(random_request_stream(200, seed=32))
        futs = [svc.submit(p) for p in problems]
        assert svc.drain(timeout=WAIT)
        rs = [f.result(timeout=30) for f in futs]
        assert tb.bucket_cache_size() == cache0
        assert all(r.status is Status.OPTIMAL for r in rs)
        assert all(r.compile_ms == 0.0 for r in rs) and all(r.bucket is not None for r in rs)
        for p, r in list(zip(problems, rs))[:8]:
            ref = solve(p, backend=get_backend("cuda", device="cpu"))
            assert ref.status == Status.OPTIMAL
            assert _rel(r.objective, ref.objective) <= 1e-8
        rows = svc.dispatch_report()
        assert rows and all(row["mesh_devices"] == 2 for row in rows)
        events = [json.loads(ln) for ln in log.read_text().splitlines()]
        assert any(e["event"] == "ladder_swap" for e in events)
        assert any(e["event"] == "warmup" for e in events)


def test_reshard_mid_service_keeps_serving(tmp_path):
    """Losing a mesh device re-forms the batch mesh over the survivors,
    clamped to the gcd of the bucket batches (4 → 3 survivors → 2); the
    re-formed mesh builds once per bucket, then stays warm."""
    log = tmp_path / "svc.jsonl"
    with SolveService(ServiceConfig(batch=8, flush_s=0.02, mesh_devices=4, log_jsonl=str(log)),
                      device="cpu") as svc:
        futs = [svc.submit(p) for p in random_request_stream(16, seed=41)]
        assert svc.drain(timeout=WAIT)
        assert all(f.result(timeout=30).status is Status.OPTIMAL for f in futs)
        assert svc.reshard(exclude=[3]) == 2
        assert svc.mesh_devices == 2
        futs = [svc.submit(p) for p in random_request_stream(16, seed=42)]
        assert svc.drain(timeout=WAIT)
        assert all(f.result(timeout=30).status is Status.OPTIMAL for f in futs)
        cache0 = tb.bucket_cache_size()
        futs = [svc.submit(p) for p in random_request_stream(8, seed=43)]
        assert svc.drain(timeout=WAIT)
        assert all(f.result(timeout=30).status is Status.OPTIMAL for f in futs)
        assert tb.bucket_cache_size() == cache0
        assert svc.stats()["mesh_devices"] == 2
    events = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert [e["devices"] for e in events if e["event"] == "reshard"] == [2]


def test_reshard_without_a_mesh_and_in_slice_mode():
    with SolveService(ServiceConfig(batch=4), device="cpu", auto_start=False) as svc:
        assert svc.mesh_devices == 1 and svc.reshard(exclude=[0]) == 1

    class _Runner:
        mesh = _mesh(2)

    svc = SolveService(ServiceConfig(batch=4), slice_runner=_Runner(), auto_start=False)
    assert svc.config.solo_backend == "dense" and svc.mesh_devices == 2
    with pytest.raises(RuntimeError, match="slice mode"):
        svc.reshard(exclude=[1])
    svc.shutdown()
