"""The sharded backend's PCG (``solve_mode="pcg"`` and the automatic PCG
plan of ``schedule_platform="tpu"``) against the JAX package's, on the CPU.

The JAX side runs ``ShardedJaxBackend`` (its ``_pcg_ops(prec_shard=…)``:
``L⁻¹`` column-split by ``chol_tri_inv_mesh``) on meshes of the
conftest's 8 virtual devices; the port's runs on local meshes that name
the CPU K times (every member's column block and ``L⁻¹`` slab in this
process, ``backends/sharded.py``). Held:

* the PCG ``LinOps`` on meshes of 1, 2, 4 and 8 on a padded, uneven n,
  against the JAX ``_make_ops(prec_shard=P(None, "cols"))`` at seeded
  vectors: ``L⁻¹`` gathered from the slabs within 5e-6 max-relative (the
  reference's own f32 tolerance), s and diag(M) within 1e-6, one Newton
  solve within 1e-8;
* the reference's mesh instances on the fused loop, the host loop and
  ``segment_iters=2`` (the closure's route) against its mesh of 8: status
  and iterations equal, objectives within 1e-8;
* under ``schedule_platform="tpu"`` the three-phase PCG plan, forced, on
  the reference's own instances: the same (mode, iterations) a phase, and
  the automatic plan the forced plan's x bit for bit;
* the primal-row closure: ``_ensure_closure`` over the split A against the
  dense factor of the whole A, and the projection against the dense one;
* the sums a factorization and a CG iteration, counted through
  ``Mesh.all_reduce``, a member's slab size, and ``reshard`` (also the
  supervisor's SHRINK rung) of a PCG solve.

The gloo worlds of 2 and 4 are ``tests/test_torch_sharded.py``'s.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from distributedlpsolver_tpu.backends import dense as jdense
from distributedlpsolver_tpu.backends.sharded import ShardedJaxBackend
from distributedlpsolver_tpu.ipm import solve as jax_solve
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.parallel import make_mesh as jmake_mesh
from distributedlpsolver_tpu_torch.backends import dense as tdense
from distributedlpsolver_tpu_torch.backends.sharded import ShardedTorchBackend
from distributedlpsolver_tpu_torch.ipm import SolverConfig, Status, solve
from distributedlpsolver_tpu_torch.models import generators as tgen
from distributedlpsolver_tpu_torch.models import to_interior_form
from distributedlpsolver_tpu_torch.ops import dist_chol
from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib
from distributedlpsolver_tpu_torch.supervisor import supervisor as sup_mod
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"
TOL = 1e-8
OBJ_TOL = 1e-8
# The reference's mesh instances (tests/test_dist_chol.py,
# tests/test_pcg.py) and its loops.
INSTANCES = [(48, 120, 11), (48, 128, 4), (64, 160, 9)]
LOOPS = {"fused": {}, "host": {"fused_loop": False}, "segmented": {"segment_iters": 2}}
# Its three-phase PCG plans under the TPU schedule (tests/test_pcg.py).
TPU_CASES = {"pcg": ((40, 100, 1), {}), "pcg_seg2": ((40, 100, 2), {"segment_iters": 2})}
# The LinOps instance: m = 30 pads L⁻¹'s slabs on meshes of 4 and 8,
# n = 77 pads the columns on every mesh but one.
OPS_M, OPS_N = 30, 77


def _mesh(k):
    return mesh_lib.make_mesh(axis_names=("cols",), devices=[CPU] * k)


def _jmesh(k):
    return jmake_mesh(devices=jax.devices()[:k])


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _close(a, b, tol=OBJ_TOL):
    return abs(a - b) <= tol * (1.0 + abs(b))


@functools.lru_cache(maxsize=None)
def _jax_solve(inst, loop, k=8):
    m, n, seed = inst
    be = ShardedJaxBackend(mesh=_jmesh(k))
    r = jax_solve(jgen.random_dense_lp(m, n, seed=seed), backend=be, tol=TOL, solve_mode="pcg",
                  **LOOPS[loop])
    assert be._prec_shard is not None
    return r


def _port_solve(inst, mesh, **kw):
    m, n, seed = inst
    be = ShardedTorchBackend(mesh=mesh, schedule_platform=kw.pop("schedule_platform", None))
    return solve(tgen.random_dense_lp(m, n, seed=seed), backend=be, tol=TOL, **kw), be


def _ops_backend(k, **cfg):
    be = ShardedTorchBackend(mesh=_mesh(k))
    be.setup(to_interior_form(tgen.random_dense_lp(OPS_M, OPS_N, seed=2)),
             SolverConfig(solve_mode="pcg", **cfg))
    return be


def _whole(be, dtype=torch.float64):
    """The padded A of a local-mesh backend, its blocks put together."""
    return torch.cat([A_k for _, _, A_k in be._blocks_as(dtype)], dim=1)


def _gather(inv):
    """``L⁻¹`` (m×m) from a local mesh's slabs."""
    return torch.cat(inv.slabs, dim=1)[: inv.m, : inv.m]


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_pcg_linops_match_the_jax_prec_shard_ops(k):
    be = _ops_backend(k)
    m, n = be._shape
    assert n % k == 0 and (n > OPS_N) == (OPS_N % k != 0)
    assert be.prec_sharding().axis == "cols" and be.prec_sharding().dim == 1
    rng = np.random.default_rng(7)
    d, rhs = rng.uniform(0.5, 2.0, n), rng.standard_normal(m)
    v, y = rng.standard_normal(n), rng.standard_normal(m)
    reg, cg_tol, cg_iters = 1e-8, 1e-11, 100
    spec = be._point_spec()._replace(cg_tol=cg_tol, cg_iters=cg_iters)
    ops = be._make_linops(reg, spec)
    factors = ops.factorize(torch.from_numpy(d))
    inv, s, diagM = factors[:3]
    x = ops.solve(factors, torch.from_numpy(rhs))

    A = _whole(be).numpy()
    shard = NamedSharding(_jmesh(k), PartitionSpec(None, "cols"))
    Aj = jax.device_put(jnp.asarray(A), shard)
    jops = jdense._make_ops(Aj, reg, jnp.float32, 0, Af=Aj.astype(jnp.float32),
                            cg_iters=cg_iters, cg_tol=cg_tol, prec_shard=shard)
    # Under jit, as the reference's step runs it (m need not divide the
    # mesh inside a program).
    jfactors = jax.jit(jops.factorize)(jnp.asarray(d))
    Linv_j, s_j, diagM_j = (np.asarray(a) for a in jfactors[:3])
    xj = np.asarray(jops.solve(jfactors, jnp.asarray(rhs)))

    assert all(S.dtype == torch.float64 for S in inv.slabs)
    assert _rel(_gather(inv), Linv_j) <= 5e-6
    assert _rel(s, s_j) <= 1e-6 and _rel(diagM, diagM_j) <= 1e-6
    assert _rel(x, xj) <= 1e-8
    assert _rel(ops.matvec(torch.from_numpy(v)), np.asarray(jops.matvec(jnp.asarray(v)))) <= 1e-12
    assert _rel(ops.rmatvec(torch.from_numpy(y)),
                np.asarray(jops.rmatvec(jnp.asarray(y)))) <= 1e-12
    # The solve meets the true regularized normal equations.
    M = A @ (d[:, None] * A.T)
    Mreg = M + reg * np.diag(np.diag(M))
    assert np.linalg.norm(Mreg @ x.numpy() - rhs) <= 1e-9 * np.linalg.norm(rhs)


@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("inst", INSTANCES, ids=lambda i: f"{i[0]}x{i[1]}s{i[2]}")
def test_reference_mesh_instances_match_the_jax_mesh_solve(inst, loop):
    rj = _jax_solve(inst, loop)
    rt, be = _port_solve(inst, _mesh(8), solve_mode="pcg", **LOOPS[loop])
    assert rt.status == Status.OPTIMAL and rj.status.value == "optimal"
    assert rt.iterations == rj.iterations
    assert _close(rt.objective, rj.objective)
    assert be._pcg and (be._closure is not None) == (loop == "segmented")
    rep = be.cg_report()
    assert rep["solves"] > 0 and rep["cg_live"] > 0
    if loop != "host":
        assert [ph["mode"] for ph in be.phase_report] == ["pcg"]


@functools.lru_cache(maxsize=None)
def _jax_tpu_solve(name):
    (m, n, seed), kw = TPU_CASES[name]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        be = ShardedJaxBackend(mesh=_jmesh(8))
        r = jax_solve(jgen.random_dense_lp(m, n, seed=seed), backend=be, tol=TOL,
                      solve_mode="pcg", use_pallas=False, **kw)
    return r, [(ph["mode"], ph["iters"]) for ph in be.phase_report]


@pytest.mark.parametrize("name", list(TPU_CASES))
def test_tpu_schedule_pcg_plan_matches_the_jax_mesh_solve(name, monkeypatch):
    rj, phases_j = _jax_tpu_solve(name)
    inst, kw = TPU_CASES[name]
    rt, bt = _port_solve(inst, _mesh(8), schedule_platform="tpu", solve_mode="pcg", **kw)
    assert bt._two_phase and bt._pcg
    assert rt.status == Status.OPTIMAL and rj.status.value == "optimal"
    assert [(ph["mode"], ph["iters"]) for ph in bt.phase_report] == phases_j
    assert [mode for mode, _ in phases_j] == ["f32", "pcg", "f64"]
    assert rt.iterations == rj.iterations and _close(rt.objective, rj.objective)
    # The automatic plan (m·n past the threshold, patched down) is the
    # forced one, bit for bit.
    monkeypatch.setattr(tdense, "_PCG_AUTO_ENTRIES", 1)
    ra, ba = _port_solve(inst, _mesh(8), schedule_platform="tpu", **kw)
    assert ba._pcg and ba.phase_report[1]["mode"] == "pcg"
    assert np.array_equal(ra.x, rt.x) and ra.iterations == rt.iterations


@pytest.mark.parametrize("k", [2, 4])
def test_the_closure_factors_the_whole_split_a(k):
    """G summed over the blocks is the whole A's Gram matrix: the factor
    within f32 rounding of the dense backend's on the whole A, and the
    projection over the mesh within 1e-12 of the dense one given the same
    factor."""
    be = _ops_backend(k)
    LinvG, sG = be._ensure_closure()
    A = _whole(be)
    Linv_d, s_d = tdense._closure_factors(A.to(torch.float32))
    assert LinvG.shape == (OPS_M, OPS_M) and LinvG.dtype == torch.float32
    assert _rel(LinvG, Linv_d) <= 1e-5 and _rel(sG, s_d) <= 1e-5
    spec = be._point_spec()._replace(closure=(LinvG, sG), closure_sweeps=2)
    project = be._make_linops(1e-8, spec).primal_project
    rv = torch.from_numpy(np.random.default_rng(5).standard_normal(OPS_M))
    want = tdense._closure_project(A, (LinvG, sG), 2)(rv)
    got = project(rv)
    assert _rel(got, want) <= 1e-12
    assert torch.linalg.vector_norm(A @ got - rv) <= 1e-10 * torch.linalg.vector_norm(rv)


@pytest.fixture
def all_reduces(monkeypatch):
    """Counts ``Mesh.all_reduce`` calls (every sum goes through one)."""
    calls = [0]
    real = mesh_lib.Mesh.all_reduce

    def counted(self, t, axis=None):
        calls[0] += 1
        return real(self, t, axis)

    monkeypatch.setattr(mesh_lib.Mesh, "all_reduce", counted)
    return calls


@pytest.mark.parametrize("k", [1, 4])
def test_sums_a_factorization_and_a_cg_iteration(k, all_reduces):
    """1 + 2·P sums a factorization (M, then two a panel); 4 a CG
    iteration (the operator's two, the slabs' two), 2 more for the
    preconditioned right-hand side. A member's slab holds mp·w entries."""
    be = _ops_backend(k)
    m, n = be._shape
    pb, w, mp, P = dist_chol.slab_plan(m, k, 256)
    ops = be._make_linops(1e-8, be._point_spec())
    rng = np.random.default_rng(3)
    all_reduces[0] = 0
    factors = ops.factorize(torch.from_numpy(rng.uniform(0.5, 2.0, n)))
    assert all_reduces[0] == 1 + 2 * P
    inv = factors[0]
    assert len(inv.slabs) == k and all(S.shape == (mp, w) for S in inv.slabs)
    assert inv.cols == tuple(i * w for i in range(k))
    if k > 1:
        assert sum(S.numel() for S in inv.slabs) // k == mp * w < m * m
    all_reduces[0] = 0
    before = be.cg_report()
    ops.solve(factors, torch.from_numpy(rng.standard_normal(m)))
    after = be.cg_report()
    iters = (after["cg_live"] + after["cg_masked"]) - (before["cg_live"] + before["cg_masked"])
    assert after["solves"] - before["solves"] == 1 and iters > 0
    assert all_reduces[0] == 2 + 4 * iters


def test_a_failed_panel_factor_is_nan_on_every_member():
    be = _ops_backend(4)
    m, n = be._shape
    factors = be._make_linops(-2.0, be._point_spec()).factorize(torch.ones(n, dtype=torch.float64))
    assert all(torch.isnan(S).any() for S in factors[0].slabs)


def test_reshard_of_a_pcg_solve(monkeypatch):
    """``reshard`` onto the same members gives the original bits; the
    SHRINK rung resumes a PCG solve (``solve_mode`` rides the config) on
    the re-formed mesh of 3 and converges to the fault-free objective."""
    inst = INSTANCES[0]
    r, be = _port_solve(inst, _mesh(4), solve_mode="pcg")
    fresh = be.reshard(_mesh(4))
    r2 = solve(tgen.random_dense_lp(*inst[:2], seed=inst[2]), backend=fresh, tol=TOL,
               solve_mode="pcg")
    assert fresh is not be and np.array_equal(r2.x, r.x)

    made = []
    real = ShardedTorchBackend.reshard
    monkeypatch.setattr(ShardedTorchBackend, "reshard",
                        lambda self, mesh: made.append(real(self, mesh)) or made[-1])
    plan = [sup_mod.InjectedFault(sup_mod.FaultKind.DEVICE_LOST, iteration=3, device_ids=[3])]
    rs = sup_mod.supervised_solve(
        tgen.random_dense_lp(*inst[:2], seed=inst[2]),
        backend=ShardedTorchBackend(mesh=_mesh(4)),
        supervisor=sup_mod.SupervisorConfig(fault_plan=plan, backoff_base=0.0),
        tol=TOL, solve_mode="pcg")
    assert [f.action for f in rs.faults] == ["shrink:4->3"]
    assert rs.status == Status.OPTIMAL and _close(rs.objective, r.objective)
    new, = made
    assert new.mesh.size == 3 and new._pcg and new.cg_report()["solves"] > 0
    assert len(new._blocks_as(torch.float64)) == 3
