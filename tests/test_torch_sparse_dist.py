"""The port's row-sharded matrix-free tier against the JAX package's, on the
CPU: the twin of the JAX package's ``tests/test_sparse_dist.py``.

The JAX package shards the rows over a mesh of the harness's virtual
devices; the port over a local mesh that names the CPU device K times
(``parallel.mesh.make_mesh(devices=["cpu"] * K)``), each member a row
block of its own, the vectors replicated. The reference's shapes:
``STORM_S`` on a mesh of 4 and ``STORM_M`` on a mesh of 2. Held: the JAX
mesh solve's status and IPM iterations, its objective within 1e-8
relative, x within 1e-8·(1 + max|x|) of the port's own single-device
solve, the shard count, the per-device ≈1/N memory guard, ``reshard``,
the refusal of ILDL on a mesh, the warm preconditioner across a width
change and the offer's shape guard; and the operator's products against
the JAX ``RowShardedOperator``'s at seeded vectors (≤ 1e-12). The world
of processes (gloo) is in ``test_torch_multihost.py`` and
``test_torch_shrink.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from distributedlpsolver_tpu.backends.sparse_iterative import SparseIterativeBackend as JB
from distributedlpsolver_tpu.ipm import driver as jdriver
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.ops import sparse as jsparse
from distributedlpsolver_tpu.parallel import mesh as jmesh_lib
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.backends.sparse_iterative import SparseIterativeBackend
from distributedlpsolver_tpu_torch.ipm import solve
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.models import generators as tgen
from distributedlpsolver_tpu_torch.models.problem import to_interior_form
from distributedlpsolver_tpu_torch.ops import sparse as tsparse
from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"
# The reference's instances: (scenarios, block_m, block_n, first_stage_n, seed).
STORM_S = (6, 24, 36, 24, 3)
STORM_M = (12, 24, 32, 16, 10)
# The operator's products against the JAX package's (both in f64 on the CPU).
OP_TOL = 1e-12


def _mesh(width):
    return mesh_lib.make_mesh(axis_names=("batch",), devices=[CPU] * width)


def _jmesh(width):
    return jmesh_lib.make_mesh((width,), axis_names=("batch",), devices=jax.devices()[:width])


def _storm(spec):
    k, mb, nb, fs, seed = spec
    return tgen.storm_sparse_lp(k, mb, nb, fs, seed=seed)


@functools.lru_cache(maxsize=None)
def _jax_mesh_solve(spec, width):
    """The JAX package's row-sharded solve, shared by the tests (each JAX
    mesh program compiles for ~10 s)."""
    k, mb, nb, fs, seed = spec
    jb = JB(mesh=_jmesh(width))
    r = jdriver.solve(jgen.storm_sparse_lp(k, mb, nb, fs, seed=seed), backend=jb, tol=1e-8)
    return r, jb.cg_report()


@functools.lru_cache(maxsize=None)
def _single(spec):
    """The port's own single-device solve."""
    be = SparseIterativeBackend(device=CPU)
    r = solve(_storm(spec), backend=be, tol=1e-8)
    assert r.status.value == "optimal"
    return r


def _close(a, b, tol=1e-8):
    return abs(a - b) <= tol * (1 + abs(b))


# -- the sharded solve ---------------------------------------------------------


@pytest.mark.parametrize("spec,width", [(STORM_S, 4), (STORM_M, 2)],
                         ids=["storm_s-4way", "storm_m-2way"])
def test_matches_the_jax_mesh_solve_and_the_single_device_one(spec, width):
    rj, jrep = _jax_mesh_solve(spec, width)
    be = SparseIterativeBackend(mesh=_mesh(width))
    r = solve(_storm(spec), backend=be, tol=1e-8)
    assert r.status.value == rj.status.value == "optimal"
    assert r.iterations == rj.iterations
    assert _close(r.objective, rj.objective)
    ref = _single(spec)
    x_ref = np.asarray(ref.x)
    assert np.max(np.abs(np.asarray(r.x) - x_ref)) <= 1e-8 * (1 + np.max(np.abs(x_ref)))
    rep = be.cg_report()
    assert rep["shards"] == jrep["shards"] == width
    assert rep["psum_per_iter"] == jrep["psum_per_iter"] == 1
    assert rep["precond"] == jrep["precond"] == "bordered"


@pytest.mark.parametrize("precond", ["auto", "jacobi"])
def test_a_mesh_of_one_gives_the_single_device_bits(precond):
    """R = 1: the block is A, the collectives are the identity, and the
    normal matvec runs the single-device operator's order — x bit for bit
    (a process-group mesh with no process group, and a local mesh)."""
    p = _storm(STORM_S)
    be0 = SparseIterativeBackend(precond=precond, device=CPU)
    r0 = solve(p, backend=be0, tol=1e-8)
    for mesh in (mesh_lib.make_mesh(axis_names=("batch",), device=CPU), _mesh(1)):
        be = SparseIterativeBackend(precond=precond, mesh=mesh)
        r = solve(_storm(STORM_S), backend=be, tol=1e-8)
        assert np.array_equal(r.x, r0.x) and r.iterations == r0.iterations
        assert be.cg_report()["cg_iters"] == be0.cg_report()["cg_iters"]
        assert be.cg_report()["shards"] == 1 and be.cg_report()["psum_per_iter"] == 0


def test_per_shard_memory_fraction_no_adat():
    """Each device holds ≈1/N of the operator, and no operand anywhere
    approaches the (m, m) normal matrix (the reference's guard; Jacobi
    pins the comparison to the operator)."""
    width = 4
    inf = to_interior_form(_storm(STORM_M))
    cfg = SolverConfig(tol=1e-8)
    be1 = SparseIterativeBackend(precond="jacobi", device=CPU)
    be1.setup(inf, cfg)
    beN = SparseIterativeBackend(precond="jacobi", mesh=_mesh(width))
    beN.setup(to_interior_form(_storm(STORM_M)), cfg)
    whole = be1.max_operand_nbytes()
    per_dev = beN.max_operand_nbytes(per_device=True)
    assert per_dev <= (whole / width) * 1.6, (per_dev, whole)
    m = int(inf.A.shape[0])
    for name, info in beN.memory_report().items():
        assert info.get("nbytes_per_device", info["nbytes"]) < 0.2 * m * m * 8, (name, info)
        shp = info["shape"]
        assert not (len(shp) >= 2 and min(shp[-2:]) >= m), (name, info)
    # A local mesh holds every member's block: its bytes are their sum.
    assert beN._op.nbytes() == sum(b.nbytes() for b in beN._op.blocks)


def test_reshard_returns_fresh_backend_that_solves_on_the_new_width():
    be = SparseIterativeBackend(mesh=_mesh(2))
    be2 = be.reshard(_mesh(4))
    assert be2 is not be and isinstance(be2, SparseIterativeBackend)
    assert be2._precond_req == "auto" and be2.mesh.size == 4
    r = solve(_storm(STORM_S), backend=be2, tol=1e-8)
    assert r.status.value == "optimal" and be2.cg_report()["shards"] == 4
    assert _close(r.objective, _single(STORM_S).objective)


def test_auto_reshard_reaches_the_row_sharded_backend():
    """``AutoBackend.reshard`` forwards to the backend it chose; a
    row-sharded inner hands back its own fresh instance on the new mesh."""
    be = get_backend("auto", device=CPU)
    assert be.reshard(_mesh(2)) is None  # nothing chosen yet
    be._inner = SparseIterativeBackend(precond="bordered", mesh=_mesh(2))
    assert be.mesh is be._inner.mesh
    new = be.reshard(_mesh(3))
    assert isinstance(new, SparseIterativeBackend) and new.mesh.size == 3
    assert new._precond_req == "bordered"


def test_sharded_rejects_explicit_ildl():
    be = SparseIterativeBackend(precond="ildl", mesh=_mesh(2))
    with pytest.raises(ValueError, match="row-sharded"):
        be.setup(to_interior_form(_storm(STORM_S)), SolverConfig())


def test_ildl_escalation_is_not_armed_on_a_mesh():
    """The escalation rung is the single-device tier's: an unstructured
    auto-routed pattern on a mesh keeps Jacobi."""
    inf = to_interior_form(tgen.netlib_sparse_lp(60, 110, seed=10))
    be = SparseIterativeBackend(mesh=_mesh(2))
    be.setup(inf, SolverConfig(tol=1e-8))
    assert be.precond == "jacobi" and be._A_csr is None
    be0 = SparseIterativeBackend(device=CPU)
    be0.setup(to_interior_form(tgen.netlib_sparse_lp(60, 110, seed=10)), SolverConfig(tol=1e-8))
    assert be0._A_csr is not None


def test_warm_precond_survives_mesh_width_change():
    """A warm entry written on a mesh of 2 seeds a single-device backend:
    the export is host numpy and the factors rebuild on the offeree."""
    from distributedlpsolver_tpu_torch.serve.warmcache import WarmCache

    cache = WarmCache(8)
    be_cold = SparseIterativeBackend(mesh=_mesh(2))
    r_cold = solve(_storm(STORM_M), backend=be_cold, tol=1e-8, warm_cache=cache)
    assert r_cold.status.value == "optimal"
    assert be_cold.cg_report()["warm_precond_steps"] == 0
    exported = be_cold.export_precond()
    assert isinstance(exported["d"], np.ndarray) and exported["d"].dtype == np.float64
    assert exported["precond"] == be_cold.precond
    p2 = _storm(STORM_M)
    p2.c = p2.c * 1.01
    be_warm = SparseIterativeBackend(device=CPU)
    r_warm = solve(p2, backend=be_warm, tol=1e-8, warm_cache=cache)
    assert r_warm.status.value == "optimal"
    assert be_warm.cg_report()["warm_precond_steps"] > 0


def test_offer_accepts_dict_and_bare_array_and_guards_the_shape():
    inf = to_interior_form(_storm(STORM_S))
    be = SparseIterativeBackend(mesh=_mesh(2))
    assert not be.offer_precond(np.ones(inf.n))  # before setup
    be.setup(inf, SolverConfig(tol=1e-8))
    assert be.offer_precond(np.ones(inf.n))
    assert be.offer_precond({"d": np.ones(inf.n), "precond": "bordered"})
    assert not be.offer_precond({"precond": "bordered"})
    assert not be.offer_precond({"d": np.ones(inf.n + 1)})
    assert not be.offer_precond(-np.ones(inf.n))


# -- the operator ----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _operators(spec, width):
    """The port's and the JAX package's row-sharded operators of the same
    matrix, and seeded vectors."""
    A = to_interior_form(_storm(spec)).A
    op = tsparse.shard_rows(A, _mesh(width))
    jop = jsparse.shard_rows(A, _jmesh(width))
    rng = np.random.default_rng(5)
    m, n = A.shape
    vecs = {"v": rng.standard_normal(n), "y": rng.standard_normal(m),
            "d": rng.random(n) + 0.1, "w": rng.standard_normal(m)}
    return A, op, jop, vecs


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("spec,width", [(STORM_S, 4), (STORM_M, 2), (STORM_S, 5)],
                         ids=["storm_s-4way", "storm_m-2way", "storm_s-5way"])
@pytest.mark.parametrize("what", ["matvec", "rmatvec", "normal_matvec", "normal_diag", "to_scipy"])
def test_operator_matches_the_jax_row_sharded_operator(spec, width, what):
    A, op, jop, vec = _operators(spec, width)
    jv = {k: jnp.asarray(v) for k, v in vec.items()}
    reg = 1e-8
    if what == "matvec":
        got, want = op.matvec(_t(vec["v"])), jop.matvec(jv["v"])
    elif what == "rmatvec":
        got, want = op.rmatvec(_t(vec["y"])), jop.rmatvec(jv["y"])
    elif what == "normal_matvec":
        got = op.normal_matvec(_t(vec["d"]), reg, _t(vec["w"]))
        want = jop.extract(jop.normal_matvec(jv["d"], reg, jop.embed(jv["w"])))
    elif what == "normal_diag":
        got, want = op.normal_diag(_t(vec["d"]), reg), jop.extract(jop.normal_diag(jv["d"], reg))
    else:
        diff = abs(op.to_scipy() - jop.to_scipy()).max()
        assert diff == 0.0 and (op.to_scipy() != sp.csr_matrix(A)).nnz == 0
        return
    assert got.shape == tuple(want.shape)
    assert _rel(got.numpy(), np.asarray(want)) <= OP_TOL


def test_row_blocks_split_as_the_reference():
    """⌈m/R⌉ rows a member, contiguous, the last block shorter; each block
    holds its rows with global columns; fewer rows than members raises."""
    A, op, jop, _ = _operators(STORM_S, 5)
    m = A.shape[0]
    assert op.rows_per == jop.rows_per == -(-m // 5) and m % 5
    assert op.ranges[0] == (0, op.rows_per) and op.ranges[-1][1] == m
    assert all(b.shape == (hi - lo, A.shape[1]) for b, (lo, hi) in zip(op.blocks, op.ranges))
    uneven = tsparse.shard_rows(sp.random(10, 40, density=0.3, random_state=0, format="csr"),
                                _mesh(4))
    assert uneven.ranges == ((0, 3), (3, 6), (6, 9), (9, 10))
    with pytest.raises(ValueError, match="cannot shard 3 rows over 4"):
        tsparse.shard_rows(sp.eye(3, format="csr"), _mesh(4))
    with pytest.raises(ValueError, match="cannot shard"):
        jsparse.shard_rows(sp.eye(3, format="csr"), _jmesh(4))
