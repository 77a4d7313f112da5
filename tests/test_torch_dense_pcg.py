"""The dense backend's forced-PCG schedule (``solve_mode="pcg"``) against
the JAX package's, on the CPU.

The same seeded inputs go through both packages:

* ``core.pcg_solve`` on an SPD operator whose scaling spans 8 orders: x
  within 1e-10 relative; NaN for a NaN preconditioner and for a capped
  solve that missed the 1e-3 line, in both;
* ``_pcg_ops`` factorize + solve against the reference's plain-assembly
  ``_pcg_ops``: x within 1e-9 relative and a true f64 residual ≤ 1e-10;
* the primal-row closure: the f32 ``L⁻¹`` within 1e-5 relative and the
  projection within 1e-10;
* whole solves of three small instances on the fused loop, the host loop
  and ``segment_iters=2`` (the only route that takes the closure, as in
  the reference): the JAX package's status and iterations, objectives
  within 1e-8 of its and within 1e-6 of HiGHS, and the fused and host
  loops within 1e-12 of each other where the reference's agree.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributedlpsolver_tpu.backends import dense as jdense
from distributedlpsolver_tpu.ipm import core as jcore
from distributedlpsolver_tpu.ipm import solve as jax_solve
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.backends import dense as tdense
from distributedlpsolver_tpu_torch.ipm import Status, solve
from distributedlpsolver_tpu_torch.ipm import core as tcore
from distributedlpsolver_tpu_torch.models import generators as tgen

from tests.oracle import highs_on_general
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _system(m=30, n=90, spread=8.0, seed=0):
    """A, d (log-uniform over ``spread`` orders) and a right-hand side."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    d = 10.0 ** rng.uniform(-spread / 2, spread / 2, n)
    return A, d, rng.standard_normal(m)


def _both_pcg(A, d, rhs, prec_np, tol, max_iter):
    """``pcg_solve`` in both packages on ``M = A·diag(d)·Aᵀ`` with the
    preconditioner matrix ``prec_np`` (a numpy array, shared)."""
    At, dt, Pt = (torch.from_numpy(v) for v in (A, d, prec_np))
    Aj, dj, Pj = (jnp.asarray(v) for v in (A, d, prec_np))
    xt = tcore.pcg_solve(lambda v: At @ (dt * (At.T @ v)), lambda r: Pt @ r,
                         torch.from_numpy(rhs), tol, max_iter)
    xj = jcore.pcg_solve(lambda v: Aj @ (dj * (Aj.T @ v)), lambda r: Pj @ r,
                         jnp.asarray(rhs), tol, max_iter)
    return xt.numpy(), np.asarray(xj)


def _f32_inverse(M):
    """(M in f32)⁻¹ cast up: the kind of preconditioner the PCG mode uses."""
    return np.linalg.inv(M.astype(np.float32)).astype(np.float64)


def test_pcg_solve_matches_the_reference():
    A, d, rhs = _system()
    M = A @ (d[:, None] * A.T)
    xt, xj = _both_pcg(A, d, rhs, _f32_inverse(M), 1e-11, 100)
    assert np.isfinite(xt).all()
    assert _rel(xt, xj) <= 1e-10
    assert np.linalg.norm(M @ xt - rhs) <= 1e-10 * np.linalg.norm(rhs)


def test_pcg_solve_reports_failures_as_nan():
    A, d, rhs = _system(seed=1)
    nan_prec = np.full((A.shape[0],) * 2, np.nan)
    for x in _both_pcg(A, d, rhs, nan_prec, 1e-11, 50):
        assert np.isnan(x).all()
    # Two unpreconditioned iterations at a 8-order spread leave the
    # residual far above the 1e-3 line: a failed solve, not an approximate one.
    for x in _both_pcg(A, d, rhs, np.eye(A.shape[0]), 1e-11, 2):
        assert np.isnan(x).all()
    # The same cap with the line met is an approximate answer, not NaN.
    M = A @ (d[:, None] * A.T)
    xt, xj = _both_pcg(A, d, rhs, _f32_inverse(M), 1e-2, 2)
    assert np.isfinite(xt).all() and _rel(xt, xj) <= 1e-10


def test_pcg_solve_counts_live_and_masked_iterations():
    A, d, rhs = _system(seed=2)
    At, dt = torch.from_numpy(A), torch.from_numpy(d)
    P = torch.from_numpy(_f32_inverse(A @ (d[:, None] * A.T)))
    counts = torch.zeros(3, dtype=torch.int64)
    op = lambda v: At @ (dt * (At.T @ v))
    x1 = tcore.pcg_solve(op, lambda r: P @ r, torch.from_numpy(rhs), 1e-11, 100, counts)
    solves, live, masked = counts.tolist()
    assert solves == 1 and 0 < live < 100 and masked == 0  # the CPU reads the exit each iteration
    # A capped run of exactly the live count gives the same bits.
    x2 = tcore.pcg_solve(op, lambda r: P @ r, torch.from_numpy(rhs), 1e-11, live)
    assert torch.equal(x1, x2)


@pytest.mark.parametrize("spread", [4.0, 8.0])
def test_pcg_ops_match_the_reference(spread):
    A, d, rhs = _system(m=40, n=120, spread=spread, seed=3)
    reg = 1e-8
    At, dt = torch.from_numpy(A), torch.from_numpy(d)
    fac_t, solve_t = tdense._pcg_ops(At, At.to(torch.float32), 1e-11, 100)
    Aj = jnp.asarray(A)
    fac_j, solve_j = jdense._pcg_ops(Aj, jnp.float32, False, Aj.astype(jnp.float32), 1e-11, 100)
    xt = solve_t(fac_t(dt, reg), torch.from_numpy(rhs)).numpy()
    xj = np.asarray(solve_j(fac_j(jnp.asarray(d), reg), jnp.asarray(rhs)))
    assert _rel(xt, xj) <= 1e-9
    M = A @ (d[:, None] * A.T)
    Mreg = M + reg * np.diag(np.diag(M))
    assert np.linalg.norm(Mreg @ xt - rhs) <= 1e-10 * np.linalg.norm(rhs)
    # The preconditioner factors: the f32 inverse and the Jacobi scaling.
    Linv_t, s_t = fac_t(dt, reg)[:2]
    Linv_j, s_j = fac_j(jnp.asarray(d), reg)[:2]
    assert Linv_t.dtype == torch.float64 and _rel(s_t, s_j) <= 1e-6
    assert _rel(Linv_t, Linv_j) <= 1e-4


def test_pcg_factorize_failure_gives_nan():
    A, d, rhs = _system(seed=4)
    At = torch.from_numpy(A)
    fac, solve_ = tdense._pcg_ops(At, At.to(torch.float32), 1e-11, 100)
    # A negative regularization past the unit diagonal breaks the f32 Cholesky.
    factors = fac(torch.from_numpy(d), -2.0)
    assert torch.isnan(factors[0]).all()
    assert torch.isnan(solve_(factors, torch.from_numpy(rhs))).all()


def test_closure_matches_the_reference():
    A, _, _ = _system(m=40, n=120, seed=5)
    rv = np.random.default_rng(6).standard_normal(A.shape[0])
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    Linv_t, s_t = tdense._closure_factors(At.to(torch.float32))
    Linv_j, s_j = jdense._closure_factors(Aj.astype(jnp.float32))
    assert Linv_t.dtype == torch.float32 and _rel(Linv_t, Linv_j) <= 1e-5
    assert _rel(s_t.double(), s_j) <= 1e-6
    pp_t = tdense._closure_project(At, (Linv_t, s_t), 2)
    pp_j = jdense._make_ops(Aj, 1e-8, jnp.float64, 0, closure=(Linv_j, s_j),
                            closure_sweeps=2).primal_project
    dt, dj = pp_t(torch.from_numpy(rv)).numpy(), np.asarray(pp_j(jnp.asarray(rv)))
    assert _rel(dt, dj) <= 1e-10
    # The projection closes the rows: A·δ = rv.
    assert np.linalg.norm(A @ dt - rv) <= 1e-10 * np.linalg.norm(rv)


# The small instances and the loops of the comparison; the reference's own
# routes (its fused and host loops run without the closure, its segmented
# loop with it).
INSTANCES = [(60, 180, 0), (30, 90, 5), (40, 100, 2)]
LOOPS = {"fused": {}, "host": {"fused_loop": False}, "segmented": {"segment_iters": 2}}
OBJ_TOL = 1e-8
HIGHS_TOL = 1e-6


def _port_solve(m, n, seed, **kw):
    be = get_backend("cuda", device="cpu")
    r = solve(tgen.random_dense_lp(m, n, seed=seed), backend=be, tol=1e-8, solve_mode="pcg", **kw)
    return r, be


@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("inst", INSTANCES, ids=lambda i: f"{i[0]}x{i[1]}s{i[2]}")
def test_small_solves_match_the_reference(inst, loop):
    m, n, seed = inst
    pj = jgen.random_dense_lp(m, n, seed=seed)
    rj = jax_solve(pj, backend="tpu", tol=1e-8, solve_mode="pcg", **LOOPS[loop])
    rt, be = _port_solve(m, n, seed, **LOOPS[loop])
    assert rj.status.value == "optimal"
    assert rt.status == Status.OPTIMAL and rt.iterations == rj.iterations
    assert abs(rt.objective - rj.objective) <= OBJ_TOL * (1.0 + abs(rj.objective))
    h = highs_on_general(pj)
    assert abs(rt.objective - h.fun) <= HIGHS_TOL * (1.0 + abs(h.fun))
    # The closure on the segmented route alone; PCG solves on every route.
    assert (be._closure is not None) == (loop == "segmented")
    rep = be.cg_report()
    assert rep["solves"] > 0 and rep["cg_live"] > 0
    if loop != "host":
        assert be.phase_report[0]["mode"] == "pcg"


@pytest.mark.parametrize("inst", INSTANCES, ids=lambda i: f"{i[0]}x{i[1]}s{i[2]}")
def test_fused_and_host_loops_agree(inst):
    m, n, seed = inst
    rf, _ = _port_solve(m, n, seed)
    rh, _ = _port_solve(m, n, seed, fused_loop=False)
    assert rf.iterations == rh.iterations
    assert abs(rf.objective - rh.objective) <= 1e-12 * (1.0 + abs(rh.objective))
    assert _rel(rf.x, rh.x) <= 1e-12


def test_default_solve_mode_stays_direct():
    p = tgen.random_dense_lp(60, 180, seed=0)
    be = get_backend("cuda", device="cpu")
    r = solve(p, backend=be, tol=1e-8)
    rd = solve(tgen.random_dense_lp(60, 180, seed=0), backend=get_backend("cuda", device="cpu"),
               tol=1e-8, solve_mode="direct")
    assert r.status == Status.OPTIMAL and be.phase_report[0]["mode"] == "f64"
    assert be.cg_report() == {"solves": 0, "cg_live": 0, "cg_masked": 0}
    assert be._A32 is None and be._closure is None
    assert np.array_equal(np.asarray(r.x), np.asarray(rd.x))
