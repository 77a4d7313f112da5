"""The port's PCG and preconditioners (``ops/pcg.py``, ``ops/ildl.py``)
against the JAX package's, on the CPU.

The same seeded normal operator ``A·diag(d)·Aᵀ + reg·I`` and right-hand
sides go through both packages: ``pcg`` takes the same number of
iterations and its x agrees to 1e-10 relative; ``pcg_batched`` and
``solve_chunked`` the same; Jacobi, block-Jacobi, bordered-Woodbury and
ILDL factors and applies agree to 1e-10 relative (the same arithmetic,
with library Cholesky and triangular solves that round in another
order). The masked chunks of the port's CG loop give the unmasked loop's
x and count bit for bit, a failed Cholesky gives NaN instead of raising,
and the symbolic setup's arrays are the reference's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.ops import ildl as jildl
from distributedlpsolver_tpu.ops import pcg as jpcg
from distributedlpsolver_tpu.ops import sparse as jsparse
from distributedlpsolver_tpu_torch.ops import ildl as tildl
from distributedlpsolver_tpu_torch.ops import pcg as tpcg
from distributedlpsolver_tpu_torch.ops import sparse as tsparse

# Factors, applies and CG solutions against the JAX package's: the same
# arithmetic, rounded in another order by the library Cholesky and solves.
PREC_TOL = 1e-10
X_TOL = 1e-10


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


class _Normal:
    """One problem's normal operator in both packages, at a seeded
    log-uniform scaling spread."""

    def __init__(self, problem, seed=0, spread=4.0, reg=1e-10):
        self.A = problem.A.tocsr()
        self.hint = problem.block_structure
        self.m, self.n = self.A.shape
        rng = np.random.default_rng(seed)
        self.d_np = 10.0 ** rng.uniform(-spread, spread, self.n)
        self.reg = reg
        self.top, self.jop = tsparse.from_scipy(self.A), jsparse.from_scipy(self.A)
        self.d, self.jd = torch.from_numpy(self.d_np), jnp.asarray(self.d_np)

    def mv(self, v):
        return self.top.matvec(self.d * self.top.rmatvec(v)) + self.reg * v

    def jmv(self, v):
        return self.jop.matvec(self.jd * self.jop.rmatvec(v)) + self.reg * v

    def precs(self, kind):
        """(port apply, JAX apply) of preconditioner ``kind``."""
        if kind == "jacobi":
            return tpcg.jacobi(self.top, self.d, self.reg), jpcg.jacobi(self.jop, self.jd, self.reg)
        if kind == "block":
            t, j = tpcg.BlockJacobi(self.A, block_size=16), jpcg.BlockJacobi(self.A, block_size=16)
        elif kind == "bordered":
            t, j = tpcg.BorderedPrecond(self.A, self.hint), jpcg.BorderedPrecond(self.A, self.hint)
        else:
            t, j = tildl.ILDLPrecond(self.A), jildl.ILDLPrecond(self.A)
        return (t.apply_with(t.factor(self.d, self.reg)),
                j.apply_with(j.factor(self.jd, jnp.asarray(self.reg))))


@pytest.fixture(scope="module")
def storm():
    return _Normal(jgen.storm_sparse_lp(8, 16, 24, 16, seed=5), spread=3.0)


# Spreads at which CG converges in tens of iterations (a few hundred at
# wider spreads): over longer runs the reduction orders' rounding moves the
# exit by an iteration or two.
@pytest.mark.parametrize("kind, spread", [("jacobi", 1.0), ("block", 0.5), ("bordered", 4.0),
                                          ("ildl", 1.0)])
def test_pcg_matches_the_jax_pcg(kind, spread):
    N = _Normal(jgen.storm_sparse_lp(8, 16, 24, 16, seed=5), spread=spread)
    tp, jp = N.precs(kind)
    rhs = np.random.default_rng(3).standard_normal(N.m)
    x, it = tpcg.pcg(N.mv, tp, torch.from_numpy(rhs), 1e-12, 4096)
    xj, itj = jpcg.pcg(N.jmv, jp, jnp.asarray(rhs), 1e-12, 4096)
    assert it == int(itj) >= 1
    assert _rel(x, xj) <= X_TOL
    # And it solves the normal equations (dense check).
    M = (N.A.toarray() * N.d_np) @ N.A.toarray().T + N.reg * np.eye(N.m)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(M, rhs), rtol=1e-6,
                               atol=1e-8 * np.abs(rhs).max())


@pytest.mark.parametrize("kind", ["jacobi", "block", "bordered", "ildl"])
def test_preconditioner_applies_match_the_jax_ones(storm, kind):
    tp, jp = storm.precs(kind)
    R = np.random.default_rng(4).standard_normal((3, storm.m))
    assert _rel(tp(torch.from_numpy(R[0])), jp(jnp.asarray(R[0]))) <= PREC_TOL
    # A batch of lanes, one (B, m) call.
    assert _rel(tp(torch.from_numpy(R)), jp(jnp.asarray(R))) <= PREC_TOL


def test_block_and_bordered_factors_match_the_jax_factors(storm):
    A, hint = storm.A, storm.hint
    t, j = tpcg.BlockJacobi(A, block_size=16), jpcg.BlockJacobi(A, block_size=16)
    assert _rel(t.factor(storm.d, storm.reg), j.factor(storm.jd, jnp.asarray(storm.reg))) <= PREC_TOL
    tb, jb = tpcg.BorderedPrecond(A, hint), jpcg.BorderedPrecond(A, hint)
    for a, b in zip(tb.factor(storm.d, storm.reg), jb.factor(storm.jd, jnp.asarray(storm.reg))):
        assert a.shape == b.shape and _rel(a, b) <= PREC_TOL
    assert _rel(tb.V, jb.V) == 0.0
    assert tb.memory_report().keys() == jb.memory_report().keys()


@pytest.mark.parametrize("exclude", [False, True])
def test_block_slices_are_the_jax_arrays(exclude):
    """The vectorized symbolic setup gives the reference loop's arrays:
    ragged block sizes, excluded columns, the quantized width."""
    A = jgen.storm_sparse_lp(8, 16, 24, 16, seed=6).A.tocsr()
    starts, sizes = [0, 20, 50, 97], [20, 30, 47, 31]
    excl = (np.arange(A.shape[1]) < 16) if exclude else None
    Ab, colidx, rowmask, bs, w = tpcg._block_slices(A, starts, sizes, excl)
    jAb, jcolidx, jrowmask, jbs, jw = jpcg._block_slices(A, starts, sizes, excl)
    assert (bs, w) == (jbs, jw)
    np.testing.assert_array_equal(Ab.numpy(), jAb)
    np.testing.assert_array_equal(colidx, jcolidx)
    np.testing.assert_array_equal(rowmask, jrowmask)


def test_block_jacobi_with_ragged_blocks_scatters_back(storm):
    """A row count that the block size does not divide: the last block is
    padded, and gather/scatter invert each other."""
    A = jgen.netlib_sparse_lp(90, 160, seed=8).A.tocsr()
    t, j = tpcg.BlockJacobi(A, block_size=16), jpcg.BlockJacobi(A, block_size=16)
    assert not t._tiled
    d = np.random.default_rng(9).uniform(0.5, 2.0, A.shape[1])
    tp = t.apply_with(t.factor(torch.from_numpy(d), 1e-8))
    jp = j.apply_with(j.factor(jnp.asarray(d), jnp.asarray(1e-8)))
    r = np.random.default_rng(10).standard_normal(A.shape[0])
    assert _rel(tp(torch.from_numpy(r)), jp(jnp.asarray(r))) <= PREC_TOL
    np.testing.assert_array_equal(t.scatter(t.gather(torch.from_numpy(r))).numpy(), r)


def test_ildl_factor_matches_the_jax_factor():
    A = jgen.netlib_sparse_lp(120, 220, seed=10).A.tocsr()
    d = 10.0 ** np.random.default_rng(0).uniform(-3, 3, A.shape[1])
    t, j = tildl.ILDLPrecond(A), jildl.ILDLPrecond(A)
    assert (t.m, t.nl, t.depth) == (j.m, j.nl, j.depth)
    for a, b in zip(t.factor(torch.from_numpy(d), 1e-8), j.factor(jnp.asarray(d), 1e-8)):
        assert _rel(a, b) <= PREC_TOL


def test_ildl_refuses_patterns_over_its_budget():
    import scipy.sparse as sp

    with pytest.raises(ValueError, match="rows exceeds"):
        tildl.ILDLPrecond(sp.eye(tildl._MAX_ROWS + 1, 4, format="csr"))
    dense_col = sp.csr_matrix(np.ones((3000, 1)))
    with pytest.raises(ValueError, match="budget"):
        tildl.ILDLPrecond(dense_col)


def test_masked_chunks_give_the_unmasked_loops_bits(storm, monkeypatch):
    """A chunk of masked iterations past the exit changes no carry: x and
    the count equal those of the loop that reads the flag every
    iteration, bit for bit (chunks of 5 forced on the CPU)."""
    tp, _ = storm.precs("bordered")
    rhs = torch.from_numpy(np.random.default_rng(5).standard_normal(storm.m))
    x1, it1 = tpcg.pcg(storm.mv, tp, rhs, 1e-10, 4096)
    syncs = tpcg.pcg.syncs

    def fives(device, first_chunk):
        while True:
            yield 5

    monkeypatch.setattr(tpcg, "_chunks", fives)
    x5, it5 = tpcg.pcg(storm.mv, tp, rhs, 1e-10, 4096)
    assert it1 == it5 and it1 % 5 != 0 and torch.equal(x1, x5)
    assert tpcg.pcg.syncs - syncs == -(-it1 // 5)


def test_chunk_sizes_on_a_card_grow_and_start_from_the_hint():
    import itertools

    sizes = list(itertools.islice(tpcg._chunks(torch.device("cuda"), 7), 6))
    assert sizes[0] == 7 and sizes[1:3] == [tpcg.CG_CHUNK, tpcg.CG_CHUNK]
    assert all(b >= a for a, b in zip(sizes[1:], sizes[2:]))
    assert next(tpcg._chunks(torch.device("cuda"), 10_000)) == tpcg.CG_FIRST_MAX
    assert list(itertools.islice(tpcg._chunks(torch.device("cpu"), 7), 3)) == [1, 1, 1]


def test_bordered_is_near_exact():
    """On an exactly bordered pattern the Woodbury preconditioner is the
    regularized normal-matrix inverse: a handful of CG iterations at a
    wide scaling spread (the reference's test)."""
    N = _Normal(jgen.storm_sparse_lp(16, 32, 48, 24, seed=6), spread=6.0)
    tp, _ = N.precs("bordered")
    rhs = torch.from_numpy(np.random.default_rng(4).standard_normal(N.m))
    x, it = tpcg.pcg(N.mv, tp, rhs, 1e-10, 4096)
    assert torch.isfinite(x).all() and it <= 16


def test_failed_cholesky_gives_nan_not_an_exception():
    """A block that is not positive definite: its factor is NaN on the
    device, PCG returns NaN, and nothing raises (the reference's
    Cholesky semantics)."""
    N = _Normal(jgen.storm_sparse_lp(4, 16, 24, 8, seed=2), spread=1.0)
    prec = tpcg.BorderedPrecond(N.A, N.hint)
    d_bad = N.d.clone()
    d_bad[20:40] = -1e6
    L, Zb, capL = prec.factor(d_bad, 0.0)
    assert torch.isnan(L).any() and not torch.isnan(L[-1]).any()
    x, _ = tpcg.pcg(N.mv, prec.apply_with((L, Zb, capL)),
                    torch.ones(N.m, dtype=torch.float64), 1e-10, 200)
    assert torch.isnan(x).all()


def test_pcg_that_cannot_reduce_the_residual_returns_nan():
    """A zero operator: no iteration reduces the residual, the stall
    window ends the loop, and the failure test returns NaN — after the
    reference's iteration count."""
    x, it = tpcg.pcg(lambda v: 0.0 * v, lambda r: r, torch.ones(6, dtype=torch.float64), 1e-12, 500)
    xj, itj = jpcg.pcg(lambda v: 0.0 * v, lambda r: r, jnp.ones(6), 1e-12, 500)
    assert torch.isnan(x).all() and np.isnan(np.asarray(xj)).all()
    assert it == int(itj) == tpcg._STALL_WINDOW


# The batched cases run the bordered preconditioner, whose CG takes a few
# iterations: over dozens of Jacobi iterations a lane's residual can sit on
# its threshold, and the two packages' norms, rounded in another order,
# then exit an iteration apart.


def _lanes_mv(N):
    def mvB(V):
        return torch.stack([N.mv(v) for v in V])

    return mvB


def test_batched_matches_the_jax_batch_and_freezes_inactive_lanes(storm):
    import jax

    tp, jp = storm.precs("bordered")
    R = np.random.default_rng(5).standard_normal((4, storm.m))
    active = np.array([True, True, False, True])
    X, its, ok = tpcg.pcg_batched(_lanes_mv(storm), tp, torch.from_numpy(R), 1e-10, 4096,
                                  active=torch.from_numpy(active))
    Xj, itsj, okj = jpcg.pcg_batched(jax.vmap(storm.jmv), jp, jnp.asarray(R), 1e-10, 4096,
                                     active=jnp.asarray(active))
    np.testing.assert_array_equal(its.numpy(), np.asarray(itsj))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    assert its[2] == 0 and torch.equal(X[2], torch.zeros(storm.m, dtype=torch.float64))
    assert _rel(X, Xj) <= X_TOL
    for k in (0, 1, 3):
        x1, it1 = tpcg.pcg(storm.mv, tp, torch.from_numpy(R[k]), 1e-10, 4096)
        assert it1 == its[k] and _rel(X[k], x1) <= X_TOL


def test_chunked_splits_wide_batches_as_the_jax_chunks(storm):
    import jax

    tp, jp = storm.precs("bordered")
    R = np.random.default_rng(6).standard_normal((7, storm.m))
    X, its, ok = tpcg.solve_chunked(
        lambda r: tpcg.pcg_batched(_lanes_mv(storm), tp, r, 1e-10, 4096), torch.from_numpy(R),
        chunk=3)
    Xj, itsj, okj = jpcg.solve_chunked(
        lambda r: jpcg.pcg_batched(jax.vmap(storm.jmv), jp, r, 1e-10, 4096), jnp.asarray(R),
        chunk=3)
    Xr, _, _ = tpcg.pcg_batched(_lanes_mv(storm), tp, torch.from_numpy(R), 1e-10, 4096)
    assert X.shape == (7, storm.m) and its.shape == (7,) and bool(ok.all())
    np.testing.assert_array_equal(its.numpy(), np.asarray(itsj))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    assert _rel(X, Xj) <= X_TOL and _rel(X, Xr) <= X_TOL
