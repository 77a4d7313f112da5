"""The slice end to end: the port's dense backend against the JAX package.

Each problem is made by both packages' generators from the same seed (or
read by both MPS readers from one fixture), solved by the port's
``solve(backend=get_backend("cuda", device="cpu"))`` and by the JAX
package's ``solve(backend="tpu")`` and held to HiGHS, in two pairs: the
default (both packages run their fused loop) and ``fused_loop=False``
(both run the host loop). Same status; objectives within 1e-8 relative
of each other and of HiGHS; iteration counts within ±1.
"""

import os

import numpy as np
import pytest
import torch

from distributedlpsolver_tpu.io import read_mps as jax_read_mps
from distributedlpsolver_tpu.ipm import solve as jax_solve
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.models.problem import LPProblem as JaxLP
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.backends.dense import _cholesky_ops
from distributedlpsolver_tpu_torch.io import read_mps
from distributedlpsolver_tpu_torch.ipm import SolveHooks, Status, solve
from distributedlpsolver_tpu_torch.models import generators as tgen
from distributedlpsolver_tpu_torch.models.problem import LPProblem
from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics

from tests.oracle import highs_on_general
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
GENERATED = [
    ("random_dense_lp", (16, 48), {}),
    ("random_general_lp", (12, 30), {}),
    ("random_sparse_lp", (24, 72), {"density": 0.1}),
]


def _pair(case):
    """The same problem from both packages."""
    if case.endswith(".mps"):
        path = os.path.join(FIXTURES, case)
        return read_mps(path), jax_read_mps(path)
    fn, seed = case.split(":")
    args, kw = next((a, k) for f, a, k in GENERATED if f == fn)
    return (getattr(tgen, fn)(*args, seed=int(seed), **kw),
            getattr(jgen, fn)(*args, seed=int(seed), **kw))


CASES = [f"{fn}:{s}" for fn, _, _ in GENERATED for s in range(3)] + ["maximize.mps", "quirks.mps"]


def _rel(a, b):
    return abs(a - b) / (1.0 + abs(b))


# The pairs of loops compared: the host loop in both packages, and each
# package's default (its fused loop).
LOOPS = {"host": {"fused_loop": False}, "fused": {}}


@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("case", CASES)
def test_solve_matches_jax_package_and_highs(case, loop):
    pt, pj = _pair(case)
    rt = solve(pt, backend=get_backend("cuda", device="cpu"), tol=1e-8, **LOOPS[loop])
    rj = jax_solve(pj, backend="tpu", tol=1e-8, **LOOPS[loop])
    h = highs_on_general(pj)
    assert h.status == 0
    # HiGHS reports cᵀx of the minimized form without the constant c0.
    h_obj = h.fun + pj.c0
    h_obj = -h_obj if pj.maximize else h_obj

    assert rt.status == Status.OPTIMAL and rj.status.value == "optimal"
    assert _rel(rt.objective, rj.objective) <= 1e-8
    assert _rel(rt.objective, h_obj) <= 1e-8
    assert _rel(rj.objective, h_obj) <= 1e-8
    assert abs(rt.iterations - rj.iterations) <= 1
    assert rt.backend == "cuda"
    assert pt.max_violation(rt.x) <= 1e-6


def _zero_row_kwargs():
    rng = np.random.default_rng(0)
    m, n = 4, 10
    A = rng.standard_normal((m, n))
    A[2] = 0.0
    x0 = rng.uniform(0.5, 2.0, n)
    b = A @ x0
    c = A.T @ rng.standard_normal(m) + rng.uniform(0.5, 2.0, n)
    return dict(c=c, A=A, rlb=b, rub=b, lb=np.zeros(n), ub=np.full(n, np.inf), name="zero_row")


def test_failed_cholesky_takes_the_bad_step_path_like_jax():
    """A zero row, no presolve to remove it and no regularization: M is
    singular, Cholesky fails, and the port must report it as NaN (not
    raise), so the IPM host loop escalates the regularization through every
    allowed refactorization and ends with the reference's verdict. (The
    fused loop's bad-step path is in test_torch_fused.py.)"""
    reg = obs_metrics.MetricsRegistry()
    prev = obs_metrics.set_registry(reg)
    try:
        rt = solve(LPProblem(**_zero_row_kwargs()), backend=get_backend("cuda", device="cpu"),
                   presolve=False, reg_dual=0.0, fused_loop=False)
    finally:
        obs_metrics.set_registry(prev)
    rj = jax_solve(JaxLP(**_zero_row_kwargs()), backend="tpu", presolve=False, reg_dual=0.0,
                   fused_loop=False)
    assert rt.status.value == rj.status.value == "numerical_error"
    assert rt.iterations == rj.iterations == 0
    refactors = reg.snapshot()["ipm_refactorizations_total"]
    assert refactors == 6  # max_refactor (5) attempts plus the one that gives up


def test_failed_factorization_is_a_nan_factor_not_an_exception():
    A = torch.tensor([[1.0, 2.0], [0.0, 0.0]], dtype=torch.float64)
    factorize, solve_ = _cholesky_ops(A, torch.float64, 0)
    L, _ = factorize(torch.ones(2, dtype=torch.float64), 0.0)
    assert torch.isnan(L).all()
    assert torch.isnan(solve_((L, None), torch.ones(2, dtype=torch.float64))).all()


def test_mixed_precision_factor_uses_a_precast_copy():
    """factor_dtype float32 under float64 iterates: assembly on the f32
    copy of A, f64 residuals — still optimal against HiGHS at 1e-6."""
    pt, pj = _pair("random_dense_lp:0")
    be = get_backend("cuda", device="cpu")
    rt = solve(pt, backend=be, tol=1e-6, factor_dtype="float32")
    assert be._Af is not None and be._Af.dtype == torch.float32
    h = highs_on_general(pj)
    assert rt.status == Status.OPTIMAL
    assert _rel(rt.objective, h.fun) <= 1e-6


def test_unported_options_raise():
    pt, _ = _pair("random_dense_lp:0")
    # The dense and sharded backends run solve_mode="pcg"
    # (tests/test_torch_dense_pcg.py, tests/test_torch_sharded_pcg.py);
    # the block tier's PCG is not ported.
    r = solve(pt, backend=get_backend("sharded", device="cpu"), solve_mode="pcg")
    assert r.status == Status.OPTIMAL
    with pytest.raises(NotImplementedError, match="item 5b"):
        solve(pt, backend=get_backend("block", device="cpu"), solve_mode="pcg")
    # The warm cache is ported (serve/warmcache.py) and no longer raises.
    from distributedlpsolver_tpu_torch.serve.warmcache import WarmCache

    r = solve(pt, backend=get_backend("cuda", device="cpu"), warm_cache=WarmCache(2))
    assert r.status == Status.OPTIMAL and r.warm == "cold"


def test_hooks_see_every_iteration_and_the_profiler_writes_a_trace(tmp_path):
    class Count(SolveHooks):
        def __init__(self):
            self.steps, self.seen = 0, []

        def run_step(self, step_fn, iteration):
            self.steps += 1
            return step_fn()

        def on_iterate(self, iteration, scalars):
            self.seen.append((iteration, scalars["rel_gap"]))

    pt, _ = _pair("random_dense_lp:1")
    hooks = Count()
    r = solve(pt, backend=get_backend("cuda", device="cpu"), hooks=hooks,
              profile_dir=str(tmp_path / "prof"))
    assert r.status == Status.OPTIMAL
    assert hooks.steps == r.iterations and [i for i, _ in hooks.seen] == list(range(1, r.iterations + 1))
    assert hooks.seen[-1][1] == r.rel_gap
    assert os.path.getsize(tmp_path / "prof" / "torch_trace.json") > 0

