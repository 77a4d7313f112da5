"""The torch package's host backends (``cpu``, ``cpu-native``,
``cpu-sparse``) against the JAX package's, on the same problems: the cases
of the JAX package's ``tests/test_backends_cpu.py`` and
``tests/test_cpu_sparse.py`` run through both packages.

Tolerances: equal status and iteration counts, objectives within 1e-8
relative of each other; HiGHS at the reference tests' own tolerances. The
port's native library is held to the reference's NumPy oracle.
"""

import ctypes
import json
import os

import numpy as np
import pytest
import scipy.sparse as sp

from distributedlpsolver_tpu import cli as jax_cli
from distributedlpsolver_tpu.ipm import solve as jax_solve
from distributedlpsolver_tpu.ipm.state import IPMState as JaxState
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.models.problem import LPProblem as JaxLP
from distributedlpsolver_tpu.obs import metrics as jax_metrics
from distributedlpsolver_tpu_torch import cli
from distributedlpsolver_tpu_torch.backends import available_backends, get_backend
from distributedlpsolver_tpu_torch.io.mps import write_mps
from distributedlpsolver_tpu_torch.ipm import Status, solve
from distributedlpsolver_tpu_torch.ipm.state import IPMState
from distributedlpsolver_tpu_torch.models import generators as tgen
from distributedlpsolver_tpu_torch.models.problem import LPProblem
from distributedlpsolver_tpu_torch.native import build as native_build
from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics

from tests.oracle import highs_on_general

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(fn, *args, **kw):
    jp = getattr(jgen, fn)(*args, **kw)
    tp = getattr(tgen, fn)(*args, **kw)
    return tp, jp


def _same(rt, rj, rel=1e-8):
    assert rt.status.value == rj.status.value
    assert rt.iterations == rj.iterations
    assert abs(rt.objective - rj.objective) <= rel * (1 + abs(rj.objective))


@pytest.mark.parametrize("backend", ["cpu", "cpu-native"])
def test_cpu_backends_match_highs(backend):
    pt, pj = _pair("random_general_lp", 25, 45, seed=4)
    rt = solve(pt, backend=get_backend(backend), max_iter=60)
    rj = jax_solve(pj, backend=backend, max_iter=60)
    hi = highs_on_general(pj)
    assert rt.status == Status.OPTIMAL and rt.backend == backend
    assert abs(rt.objective - hi.fun) <= 2e-6 * (1 + abs(hi.fun))
    _same(rt, rj)


def test_native_agrees_with_numpy_cpu():
    pt, pj = _pair("random_dense_lp", 35, 80, seed=9)
    r1 = solve(pt, backend="cpu", max_iter=60)
    r2 = solve(pt, backend="cpu-native", max_iter=60)
    assert r1.status == r2.status == Status.OPTIMAL
    # identical algorithm, different kernels: same iterate path to rounding
    assert r1.iterations == r2.iterations
    assert r2.objective == pytest.approx(r1.objective, rel=1e-9)
    _same(r2, jax_solve(pj, backend="cpu-native", max_iter=60))


def test_native_kernels_against_numpy_oracle(rng):
    """The port's own copy of the kernels, built into build/dlps_torch/,
    against NumPy/SciPy (the JAX package's kernel-level oracle test)."""
    lib = native_build.load()
    assert os.path.dirname(native_build.build()) == os.path.join(ROOT, "build", "dlps_torch")
    assert lib.dlps_num_threads() >= 1
    m, n = 17, 29
    A = np.ascontiguousarray(rng.standard_normal((m, n)))
    d = np.ascontiguousarray(rng.uniform(0.5, 2.0, n))
    M = np.empty((m, m))
    scratch = np.empty((m, n))
    dp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    lib.dlps_normal_eq(dp(A), dp(d), m, n, 0.0, dp(scratch), dp(M))
    np.testing.assert_allclose(M, (A * d) @ A.T, rtol=1e-12, atol=1e-12)

    Mreg = M + np.eye(m) * 1e-6
    L = np.ascontiguousarray(Mreg.copy())
    assert lib.dlps_cholesky(dp(L), m) == 0
    rhs = np.ascontiguousarray(rng.standard_normal(m))
    out = np.empty(m)
    lib.dlps_cho_solve(dp(L), dp(rhs), m, dp(out))
    np.testing.assert_allclose(out, np.linalg.solve(Mreg, rhs), rtol=1e-9, atol=1e-10)

    # non-PD must be reported, not crash
    bad = np.ascontiguousarray(-np.eye(m))
    assert lib.dlps_cholesky(dp(bad), m) == 1


def test_a_missing_compiler_raises_native_build_error(monkeypatch, tmp_path):
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on it
    with pytest.raises(native_build.NativeBuildError, match="g\\+\\+ not available"):
        native_build.build(force=True)


@pytest.mark.parametrize("flags", [["--json"], ["--x-out"]])
def test_cli_solve_on_the_cpu_backend(tmp_path, capsys, flags):
    """``cli solve --backend cpu`` (a host backend: it needs no card) gives
    the JAX CLI's answer."""
    pt, pj = _pair("random_general_lp", 15, 25, seed=6)
    f = str(tmp_path / "p.mps")
    write_mps(pt, f)
    xf = str(tmp_path / "x.npy")
    extra = ["--json"] if flags == ["--json"] else ["--x-out", xf]
    rc = cli.main(["solve", f, "--backend", "cpu", "--quiet", *extra])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert rc == 0
    if flags == ["--json"]:
        rec = json.loads(out)
        assert rec["status"] == "optimal" and rec["backend"] == "cpu"
        assert jax_cli.main(["solve", f, "--backend", "cpu", "--quiet", "--json"]) == 0
        ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec["iterations"] == ref["iterations"]
        assert abs(rec["objective"] - ref["objective"]) <= 1e-8 * (1 + abs(ref["objective"]))
        hi = highs_on_general(pj)
        assert abs(rec["objective"] - hi.fun) <= 2e-6 * (1 + abs(hi.fun))
    else:
        x = np.load(xf)
        assert pt.max_violation(x) <= 1e-6 * (1 + float(np.abs(x).max()))


def test_cpu_sparse_is_registered():
    for name in ("cpu", "numpy", "scipy", "cpu-native", "native", "cpu-sparse", "sparse"):
        assert name in available_backends()


def test_cpu_sparse_matches_dense_cpu_on_dense_input():
    pt, pj = _pair("random_dense_lp", 40, 100, seed=0)
    r_s = solve(pt, backend="cpu-sparse")
    r_d = solve(pt, backend="cpu")
    assert r_s.status.value == "optimal" and r_s.backend == "cpu-sparse"
    np.testing.assert_allclose(r_s.objective, r_d.objective, rtol=1e-7)
    np.testing.assert_allclose(r_s.x, r_d.x, rtol=1e-5, atol=1e-7)
    _same(r_s, jax_solve(pj, backend="cpu-sparse"))


@pytest.mark.parametrize("args, oracle", [
    ((5, 30, 70, 15, 2), "cpu"),
    ((8, 40, 80, 20, 5), "highs"),
])
def test_cpu_sparse_block_angular_stays_sparse_and_solves(args, oracle):
    *shape, seed = args
    pt, pj = _pair("block_angular_lp", *shape, seed=seed, sparse=True)
    assert sp.issparse(pt.A)
    rt = solve(pt, backend="cpu-sparse")
    assert rt.status.value == "optimal"
    if oracle == "cpu":
        ref = solve(pt, backend="cpu").objective
        np.testing.assert_allclose(rt.objective, ref, rtol=1e-7)
    else:
        hi = highs_on_general(pj)
        assert hi.status == 0
        np.testing.assert_allclose(rt.objective, hi.fun, rtol=1e-6)
    _same(rt, jax_solve(pj, backend="cpu-sparse"))


def _zero_row_kwargs():
    rng = np.random.default_rng(0)
    m, n = 4, 10
    A = rng.standard_normal((m, n))
    A[2] = 0.0
    x0 = rng.uniform(0.5, 2.0, n)
    b = A @ x0
    c = A.T @ rng.standard_normal(m) + rng.uniform(0.5, 2.0, n)
    return dict(c=c, A=A, rlb=b, rub=b, lb=np.zeros(n), ub=np.full(n, np.inf), name="zero_row")


@pytest.mark.parametrize("backend", ["cpu", "cpu-native"])
def test_failed_factorization_takes_the_reference_path(backend):
    """The zero-row LP with presolve off and no regularization: its
    normal matrix is singular. A cold start raises the factorization's
    ``LinAlgError`` from the starting point, in both packages; from a
    given iterate every step is bad, the driver bumps the regularization
    through all its refactorizations and ends with ``numerical_error``
    after 0 iterations, in both."""
    kw = dict(presolve=False, reg_dual=0.0)
    with pytest.raises(np.linalg.LinAlgError):
        solve(LPProblem(**_zero_row_kwargs()), backend=backend, **kw)
    with pytest.raises(np.linalg.LinAlgError):
        jax_solve(JaxLP(**_zero_row_kwargs()), backend=backend, **kw)
    start = (np.ones(10), np.zeros(4), np.ones(10), np.ones(10), np.zeros(10))
    out = []
    for pkg, metrics, run, lp, state in (
        ("port", obs_metrics, solve, LPProblem, IPMState),
        ("jax", jax_metrics, jax_solve, JaxLP, JaxState),
    ):
        reg = metrics.MetricsRegistry()
        prev = metrics.set_registry(reg)
        try:
            r = run(lp(**_zero_row_kwargs()), backend=backend, scale=False,
                    warm_start=state(*start), **kw)
        finally:
            metrics.set_registry(prev)
        out.append((r.status.value, r.iterations, reg.snapshot()["ipm_refactorizations_total"]))
    assert out[0] == out[1] == ("numerical_error", 0, 6.0)
