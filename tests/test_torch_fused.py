"""The port's fused loop (``ipm/core.py`` ``fused_body``/``fused_solve``,
``ipm/device_loop.py`` and the dense backend's ``solve_full``) on the CPU,
against the JAX package's fused and segmented loops and the port's own
host loop.

Problems are made by both packages' generators from the same seed (the
default, fused pair against JAX and HiGHS is the ``fused`` case of
``test_torch_dense.py::test_solve_matches_jax_package_and_highs``). Here:
the port's fused history equals its host-loop history row for row to
1e-12 relative, with equal iterations; ``segment_iters`` 1 and 3 give the
JAX package's status and iterations and the port's unsegmented result bit
for bit; the status paths (bad step, infeasible, unbounded, iteration
limit, stall) agree with the JAX package's fused loop; a body run past the
exit leaves the carry bit for bit; the host-side helpers agree with the
JAX package's on the same inputs.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedlpsolver_tpu.backends import get_backend as jax_backend
from distributedlpsolver_tpu.io import read_mps as jax_read_mps
from distributedlpsolver_tpu.ipm import core as jcore
from distributedlpsolver_tpu.ipm import solve as jax_solve
from distributedlpsolver_tpu.ipm.state import IPMState as JaxState
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.models.problem import LPProblem as JaxLP
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.io import read_mps
from distributedlpsolver_tpu_torch.ipm import Status, solve
from distributedlpsolver_tpu_torch.ipm import core as tcore
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.ipm.state import IPMState
from distributedlpsolver_tpu_torch.models import generators as tgen
from distributedlpsolver_tpu_torch.models.problem import LPProblem, to_interior_form
from distributedlpsolver_tpu_torch.models.scaling import equilibrate
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
GENERATED = {
    "random_dense_lp": ((16, 48), {}),
    "random_general_lp": ((12, 30), {}),
    "random_sparse_lp": ((24, 72), {"density": 0.1}),
}
CASES = [f"{fn}:{s}" for fn in GENERATED for s in range(3)] + ["maximize.mps", "quirks.mps"]
FIELDS = ("mu", "gap", "rel_gap", "pinf", "dinf", "pobj", "dobj", "alpha_p", "alpha_d", "sigma")
INF = np.inf


def _pair(case):
    """The same problem from both packages."""
    if case.endswith(".mps"):
        path = os.path.join(FIXTURES, case)
        return read_mps(path), jax_read_mps(path)
    fn, seed = case.split(":")
    args, kw = GENERATED[fn]
    return (getattr(tgen, fn)(*args, seed=int(seed), **kw),
            getattr(jgen, fn)(*args, seed=int(seed), **kw))


def _cpu():
    return get_backend("cuda", device="cpu")


def _rel(a, b):
    return abs(a - b) / (1.0 + abs(b))


@pytest.mark.parametrize("case", CASES)
def test_fused_history_equals_host_loop(case):
    pt, _ = _pair(case)
    be = _cpu()
    rf = solve(pt, backend=be, tol=1e-8)
    rh = solve(pt, backend=_cpu(), tol=1e-8, fused_loop=False)
    assert rf.status == rh.status == Status.OPTIMAL
    assert rf.iterations == rh.iterations == len(rf.history) == len(rh.history)
    for a, b in zip(rf.history, rh.history):
        assert a.iter == b.iter
        for f in FIELDS:
            assert abs(getattr(a, f) - getattr(b, f)) <= 1e-12 * max(abs(getattr(b, f)), 1e-300)
    # One fused phase, every body accounted for: accepted + bad + masked.
    (row,) = be.phase_report
    assert row["iters"] == rf.iterations
    assert row["bodies"] == row["iters"] + row["bad_steps"] + row["masked"]


@pytest.mark.parametrize("seg", [1, 3])
@pytest.mark.parametrize("case", ["random_dense_lp:0", "random_general_lp:1"])
def test_segmented_matches_jax_and_the_unsegmented_loop(case, seg):
    pt, pj = _pair(case)
    jbe = jax_backend("tpu")
    rj = jax_solve(pj, backend=jbe, tol=1e-8, segment_iters=seg)
    be = _cpu()
    rs = solve(pt, backend=be, tol=1e-8, segment_iters=seg)
    rf = solve(pt, backend=_cpu(), tol=1e-8)
    assert rs.status.value == rj.status.value == "optimal"
    assert rs.iterations == rj.iterations
    assert _rel(rs.objective, rj.objective) <= 1e-8
    # Segmentation only cuts the loop: the same bodies on the same carry.
    assert np.array_equal(rs.x, rf.x) and rs.iterations == rf.iterations
    assert [r.rel_gap for r in rs.history] == [r.rel_gap for r in rf.history]
    assert len(be.phase_report) == len(jbe.phase_report) == 1
    (row,), (jrow,) = be.phase_report, jbe.phase_report
    assert set(jrow) <= set(row) and row["mode"] == jrow["mode"] == "f64"
    assert row["iters"] == jrow["iters"] == rs.iterations
    assert row["bodies"] == row["iters"] + row["bad_steps"] + row["masked"]


def _zero_row_kwargs():
    rng = np.random.default_rng(0)
    m, n = 4, 10
    A = rng.standard_normal((m, n))
    A[2] = 0.0
    x0 = rng.uniform(0.5, 2.0, n)
    b = A @ x0
    c = A.T @ rng.standard_normal(m) + rng.uniform(0.5, 2.0, n)
    return dict(c=c, A=A, rlb=b, rub=b, lb=np.zeros(n), ub=np.full(n, INF), name="zero_row")


def _infeasible_kwargs():
    # x1 + x2 = 2  AND  x1 + x2 <= 1, x >= 0 (tests/test_status.py)
    return dict(c=[1.0, 1.0], A=np.array([[1.0, 1.0], [1.0, 1.0]]), rlb=[2.0, -INF],
                rub=[2.0, 1.0], lb=[0.0, 0.0], ub=[INF, INF], name="infeasible")


def _unbounded_kwargs():
    # min -x1, x1 - x2 = 0, x >= 0 → ray (t, t) (tests/test_status.py)
    return dict(c=[-1.0, 0.0], A=np.array([[1.0, -1.0]]), rlb=[0.0], rub=[0.0],
                lb=[0.0, 0.0], ub=[INF, INF], name="unbounded")


def test_bad_step_path_through_the_fused_loop():
    """Zero row, no presolve, no regularization: every body's Cholesky
    fails, the loop escalates reg on the device and gives up with the JAX
    fused loop's verdict at 0 iterations."""
    be = _cpu()
    rt = solve(LPProblem(**_zero_row_kwargs()), backend=be, presolve=False, reg_dual=0.0)
    rj = jax_solve(JaxLP(**_zero_row_kwargs()), backend="tpu", presolve=False, reg_dual=0.0)
    assert rt.status.value == rj.status.value == "numerical_error"
    assert rt.iterations == rj.iterations == 0 and rt.history == []
    (row,) = be.phase_report
    assert row["iters"] == 0 and row["bad_steps"] == row["bodies"] == 6


@pytest.mark.parametrize("kwargs", [_infeasible_kwargs, _unbounded_kwargs])
def test_infeasible_and_unbounded_like_the_jax_fused_loop(kwargs):
    rt = solve(LPProblem(**kwargs()), backend=_cpu(), max_iter=100)
    rj = jax_solve(JaxLP(**kwargs()), backend="tpu", max_iter=100)
    assert rt.status.value == rj.status.value
    assert rt.status in (Status.PRIMAL_INFEASIBLE, Status.DUAL_INFEASIBLE)
    assert rt.iterations == rj.iterations


def test_iteration_limit():
    pt, pj = _pair("random_dense_lp:1")
    rt = solve(pt, backend=_cpu(), max_iter=3)
    rj = jax_solve(pj, backend="tpu", max_iter=3)
    assert rt.status == Status.ITERATION_LIMIT and rj.status.value == "iteration_limit"
    assert rt.iterations == rj.iterations == 3 and len(rt.history) == 3


def test_stall_exit_like_the_jax_fused_loop():
    """A fraction-to-boundary of 0.02 improves the error by ~2% a step, so
    no step improves it by 10% and a window of 2·1 accepted steps runs
    out: both fused loops report ``stalled`` at the same iteration."""
    pt, pj = _pair("random_dense_lp:0")
    rt = solve(pt, backend=_cpu(), eta=0.02, stall_window=1)
    rj = jax_solve(pj, backend="tpu", eta=0.02, stall_window=1)
    assert rt.status == Status.STALLED and rj.status.value == "stalled"
    assert rt.iterations == rj.iterations
    assert _rel(rt.objective, rj.objective) <= 1e-8


def _loop_parts(case="random_general_lp:2", **cfg_kw):
    pt, _ = _pair(case)
    inf, _ = equilibrate(to_interior_form(pt))
    cfg = SolverConfig(**cfg_kw)
    be = _cpu()
    be.setup(inf, cfg)
    state = be.starting_point()
    step = be._step(be._point_spec())
    carry = tcore.fresh_segment_carry(state, be._reg0(), tcore.buffer_cap(cfg.max_iter),
                                      torch.float64)
    return cfg, be, step, carry


@pytest.mark.parametrize("exit_by", ["optimal", "max_iter", "it_stop"])
def test_a_body_past_the_exit_leaves_the_carry_bit_for_bit(exit_by):
    cfg, be, step, carry = _loop_parts()
    max_iter = 4 if exit_by == "max_iter" else cfg.max_iter
    it_stop = 3 if exit_by == "it_stop" else None
    args = (step, be._params, max_iter, cfg.max_refactor, cfg.reg_grow,
            tcore.buffer_cap(cfg.max_iter))
    kw = dict(it_stop=it_stop, stall_window=2 * cfg.stall_window,
              stall_patience_floor=1e3 * cfg.tol)
    go = lambda c: bool(tcore.fused_cond(c, max_iter, args[-1], it_stop, kw["stall_window"],
                                         kw["stall_patience_floor"]))
    while go(carry):
        carry = tcore.fused_body(carry, *args, **kw)
    if exit_by == "optimal":
        assert int(carry[4]) == tcore.STATUS_OPTIMAL
    else:
        assert int(carry[1]) == (max_iter if it_stop is None else it_stop)
        assert int(carry[4]) == tcore.STATUS_RUNNING
    before, _ = tcore.device_loop.flatten(carry)
    for _ in range(3):
        carry = tcore.fused_body(carry, *args, **kw)
    after, _ = tcore.device_loop.flatten(carry)
    assert len(before) == len(after) == 12
    for a, b in zip(before, after):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_fused_solve_continues_exactly_across_calls():
    """``it_stop`` + ``return_carry`` then ``resume``, and ``finalize=False``
    then ``carry_in``, cut one fused solve into two calls with the same
    bits as one call."""
    cfg, be, step, carry = _loop_parts()
    state0, reg0 = carry[0], carry[2]
    args = (be._params, cfg.max_iter, cfg.max_refactor, cfg.reg_grow)
    kw = dict(stall_window=2 * cfg.stall_window, stall_patience_floor=1e3 * cfg.tol)
    whole = tcore.fused_solve(step, state0, reg0, *args, **kw)
    assert int(whole[2]) == tcore.STATUS_OPTIMAL and int(whole[1]) > 3

    part = tcore.fused_solve(step, state0, reg0, *args, it_stop=3, return_carry=True, **kw)
    assert int(part[1]) == 3 and int(part[4]) == tcore.STATUS_RUNNING
    resumed = tcore.fused_solve(step, None, None, *args, resume=part, **kw)

    st1, it1, status1, buf1 = tcore.fused_solve(step, state0, reg0, be._params, 3,
                                                cfg.max_refactor, cfg.reg_grow,
                                                tcore.buffer_cap(cfg.max_iter),
                                                finalize=False, **kw)
    assert int(it1) == 3 and int(status1) == tcore.STATUS_RUNNING
    continued = tcore.fused_solve(step, st1, reg0, *args, carry_in=(it1, status1, buf1), **kw)
    for other in (resumed, continued):
        assert int(other[1]) == int(whole[1]) and int(other[2]) == int(whole[2])
        assert torch.equal(other[0].x, whole[0].x) and torch.equal(other[3], whole[3])


def test_fused_body_stall_exit_and_bad_step_escalation():
    """The stall counter and the bad-step escalation of one body, driven
    directly: a step that reports ``bad`` freezes the state and the
    iteration count and multiplies reg by reg_grow; ``since`` past the
    window ends the loop unless the best error is under the floor."""
    cfg, be, step, carry = _loop_parts()
    cap = tcore.buffer_cap(cfg.max_iter)

    def bad_step(state, reg):
        new, stats = step(state, reg)
        return new, stats._replace(bad=torch.ones((), dtype=torch.bool))

    out = tcore.fused_body(carry, bad_step, be._params, cfg.max_iter, cfg.max_refactor,
                           cfg.reg_grow, cap)
    assert int(out[1]) == 0 and int(out[3]) == 1 and int(out[4]) == tcore.STATUS_RUNNING
    assert float(out[2]) == max(float(carry[2]), 1e-12) * cfg.reg_grow
    assert all(torch.equal(a, b) for a, b in zip(out[0], carry[0]))
    stalled = carry[:6] + (torch.tensor(1.0, dtype=torch.float64), torch.tensor(3, dtype=torch.int32))
    assert not bool(tcore.fused_cond(stalled, cfg.max_iter, cap, None, 2, 0.0))
    assert bool(tcore.fused_cond(stalled, cfg.max_iter, cap, None, 2, 10.0))
    assert bool(tcore.fused_cond(stalled, cfg.max_iter, cap, None, 3, 0.0))


def test_classify_divergence_takes_tensors_and_floats():
    cases = [(1e-13, 0.5, 1e-9, 0.1, 1.0, 1.0), (1.0, 1e-9, 0.5, 1.0, -1e9, 0.0),
             (1e-3, 1e-4, 1e-4, 1e-3, 2.0, 2.0)]
    for args in cases:
        want = jcore.classify_divergence(*args)
        got_f = tcore.classify_divergence(*args)
        got_t = tcore.classify_divergence(*(torch.tensor(a, dtype=torch.float64) for a in args))
        assert [bool(v) for v in got_f] == [bool(v) for v in got_t] == [bool(v) for v in want]


def test_host_helpers_match_the_jax_package():
    for mi in (1, 3, 200, 512, 513, 1024, 5000):
        assert tcore.buffer_cap(mi) == jcore.buffer_cap(mi)
    for seg_cfg in (None, 0, 1, 4, 64):
        assert tcore.use_segments(seg_cfg, "cuda") == jcore.use_segments(seg_cfg, "gpu")
        assert tcore.use_segments(seg_cfg, "cpu") == jcore.use_segments(seg_cfg, "cpu")
        for est in (1e-5, 0.01, 0.36, 2.0, 100.0):
            if seg_cfg != 0:
                assert tcore.seg_open(seg_cfg, est) == jcore.seg_open(seg_cfg, est)
    assert not tcore.use_segments(None, "cuda") and tcore.use_segments(3, "cuda")
    assert (tcore.SEG_OPEN_CAP, tcore.SEG_RATE_F32, tcore.SEG_RATE_F64) == (
        jcore.SEG_OPEN_CAP, jcore.SEG_RATE_F32, jcore.SEG_RATE_F64)


def _scripted(asarray, script):
    """``make_run_seg`` over a scripted loop: phase ``p`` exits at
    iteration ``script[p][0]`` with status ``script[p][1]``; ``since``
    counts iterations since the phase began. Records each (bound, stop)."""
    calls = []

    def make_run_seg(bound):
        phase = len({b for b, _ in calls} | {bound}) - 1

        def run_seg(carry, stop):
            calls.append((bound, stop))
            exit_at, final = script[phase]
            it = min(stop, exit_at)
            status = final if it == exit_at else tcore.STATUS_RUNNING
            since = it - (0 if phase == 0 else script[phase - 1][0])
            best = 1.0 / (1 + it)
            new = (carry[0], asarray(it, "int32"), carry[2], carry[3],
                   asarray(status, "int32"), carry[5], asarray(best, "float64"),
                   asarray(since, "int32"))
            return new, np.array([it, status, best, since], dtype=np.float64)

        return run_seg

    return make_run_seg, calls


@pytest.mark.parametrize("script,window", [
    ([(9, tcore.STATUS_OPTIMAL)], 0),  # converges inside the budget
    ([(50, tcore.STATUS_RUNNING)], 0),  # runs out of max_iter
    ([(7, tcore.STATUS_RUNNING)], 5),  # the stall window fires
    ([(7, tcore.STATUS_RUNNING), (12, tcore.STATUS_OPTIMAL)], 5),  # stall, then a second phase
])
def test_drive_phase_plan_and_drive_segments_match_jax_on_a_scripted_run(script, window):
    out = {}
    for name, core, asarray, state in [
        ("jax", jcore, lambda v, t: jnp.asarray(v, getattr(jnp, t)),
         JaxState(*[jnp.zeros(3)] * 5)),
        ("torch", tcore, lambda v, t: torch.tensor(v, dtype=getattr(torch, t)),
         IPMState(*[torch.zeros(3, dtype=torch.float64)] * 5)),
    ]:
        make_run_seg, calls = _scripted(asarray, script)
        phases = [(make_run_seg, window, 0.0, 2) for _ in script]
        report = []
        _, it, status, _, _ = core.drive_phase_plan(
            phases, state, 0.0, 20, 512, np.float64 if name == "jax" else torch.float64,
            report=report)
        out[name] = (int(it), int(np.asarray(status)), calls, [r["iters"] for r in report])
    assert out["torch"] == out["jax"]
