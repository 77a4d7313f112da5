"""The torch package's solve supervisor against the JAX package's, on the
CPU: the watchdog, the recovery ladder (rollback, regularization bump,
re-center), retries and backoff, terminal answers, the fault injector,
and the degradation chain — where no rung follows ``cuda``, so a fault
that outlives its ladder ends in ``SolveFailure``, never in a CPU solve.

Each recovery case runs the same injection plan through both packages
(the JAX side on its dense backend, on the CPU) and compares statuses,
the fault kinds and actions, and objectives (1e-6 relative, as the JAX
package's own supervisor tests hold a rolled-back solve).
"""

import time

import numpy as np
import pytest

from distributedlpsolver_tpu import supervisor as jsup
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.ipm import Status, solve
from distributedlpsolver_tpu_torch.models.generators import random_dense_lp
from distributedlpsolver_tpu_torch.supervisor import (
    FaultInjector,
    FaultKind,
    InjectedCrash,
    InjectedFault,
    SolveFailure,
    StepDeadlineExceeded,
    SupervisorConfig,
    run_with_deadline,
    supervised_solve,
)
from distributedlpsolver_tpu_torch.supervisor import supervisor as sup_mod

_PROBLEM = dict(m=20, n=45, seed=3)


def _backend():
    return get_backend("cuda", device="cpu")


def _sup(**kw):
    kw.setdefault("backoff_base", 0.001)
    return SupervisorConfig(**kw)


def _both(plan_kw, sup_kw=None, **solve_kw):
    """The same plan through both supervisors: (port outcome, JAX
    outcome), each a result or the SolveFailure raised."""
    out = []
    for pkg, backend, problem in (
        ("port", _backend(), random_dense_lp(**_PROBLEM)),
        ("jax", "tpu", jgen.random_dense_lp(**_PROBLEM)),
    ):
        mod = sup_mod if pkg == "port" else jsup
        plan = [mod.InjectedFault(mod.FaultKind[k], **v) for k, v in plan_kw]
        cfg = mod.SupervisorConfig(backoff_base=0.001, fault_plan=plan, **(sup_kw or {}))
        try:
            out.append(mod.supervised_solve(problem, backend=backend, supervisor=cfg, **solve_kw))
        except (SolveFailure, jsup.SolveFailure) as e:
            out.append(e)
    return out


@pytest.fixture(scope="module")
def reference_result():
    return solve(random_dense_lp(**_PROBLEM), backend=_backend(), fused_loop=False)


class TestWatchdog:
    def test_passthrough_value(self):
        assert run_with_deadline(lambda: 42, 5.0) == 42

    def test_disabled_timeout_direct_call(self):
        assert run_with_deadline(lambda: "x", None) == "x"
        assert run_with_deadline(lambda: "x", 0) == "x"

    def test_exception_reraises_on_caller(self):
        with pytest.raises(ValueError, match="boom"):
            run_with_deadline(lambda: (_ for _ in ()).throw(ValueError("boom")), 5.0)

    def test_deadline_fires_within_2x(self):
        t0 = time.perf_counter()
        with pytest.raises(StepDeadlineExceeded):
            run_with_deadline(lambda: time.sleep(2.0), 0.2, iteration=7)
        assert time.perf_counter() - t0 < 0.4


def test_no_faults_is_passthrough(reference_result):
    r = supervised_solve(random_dense_lp(**_PROBLEM), backend=_backend(), supervisor=_sup())
    assert r.status == Status.OPTIMAL and r.faults == []
    np.testing.assert_allclose(r.objective, reference_result.objective, rtol=1e-8)


@pytest.mark.parametrize("plan, actions", [
    ([("NUMERICAL", {"iteration": 5})], ["rollback"]),
    ([("NUMERICAL", {"iteration": 4, "times": 3})], ["rollback", "rollback+reg_bump", "recenter"]),
])
def test_ladder_matches_the_jax_supervisor(plan, actions):
    rt, rj = _both(plan)
    assert rt.status.value == rj.status.value == "optimal"
    assert [f.action for f in rt.faults] == [f.action for f in rj.faults] == actions
    assert [f.kind.value for f in rt.faults] == [f.kind.value for f in rj.faults]
    assert [f.iteration for f in rt.faults] == [f.iteration for f in rj.faults]
    assert abs(rt.objective - rj.objective) <= 1e-6 * (1 + abs(rj.objective))


def test_hang_watchdog_timeout_then_retry(reference_result):
    deadline = 0.25
    plan = [InjectedFault(FaultKind.HANG, iteration=3, hang_seconds=20 * deadline)]
    t0 = time.perf_counter()
    r = supervised_solve(random_dense_lp(**_PROBLEM), backend=_backend(),
                         supervisor=_sup(fault_plan=plan, step_timeout=deadline))
    assert r.status == Status.OPTIMAL
    assert [f.kind for f in r.faults] == [FaultKind.HANG] and r.faults[0].iteration == 3
    assert time.perf_counter() - t0 < 10 * deadline
    np.testing.assert_allclose(r.objective, reference_result.objective, rtol=1e-6)


def test_retries_exhausted_raises_structured_failure_as_the_jax_one():
    rt, rj = _both([("CRASH", {"iteration": 1, "times": None})], {"max_retries": 3})
    for e in (rt, rj):
        assert isinstance(e, (SolveFailure, jsup.SolveFailure))
        assert e.status.value == "failed" and len(e.faults) == 4
        assert e.faults[-1].action == "give_up" and "InjectedCrash" in e.faults[0].detail
    assert [f.action for f in rt.faults] == [f.action for f in rj.faults]


def test_a_fault_on_cuda_ends_in_solve_failure_not_a_cpu_solve():
    """The JAX package degrades a crashing ``tpu`` backend to
    ``sparse-iterative``; the port registers no rung after ``cuda``, so
    the ladder ends in SolveFailure with no degradation taken."""
    assert sup_mod.degradation_chain("cuda") == ["sparse-iterative", "cpu-sparse", "cpu"]
    assert sup_mod.degradation_chain("dense") == sup_mod.degradation_chain("cuda")
    assert sup_mod._next_backend("cuda", []) is None
    plan = [InjectedFault(FaultKind.CRASH, iteration=1, times=None)]
    with pytest.raises(SolveFailure) as ei:
        supervised_solve(random_dense_lp(**_PROBLEM), backend=_backend(),
                         supervisor=_sup(fault_plan=plan, max_retries=20))
    actions = [f.action for f in ei.value.faults]
    assert actions == ["rollback", "rollback+reg_bump", "recenter", "give_up"]
    assert {f.backend for f in ei.value.faults} == {"cuda"}


def test_ladder_exhausted_without_degradation_raises():
    plan = [InjectedFault(FaultKind.CRASH, iteration=1, times=None)]
    with pytest.raises(SolveFailure) as ei:
        supervised_solve(random_dense_lp(**_PROBLEM), backend=_backend(),
                         supervisor=_sup(fault_plan=plan, max_retries=20, degrade=False))
    assert len(ei.value.faults) == 4 and ei.value.faults[-1].action == "give_up"


def test_terminal_answers_are_not_retried():
    r = supervised_solve(random_dense_lp(**_PROBLEM), backend=_backend(), supervisor=_sup(),
                         max_iter=3)
    assert r.status == Status.ITERATION_LIMIT and r.faults == []


def test_backoff_doubles_per_fault(monkeypatch):
    import types

    slept = []
    # The supervisor module's clock with its sleep recorded (only there).
    monkeypatch.setattr(sup_mod, "time", types.SimpleNamespace(
        time=time.time, perf_counter=time.perf_counter, sleep=slept.append))
    plan = [InjectedFault(FaultKind.NUMERICAL, iteration=2, times=3)]
    supervised_solve(random_dense_lp(**_PROBLEM), backend=_backend(),
                     supervisor=SupervisorConfig(backoff_base=0.01, fault_plan=plan))
    assert slept == pytest.approx([0.01, 0.02, 0.04])


class TestFaultInjector:
    def test_times_budget_persists_across_wraps(self):
        inj = FaultInjector([InjectedFault(FaultKind.CRASH, iteration=2, times=1)])
        ok = lambda: ("state", "stats")
        assert inj.wrap_step(ok, 1, "cuda") is ok
        with pytest.raises(InjectedCrash):
            inj.wrap_step(ok, 2, "cuda")()
        assert inj.wrap_step(ok, 2, "cuda") is ok

    def test_backend_filter(self):
        inj = FaultInjector([InjectedFault(FaultKind.CRASH, iteration=1, backend="cuda")])
        ok = lambda: None
        assert inj.wrap_step(ok, 1, "cpu") is ok
        assert inj.wrap_step(ok, 1, "cuda") is not ok

    @pytest.mark.parametrize("fault", [
        InjectedFault(FaultKind.DEVICE_LOST, iteration=1, device_ids=(3,)),
        InjectedFault(FaultKind.HANG, iteration=1, shard=3),
    ])
    def test_shard_loss_injections_are_refused(self, fault):
        with pytest.raises(NotImplementedError, match="item 13"):
            FaultInjector([fault])
