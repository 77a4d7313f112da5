"""The torch package's solve supervisor against the JAX package's, on the
CPU: the watchdog, the recovery ladder (rollback, regularization bump,
re-center), retries and backoff, terminal answers, the fault injector,
and the degradation chain — where a fault that outlives its ladder on a
backend placed on the CPU degrades to ``sparse-iterative`` (the JAX
package's next rung), then ``cpu-sparse`` and ``cpu``, and the result
names the rung, while on the card it never reaches a CPU rung: a kernel
that fails to build propagates its own error, a lost card ends in
``SolveFailure``.

Each recovery case runs the same injection plan through both packages
(the JAX side on its dense backend, on the CPU) and compares statuses,
the fault kinds and actions, and objectives (1e-6 relative, as the JAX
package's own supervisor tests hold a rolled-back solve).
"""

import importlib
import time

import numpy as np
import pytest
import torch

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

# The module (the package's ``ops.normal_eq`` attribute is the function).
ne = importlib.import_module("distributedlpsolver_tpu_torch.ops.normal_eq")

_PROBLEM = dict(m=20, n=45, seed=3)


def _backend():
    return get_backend("cuda", device="cpu")


def _sup(**kw):
    kw.setdefault("backoff_base", 0.001)
    return SupervisorConfig(**kw)


def _both(plan_kw, sup_kw=None, jax_backend="tpu", **solve_kw):
    """The same plan through both supervisors: (port outcome, JAX
    outcome), each a result or the SolveFailure raised. The port starts
    on ``cuda`` (on the CPU), the JAX package on ``jax_backend``."""
    out = []
    for pkg, backend, problem in (
        ("port", _backend(), random_dense_lp(**_PROBLEM)),
        ("jax", jax_backend, jgen.random_dense_lp(**_PROBLEM)),
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
    ([("NUMERICAL", {"iteration": 4, "times": 4})],
     ["rollback", "rollback+reg_bump", "recenter", "degrade:sparse-iterative"]),
])
def test_ladder_matches_the_jax_supervisor(plan, actions):
    """The ladders agree rung for rung. The case that outlives the ladder
    degrades from ``cuda`` (the JAX package's ``tpu``) to the next rung of
    both chains, ``sparse-iterative`` (on the CPU here)."""
    degrades = actions[-1].startswith("degrade")
    rt, rj = _both(plan)
    assert rt.status.value == rj.status.value == "optimal"
    assert [f.action for f in rt.faults] == [f.action for f in rj.faults] == actions
    assert [f.kind.value for f in rt.faults] == [f.kind.value for f in rj.faults]
    assert [f.iteration for f in rt.faults] == [f.iteration for f in rj.faults]
    assert abs(rt.objective - rj.objective) <= 1e-6 * (1 + abs(rj.objective))
    if degrades:
        assert rt.backend == rj.backend == "sparse-iterative"


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


def _on_the_card(setup):
    """The ``cuda`` backend as the supervisor sees it on a card, its device
    a CUDA one, with ``setup`` in place of its own (this package's tests
    run without a card)."""
    be = _backend()
    be.device = torch.device("cuda")
    be.setup = setup
    return be


def test_a_fault_on_cuda_ends_in_solve_failure_not_a_cpu_solve(monkeypatch, tmp_path):
    """A K1 that fails to build on the card is not a fault another backend
    could recover from: the loader's ``KernelError`` propagates from the
    supervisor as it is, with no retry and no degradation — neither to
    ``sparse-iterative``, the card's next rung, nor to a CPU rung."""
    def no_nvcc():
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
                           "kernel of ops/normal_eq.py cannot be built")

    calls = []

    def setup(inf, config):
        calls.append(1)
        ne.load_library()

    monkeypatch.setattr(ne, "_lib", None)
    monkeypatch.setattr(ne, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(ne, "_nvcc", no_nvcc)
    assert sup_mod._next_backend("cuda", [], on_host=False) == "sparse-iterative"
    with pytest.raises(ne.KernelError, match="nvcc not found") as ei:
        supervised_solve(random_dense_lp(**_PROBLEM), backend=_on_the_card(setup),
                         supervisor=_sup(max_retries=20))
    assert not isinstance(ei.value, SolveFailure) and calls == [1]


def test_a_lost_card_ends_in_solve_failure_at_once():
    """A lost device does not come back on retry and, on the card, has no
    rung to degrade to: the first fault gives up."""
    def setup(inf, config):
        raise RuntimeError("normal_eq kernel launch failed: the device is lost")

    with pytest.raises(SolveFailure) as ei:
        supervised_solve(random_dense_lp(**_PROBLEM), backend=_on_the_card(setup),
                         supervisor=_sup(max_retries=20))
    assert [(f.kind, f.action) for f in ei.value.faults] == [(FaultKind.DEVICE_LOST, "give_up")]


def test_a_fault_on_a_cpu_placed_backend_degrades_to_cpu_sparse_then_cpu(reference_result):
    """On a backend the caller placed on the CPU, a fault that outlives the
    ``cuda`` ladder degrades as the JAX package's does, rung by rung:
    ``sparse-iterative`` (on the CPU too), then ``cpu-sparse``. The
    degradation is in the fault history and in the result's backend name;
    a crash that follows every rung ends in SolveFailure after
    ``sparse-iterative``, ``cpu-sparse`` and ``cpu``."""
    from distributedlpsolver_tpu.backends.auto import degradation_chain as jax_chain

    assert sup_mod.degradation_chain("cuda") == jax_chain("tpu") == [
        "sparse-iterative", "cpu-sparse", "cpu"]
    assert sup_mod.degradation_chain("dense") == sup_mod.degradation_chain("cuda")
    assert sup_mod._next_backend("cuda", []) == "sparse-iterative"
    ladder = ["rollback", "rollback+reg_bump", "recenter"]
    plan = [InjectedFault(FaultKind.CRASH, iteration=1, times=None, backend=b)
            for b in ("cuda", "sparse-iterative")]
    r = supervised_solve(random_dense_lp(**_PROBLEM), backend=_backend(),
                         supervisor=_sup(fault_plan=plan, max_retries=20))
    assert r.status == Status.OPTIMAL and r.backend == "cpu-sparse"
    assert [f.action for f in r.faults] == (
        ladder + ["degrade:sparse-iterative"] + ladder + ["degrade:cpu-sparse"])
    assert [f.backend for f in r.faults[::4]] == ["cuda", "sparse-iterative"]
    np.testing.assert_allclose(r.objective, reference_result.objective, rtol=1e-6)
    plan = [InjectedFault(FaultKind.CRASH, iteration=1, times=None)]
    with pytest.raises(SolveFailure) as ei:
        supervised_solve(random_dense_lp(**_PROBLEM), backend=_backend(),
                         supervisor=_sup(fault_plan=plan, max_retries=20))
    actions = [f.action for f in ei.value.faults]
    assert actions == (ladder + ["degrade:sparse-iterative"] + ladder + ["degrade:cpu-sparse"]
                       + ladder + ["degrade:cpu"] + ladder + ["give_up"])
    assert [f.backend for f in ei.value.faults[::4]] == [
        "cuda", "sparse-iterative", "cpu-sparse", "cpu"]


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
