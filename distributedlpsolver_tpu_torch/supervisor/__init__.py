"""Fault-tolerant solve supervision (watchdog, rollback, degradation,
elastic mesh recovery).

Public surface: :func:`supervised_solve` wraps ``ipm.solve`` with the
recovery ladder; :class:`SupervisorConfig` tunes it; :class:`SolveFailure`
is the structured terminal failure; :class:`AdaptiveDeadline` sizes
watchdog deadlines from the trailing median step time; ``faults`` provides
the deterministic injection harness (hangs, NaNs, crashes, device loss)
that makes every recovery path CPU-testable. In the torch package the
mesh-shrink rung and the shard-loss injections raise
``NotImplementedError`` until the mesh is ported (ROADMAP Queue 1 item
13).
"""

from distributedlpsolver_tpu_torch.ipm.state import FaultKind, FaultRecord
from distributedlpsolver_tpu_torch.supervisor.adaptive import AdaptiveDeadline
from distributedlpsolver_tpu_torch.supervisor.faults import (
    FaultInjector,
    InjectedCrash,
    InjectedDeviceLoss,
    InjectedFault,
)
from distributedlpsolver_tpu_torch.supervisor.supervisor import (
    IterateHealthFault,
    SolveFailure,
    SupervisorConfig,
    supervised_solve,
)
from distributedlpsolver_tpu_torch.supervisor.watchdog import (
    StepDeadlineExceeded,
    run_with_deadline,
)

__all__ = [
    "AdaptiveDeadline",
    "FaultInjector",
    "FaultKind",
    "FaultRecord",
    "InjectedCrash",
    "InjectedDeviceLoss",
    "InjectedFault",
    "IterateHealthFault",
    "SolveFailure",
    "StepDeadlineExceeded",
    "SupervisorConfig",
    "run_with_deadline",
    "supervised_solve",
]
