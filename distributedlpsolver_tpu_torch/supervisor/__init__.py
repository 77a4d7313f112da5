"""Fault-tolerant solve supervision (watchdog, rollback, degradation,
elastic mesh recovery).

Public surface: :func:`supervised_solve` wraps ``ipm.solve`` with the
recovery ladder; :class:`SupervisorConfig` tunes it; :class:`SolveFailure`
is the structured terminal failure; :class:`AdaptiveDeadline` sizes
watchdog deadlines from the trailing median step time; ``faults`` provides
the deterministic injection harness (hangs, NaNs, crashes, device loss)
that makes every recovery path CPU-testable. The mesh-shrink rung
re-forms a backend's mesh over the survivors (``parallel.mesh.
reform_mesh``) and re-places it there (``reshard``: ``sharded``,
``sparse-iterative`` and ``block`` on a mesh); the shard-loss injections
name mesh members (``parallel.runtime``).
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
    ShrunkOut,
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
    "ShrunkOut",
    "SolveFailure",
    "StepDeadlineExceeded",
    "SupervisorConfig",
    "run_with_deadline",
    "supervised_solve",
]
