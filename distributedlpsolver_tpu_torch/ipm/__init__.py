from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.ipm.state import (
    FaultKind,
    FaultRecord,
    IPMResult,
    IPMState,
    IterRecord,
    Status,
    StepStats,
)
from distributedlpsolver_tpu_torch.ipm.driver import SolveHooks, solve

__all__ = [
    "FaultKind",
    "FaultRecord",
    "IPMResult",
    "IPMState",
    "IterRecord",
    "SolveHooks",
    "SolverConfig",
    "Status",
    "StepStats",
    "solve",
]
