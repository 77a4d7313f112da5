from distributedlpsolver_tpu_torch.utils.checkpoint import (
    CheckpointMismatch,
    load_state,
    maybe_load,
    problem_fingerprint,
    save_state,
)
from distributedlpsolver_tpu_torch.utils.logging import IterLogger

__all__ = [
    "CheckpointMismatch",
    "IterLogger",
    "load_state",
    "maybe_load",
    "problem_fingerprint",
    "save_state",
]
