"""Execution backends. Importing this package registers the built-ins."""

from distributedlpsolver_tpu_torch.backends.base import (
    SolverBackend,
    available_backends,
    get_backend,
    register_backend,
)
import distributedlpsolver_tpu_torch.backends.dense  # noqa: F401  (registers cuda/dense/torch)

__all__ = ["SolverBackend", "available_backends", "get_backend", "register_backend"]
