"""Execution backends. Importing this package registers the built-ins."""

from distributedlpsolver_tpu_torch.backends.base import (
    SolverBackend,
    available_backends,
    get_backend,
    register_backend,
)
import distributedlpsolver_tpu_torch.backends.dense  # noqa: F401  (registers cuda/dense/torch)

__all__ = ["SolverBackend", "available_backends", "get_backend", "register_backend"]
import distributedlpsolver_tpu_torch.backends.cpu  # noqa: F401,E402  (registers cpu/numpy/scipy)
import distributedlpsolver_tpu_torch.backends.cpu_native  # noqa: F401,E402  (registers cpu-native)
import distributedlpsolver_tpu_torch.backends.cpu_sparse  # noqa: F401,E402  (registers cpu-sparse)
import distributedlpsolver_tpu_torch.backends.first_order  # noqa: F401,E402  (registers pdlp/first-order/pdhg)
import distributedlpsolver_tpu_torch.backends.sparse_iterative  # noqa: F401,E402  (registers sparse-iterative/inexact-ipm/sparse-pcg)
import distributedlpsolver_tpu_torch.backends.block_angular  # noqa: F401,E402  (registers block/schur/block-angular)
import distributedlpsolver_tpu_torch.backends.scenario  # noqa: F401,E402  (registers scenario)
import distributedlpsolver_tpu_torch.backends.auto  # noqa: F401,E402  (registers auto)
