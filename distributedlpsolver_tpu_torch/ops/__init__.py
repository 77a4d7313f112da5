"""Hand-written CUDA kernels for the H100, each beside its plain PyTorch
version (which the wrapper uses for tensors on the CPU)."""

from distributedlpsolver_tpu_torch.ops.normal_eq import (
    normal_eq,
    normal_eq_reference,
)

__all__ = ["normal_eq", "normal_eq_reference"]
