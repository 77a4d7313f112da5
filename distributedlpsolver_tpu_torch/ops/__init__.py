"""Hand-written CUDA kernels for the H100, each beside its plain PyTorch
version (which the wrapper uses for tensors on the CPU)."""

from distributedlpsolver_tpu_torch.ops.ell_spmv import (
    ell_normal_diag,
    ell_spmv,
)
from distributedlpsolver_tpu_torch.ops.kernel_build import KernelError
from distributedlpsolver_tpu_torch.ops.normal_eq import (
    normal_eq,
    normal_eq_reference,
)


__all__ = ["KernelError", "ell_normal_diag", "ell_spmv", "normal_eq", "normal_eq_reference"]
