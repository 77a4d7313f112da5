"""CPU backend on the native C++ kernels (ctypes → ``native/kernels.cpp``).

The port of the JAX package's ``backends/cpu_native.py``: the same eager
host loop as :class:`~distributedlpsolver_tpu_torch.backends.cpu.CpuBackend`,
with the factorize/solve seam re-pointed at the OpenMP C++ kernels —
normal-equations assembly, blocked Cholesky and the two triangular
solves. ``backends/auto.py`` routes here what it routes on the CPU
(``device="cpu"``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import scipy.sparse as sp

from distributedlpsolver_tpu_torch.backends.base import register_backend
from distributedlpsolver_tpu_torch.backends.cpu import CpuBackend
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.models.problem import InteriorForm
import distributedlpsolver_tpu_torch.native.build as native_build


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


@register_backend("cpu-native", "native")
class CpuNativeBackend(CpuBackend):
    """CpuBackend with the factorize/solve seam re-pointed at C++."""

    def setup(self, inf: InteriorForm, config: SolverConfig) -> None:
        self._lib = native_build.load()  # raises NativeBuildError w/o g++
        super().setup(inf, config)
        # The native assembly wants a dense row-major A.
        A = inf.A.toarray() if sp.issparse(inf.A) else np.asarray(inf.A)
        self._A_dense = np.ascontiguousarray(A, dtype=np.float64)
        m, n = self._A_dense.shape
        self._scratch = np.empty((m, n), dtype=np.float64)
        self._M = np.empty((m, m), dtype=np.float64)

    def _factorize(self, d: np.ndarray, reg: float):
        m, n = self._A_dense.shape
        d = np.ascontiguousarray(d, dtype=np.float64)
        self._lib.dlps_normal_eq(
            _dp(self._A_dense), _dp(d), m, n, float(reg), _dp(self._scratch), _dp(self._M),
        )
        info = self._lib.dlps_cholesky(_dp(self._M), m)
        if info != 0:
            raise np.linalg.LinAlgError(f"native cholesky: pivot {info} <= 0")
        return self._M  # lower factor, in place

    def _solve(self, factors, rhs: np.ndarray) -> np.ndarray:
        m = factors.shape[0]
        rhs = np.ascontiguousarray(rhs, dtype=np.float64)
        out = np.empty(m, dtype=np.float64)
        self._lib.dlps_cho_solve(_dp(factors), _dp(rhs), m, _dp(out))
        return out
