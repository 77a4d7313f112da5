"""Sparse-direct CPU backend for large unstructured LPs.

The port of the JAX package's ``backends/cpu_sparse.py``: the host loop of
:class:`~distributedlpsolver_tpu_torch.backends.cpu.CpuBackend` with the
whole factorization chain sparse — CSR ``A·diag(d)·Aᵀ`` assembly and a
SuperLU factorization of the regularized normal matrix through
``scipy.sparse.linalg.splu`` with COLAMD ordering (SciPy ships no CHOLMOD
binding). ``backends/auto.py`` routes large sparse problems without block
structure here, and the supervisor degrades to it after the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from distributedlpsolver_tpu_torch.backends.base import register_backend
from distributedlpsolver_tpu_torch.backends.cpu import CpuBackend
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.models.problem import InteriorForm


@register_backend("cpu-sparse", "sparse")
class CpuSparseBackend(CpuBackend):
    """Eager sparse-direct execution of the shared IPM core."""

    def setup(self, inf: InteriorForm, config: SolverConfig) -> None:
        if not sp.issparse(inf.A):
            inf = dataclasses.replace(inf, A=sp.csr_matrix(np.asarray(inf.A, dtype=np.float64)))
        super().setup(inf, config)

    def _factorize(self, d: np.ndarray, reg: float):
        A = self._A
        M = sp.csc_matrix((A.multiply(d)) @ A.T)
        M.setdiag(M.diagonal() * (1.0 + reg) + 1e-300)  # keep diagonal structurally present
        try:
            return spla.splu(M, permc_spec="COLAMD")
        except RuntimeError as e:  # singular factor → numerical failure
            raise np.linalg.LinAlgError(str(e)) from e

    def _solve(self, lu, rhs: np.ndarray) -> np.ndarray:
        y = lu.solve(rhs)
        if not np.all(np.isfinite(y)):
            raise np.linalg.LinAlgError("non-finite triangular solve")
        return y
