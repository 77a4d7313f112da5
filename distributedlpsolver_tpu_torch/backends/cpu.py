"""Host/CPU backend (NumPy/SciPy linear algebra, eager).

The port of the JAX package's ``backends/cpu.py``. The reference runs its
algorithm core with ``xp=numpy``; this package's core is torch-only, so
here it runs on CPU tensors in f64, and the linear algebra behind the
core's :class:`~distributedlpsolver_tpu_torch.ipm.core.LinOps` stays the
reference's, on host arrays:

* the matvecs with A (a SciPy CSR matrix kept sparse, or a dense CPU
  tensor);
* the ``_factorize(d, reg)``/``_solve(factors, rhs)`` seam, on host
  arrays — here the normal matrix ``A·diag(d)·Aᵀ`` (sparse inputs
  assembled sparse, only the m×m result densified) and LAPACK's
  Cholesky. The native-kernel and sparse-direct subclasses
  (``cpu_native.py``, ``cpu_sparse.py``) re-point that seam.

Dense products and the Cholesky go through torch's CPU BLAS/LAPACK
(``torch.linalg.cholesky_ex``, ``torch.cholesky_solve``), sparse ones
through SciPy (``scipy.linalg.cho_factor`` on the densified normal
matrix), not through NumPy's BLAS: NumPy's OpenBLAS threads and torch's
OpenMP threads would both spin on the same cores, every iteration
(``scripts/port_time_host_backends.py`` times it).

A failed factorization raises ``numpy.linalg.LinAlgError`` in the seam;
:meth:`CpuBackend.iterate` returns the incoming state with NaN stats and
``bad=True``, and the driver's host loop escalates the regularization
through :meth:`CpuBackend.bump_regularization`, as in the reference.

There is no fused loop (``solve_full`` is the base class's ``None``): the
driver runs its host loop, as it does for the reference's CPU backends.
Host backends run on the CPU whatever device their caller runs on; the
``device`` argument that callers which place every backend pass (the
supervisor's degradation, the service's solo path) is accepted and not
used.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from distributedlpsolver_tpu_torch.backends.base import SolverBackend, register_backend
from distributedlpsolver_tpu_torch.ipm import core
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.ipm.state import IPMState, StepStats
from distributedlpsolver_tpu_torch.models.problem import InteriorForm

_CPU = torch.device("cpu")


def _host(v: torch.Tensor) -> np.ndarray:
    return v.detach().numpy()


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float64)).ravel())


@register_backend("cpu", "numpy", "scipy")
class CpuBackend(SolverBackend):
    """Eager host execution of the shared IPM core."""

    device = _CPU

    def __init__(self, device=None):
        self._reg = 0.0
        self._cfg = None

    # seam for the native-kernel and sparse-direct subclasses ---------------
    def _factorize(self, d: np.ndarray, reg: float):
        A = self._A
        if sp.issparse(A):
            M = np.asarray(((A.multiply(d)) @ A.T).todense())
            M[np.diag_indices_from(M)] *= 1.0 + reg
            return sla.cho_factor(M, lower=True, check_finite=False)
        M = (A * torch.from_numpy(d)) @ A.T
        diag = M.diagonal()
        diag.mul_(1.0 + reg)
        L, info = torch.linalg.cholesky_ex(M)
        if int(info) != 0:
            raise np.linalg.LinAlgError(f"{int(info)}-th leading minor not positive definite")
        return L

    def _solve(self, factors, rhs: np.ndarray) -> np.ndarray:
        if isinstance(factors, torch.Tensor):
            return torch.cholesky_solve(torch.from_numpy(rhs)[:, None], factors)[:, 0].numpy()
        return sla.cho_solve(factors, rhs, check_finite=False)

    # ----------------------------------------------------------------------
    def setup(self, inf: InteriorForm, config: SolverConfig) -> None:
        self._cfg = config
        self._reg = config.reg_dual
        self._params = config.step_params()
        if sp.issparse(inf.A):
            self._A = sp.csr_matrix(inf.A, dtype=np.float64)
        else:
            self._A = torch.from_numpy(np.ascontiguousarray(inf.A, dtype=np.float64))
        self._data = core.make_problem_data(
            np.asarray(inf.c, dtype=np.float64), np.asarray(inf.b, dtype=np.float64),
            np.asarray(inf.u, dtype=np.float64), torch.float64, _CPU,
        )

    def _ops(self) -> core.LinOps:
        A, reg = self._A, self._reg
        if sp.issparse(A):
            matvec = lambda v: _tensor(A @ _host(v))
            rmatvec = lambda v: _tensor(A.T @ _host(v))
        else:
            matvec, rmatvec = (lambda v: A @ v), (lambda v: A.T @ v)
        return core.LinOps(
            matvec=matvec,
            rmatvec=rmatvec,
            factorize=lambda d: self._factorize(_host(d), reg),
            solve=lambda factors, rhs: _tensor(self._solve(factors, _host(rhs))),
        )

    def starting_point(self) -> IPMState:
        return core.starting_point(self._ops(), self._data, self._params)

    def iterate(self, state: IPMState) -> Tuple[IPMState, StepStats]:
        try:
            new_state, stats = core.mehrotra_step(self._ops(), self._data, self._params, state)
        except np.linalg.LinAlgError:
            nan = float("nan")
            return state, StepStats(
                mu=nan, gap=nan, rel_gap=nan, pinf=nan, dinf=nan, pobj=nan,
                dobj=nan, alpha_p=nan, alpha_d=nan, sigma=nan, bad=True,
            )
        host = torch.stack([v.to(torch.float64) for v in stats]).tolist()
        return new_state, StepStats(*host[:-1], bad=bool(host[-1]))

    def bump_regularization(self) -> bool:
        if self._reg * self._cfg.reg_grow > 1e-2:
            return False
        self._reg = max(self._reg, 1e-12) * self._cfg.reg_grow
        return True

    def to_host(self, state: IPMState) -> IPMState:
        return IPMState(*(np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor) else v)
                          for v in state))

    def from_host(self, state: IPMState) -> IPMState:
        return IPMState(*(torch.tensor(np.asarray(v, dtype=np.float64)) for v in state))
