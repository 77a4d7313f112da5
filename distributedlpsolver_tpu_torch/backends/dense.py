"""Dense single-device torch backend — the port's main execution path.

The port of the JAX package's ``backends/dense.py::DenseJaxBackend``
(single device, direct factorization). The constraint matrix lives in
device memory; each IPM iteration queues, on one device:

* the normal-equations assembly ``M = A·diag(d)·Aᵀ`` through the CUDA
  kernel of ``ops/normal_eq.py`` (its plain version on the CPU),
* the regularized Cholesky ``torch.linalg.cholesky_ex`` and the solves
  ``torch.cholesky_solve`` (plus ``refine_steps`` rounds of
  normal-equations refinement),
* GEMVs with A and Aᵀ (``A @ v``, ``A.T @ y``), which the JAX package
  also leaves to its compiler outside any kernel,

and reads nothing on the host (the host loop copies the convergence
scalars back in one transfer per iteration).

The H100 has native FP64, so ``factor_dtype="auto"`` resolves to the
iterate dtype (f64) and there is no two-phase schedule
(``SolverConfig.two_phase_enabled("cuda")`` is False). A precast copy of
A is kept only when ``factor_dtype`` differs from ``dtype``; the
assembly then runs in ``factor_dtype`` on that copy.

The fused loop is the default path (``solve_full``, as in the JAX
package): one masked Mehrotra iteration (``core.fused_body``) run by
``ipm/device_loop.py``, on the card as a captured CUDA graph replayed by
the host, with the regularization a device scalar of the loop's carry.
``segment_iters > 0`` cuts it into host-driven segments
(``core.drive_phase_plan``); ``fused_loop=False`` runs the driver's host
loop over :meth:`DenseTorchBackend.iterate`, whose regularization is a
host float escalated by :meth:`~DenseTorchBackend.bump_regularization`.

Placement seams (``pad_multiple``, ``shardings``): the variable axis is
padded to a multiple of :meth:`DenseTorchBackend.pad_multiple` with zero
columns (cost 1, unbounded) and A is placed by :meth:`shardings`, both
as in the JAX package; ``backends/sharded.py`` overrides them (and the
step's ``LinOps``) to split A's columns over a process-group mesh.

Not ported yet: the two-phase and PCG schedules, the primal-row closure
and the dense endgame.

Failure semantics: ``torch.linalg.cholesky`` raises on a matrix that is
not positive definite, where the JAX package's Cholesky returns NaN. The
factorization here uses ``cholesky_ex`` and turns ``info != 0`` into a
NaN factor on the device, so the step's finite check flags the step as
bad and the loop (fused or host) escalates the regularization exactly as
in the reference.
"""

from __future__ import annotations

import functools
import time
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from distributedlpsolver_tpu_torch.backends.base import SolverBackend, register_backend
from distributedlpsolver_tpu_torch.ipm import core
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.ipm.state import IPMState, StepStats
from distributedlpsolver_tpu_torch.models.problem import InteriorForm
from distributedlpsolver_tpu_torch.ops.normal_eq import normal_eq

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the first CUDA card unless the
    caller names another. Raises when CUDA is asked for (or left to the
    default) and there is no card — there is no CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", 0)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _mode(factor_dtype) -> str:
    """A phase's mode name in ``phase_report`` (the JAX package's)."""
    return "f32" if factor_dtype == torch.float32 else "f64"


def _torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r} is not supported (float64 or float32)")
    return _DTYPES[name]


def _cholesky_ops(A, factor_dtype, refine_steps, Af=None, tri_solves=False, assemble=None):
    """Build factorize/solve closures over the matrix ``A``.

    ``factorize(d, reg)`` returns ``(L, M)`` with ``M = A·diag(d)·Aᵀ``
    plus a per-row relative diagonal perturbation and ``L`` its Cholesky
    factor in ``factor_dtype``. With ``Af`` (the precast copy, present
    only when ``factor_dtype`` differs from A's dtype) the assembly runs
    on it in ``factor_dtype``.

    A solve is ``torch.cholesky_solve``, or with ``tri_solves`` two
    ``torch.linalg.solve_triangular`` (the JAX package's ``cho_solve``).
    The batched solver takes the second under ``torch.func.vmap``: on a
    card the batched ``cholesky_solve`` goes to MAGMA's
    ``dpotrs_batched``, which allocates device memory on every call and so
    cannot be captured into a CUDA graph; the batched triangular solves
    (cuBLAS ``trsmBatched``) can (``scripts/port_probe_batched_linalg.py``).

    ``assemble(src, d)`` computes ``M`` from the assembly matrix and d in
    its dtype (default: K1 on all of it; the sharded backend sums each
    rank's column block over the mesh).
    """
    assemble = assemble or normal_eq

    def factorize(d, reg):
        src = A if Af is None else Af
        M = assemble(src, d.to(src.dtype))
        # Per-row *relative* diagonal perturbation (in place: at the
        # reference shape M is 0.8 GB, and M + diag(·) would copy it).
        diag = M.diagonal()
        diag.add_(diag * reg)
        L, info = torch.linalg.cholesky_ex(M if M.dtype == factor_dtype else M.to(factor_dtype))
        # A failed factorization becomes a NaN factor on the device (no
        # host sync), as the JAX package's Cholesky reports it.
        L = torch.where(info == 0, L, float("nan"))
        if refine_steps and M.dtype != A.dtype:
            M = M.to(A.dtype)  # refinement residuals at iterate precision
        return L, M

    def _apply_inv(L, rhs):
        r = rhs.to(factor_dtype)[:, None]
        if tri_solves:
            y = torch.linalg.solve_triangular(L, r, upper=False)
            out = torch.linalg.solve_triangular(L.mT, y, upper=True)
        else:
            out = torch.cholesky_solve(r, L, upper=False)
        return out[:, 0].to(rhs.dtype)

    def solve(factors, rhs):
        L, M = factors
        y = _apply_inv(L, rhs)
        for _ in range(refine_steps):
            y = y + _apply_inv(L, rhs - M @ y)
        return y

    return factorize, solve


def _make_ops(A, reg, factor_dtype, refine_steps, Af=None, tri_solves=False) -> core.LinOps:
    """The step's linear algebra at regularization ``reg``: a host float
    (the host loop) or a device scalar (the fused loop, or one lane of the
    batched solver's)."""
    factorize, solve = _cholesky_ops(A, factor_dtype, refine_steps, Af, tri_solves)
    return core.LinOps(
        matvec=lambda v: A @ v,
        rmatvec=lambda v: A.T @ v,
        factorize=functools.partial(factorize, reg=reg),
        solve=solve,
    )


def _dense_solve_full(
    step, state0, reg0, params, max_iter, max_refactor, reg_grow, buf_cap,
    stall_window=0, report=None, capture=True,
):
    """The whole solve as one fused loop (the JAX package's
    ``_dense_solve_full``) over ``step`` (:meth:`DenseTorchBackend._step`). Returns
    ``(state, it, status, buf)`` on the device; ``report`` gets the
    loop's body counts."""
    return core.fused_solve(
        step, state0, reg0, params, max_iter, max_refactor, reg_grow, buf_cap,
        stall_window=stall_window, stall_patience_floor=1e3 * params.tol,
        report=report, capture=capture,
    )


def _dense_loop(step, params, buf_cap, device, dtype, stall_window=0, patience=0.0,
                capture=True):
    """One phase's fused loop, captured once and replayed by every
    segment of the phase (see :func:`_dense_segment`)."""
    return core.fused_loop(
        step, params, buf_cap, device, dtype, stall_window=stall_window,
        stall_patience_floor=patience, capture=capture,
    )


def _dense_segment(loop, carry, it_stop, max_iter, max_refactor, reg_grow):
    """One bounded continuation of the fused loop (the JAX package's
    ``_dense_segment``): ``carry`` is the raw loop carry, ``max_iter``
    the phase's global iteration bound. Returns ``(carry, meta)``, the
    meta ``[it, status, best_err, since]`` on the host."""
    return loop.run(carry, max_iter=max_iter, it_stop=it_stop,
                    max_refactor=max_refactor, reg_grow=reg_grow)


@register_backend("cuda", "dense", "torch")
class DenseTorchBackend(SolverBackend):
    """Single-device dense path on one CUDA card (or the CPU when asked
    for with ``device="cpu"``). Subclasses override :meth:`shardings`,
    :meth:`pad_multiple` and :meth:`_make_linops` to distribute the same
    step over a mesh."""

    # Whether the fused loop may capture its body into a CUDA graph (see
    # ``ipm/device_loop.py``), and why not when it may not.
    capture: bool = True
    capture_off_reason: Optional[str] = None

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._reg: float = 0.0
        self._cfg: Optional[SolverConfig] = None
        self._n_orig: Optional[int] = None  # the unpadded column count (setup)

    # -- placement hooks (overridden by the sharded backend) ---------------
    def shardings(self, m: int, n: int):
        """``(matrix_sharding, col_vec_sharding, row_vec_sharding)``
        (``parallel.mesh.Sharding``), or Nones for single-device
        placement."""
        return None, None, None

    def pad_multiple(self) -> int:
        """The column count is padded to a multiple of this (sharded
        backends need the variable axis divisible by the mesh)."""
        return 1

    def _make_linops(self, reg, factor_dtype, refine, Af) -> core.LinOps:
        """The step's linear algebra at regularization ``reg``."""
        return _make_ops(self._A, reg, factor_dtype, refine, Af)

    # -- SolverBackend ------------------------------------------------------
    def setup(self, inf: InteriorForm, config: SolverConfig) -> None:
        if config.solve_mode == "pcg":
            raise NotImplementedError("solve_mode='pcg' is not ported to the torch package yet")
        self._cfg = config
        self._reg = config.reg_dual
        dtype = _torch_dtype(config.dtype)
        self._factor_dtype = _torch_dtype(config.factor_dtype_resolved())
        self._refine = config.refine_steps
        self._dtype = dtype
        if self.device.type == "cuda":
            # Library matmuls in true fp32, never TF32 (~1e-3 relative
            # error), for the f32 configurations.
            torch.backends.cuda.matmul.allow_tf32 = False

        A_host = inf.A.toarray() if sp.issparse(inf.A) else np.asarray(inf.A)
        m, n = A_host.shape
        c_host = np.asarray(inf.c, dtype=np.float64)
        u_host = np.asarray(inf.u, dtype=np.float64)
        self._n_orig = n
        # Pad the variable axis to the mesh multiple with zero columns
        # (cost 1, unbounded): they stay centered at x≈target, never bind,
        # and are sliced off in to_host.
        n_extra = (-n) % self.pad_multiple()
        if n_extra:
            A_host = np.hstack([A_host, np.zeros((m, n_extra))])
            c_host = np.concatenate([c_host, np.ones(n_extra)])
            u_host = np.concatenate([u_host, np.full(n_extra, np.inf)])
            n += n_extra
        self._shape = (m, n)
        mat_s, col_s, _ = self.shardings(m, n)
        if mat_s is not None:
            A_host = mat_s.local(A_host)
        if col_s is not None and col_s.axis is not None:
            raise NotImplementedError("column-sharded vectors: the port keeps them replicated")
        dev = self.device
        self._A = torch.as_tensor(A_host, dtype=dtype, device=dev).contiguous()
        self._Af = (
            self._A.to(self._factor_dtype) if self._factor_dtype != dtype else None
        )
        self._data = core.make_problem_data(c_host, np.asarray(inf.b, dtype=np.float64),
                                            u_host, dtype, dev)
        self._params = config.step_params()

    def _ops(self) -> core.LinOps:
        return self._make_linops(self._reg, self._factor_dtype, self._refine, self._Af)

    def _step(self, params, factor_dtype, refine, Af):
        """``(state, reg) -> (state', stats)``: one Mehrotra step over this
        backend's ``LinOps``, the fused loop's ``step_fn``."""
        def step(state, reg):
            ops = self._make_linops(reg, factor_dtype, refine, Af)
            return core.mehrotra_step(ops, self._data, params, state)

        return step

    def starting_point(self) -> IPMState:
        return core.starting_point(self._ops(), self._data, self._params)

    def _phase_plan(self):
        """Per-phase specs of the fused solve: ``(params, factor_dtype,
        refine_steps, Af, stall_window, stall_patience_floor)``. One
        phase: the two-phase and PCG plans are not ported."""
        cfg = self._cfg
        w = cfg.stall_window
        # The only phase gets the JAX package's final-phase stall
        # semantics: window 2·w with the near-tol patience floor.
        return [
            (self._params, self._factor_dtype, self._refine, self._Af,
             2 * w if w else 0, 1e3 * cfg.tol)
        ]

    def _reg0(self) -> torch.Tensor:
        return torch.full((), self._reg, dtype=self._dtype, device=self.device)

    def _solve_segmented(self, state: IPMState):
        """Host-driven segmented fused solve: the phase plan feeds the
        shared driver (``core.drive_phase_plan``). Each phase captures its
        loop once; every segment of the phase replays it."""
        cfg = self._cfg
        buf_cap = core.buffer_cap(cfg.max_iter)
        m, n = self._shape
        flops = 2.0 * m * m * n + m**3 / 3.0  # per-iteration FLOP estimate
        loops = []

        def make_phase(spec):
            params, fdt, refine, Af, window, patience = spec
            rate = core.SEG_RATE_F32 if fdt == torch.float32 else core.SEG_RATE_F64

            def make_run_seg(bound):
                loop = _dense_loop(self._step(params, fdt, refine, Af), params, buf_cap,
                                   self._A.device, self._A.dtype, window, patience,
                                   capture=self.capture)
                loops.append(loop)

                def run_seg(c, stop):
                    return _dense_segment(loop, c, stop, bound, cfg.max_refactor,
                                          cfg.reg_grow)

                return run_seg

            return (make_run_seg, window, patience, core.seg_open(cfg.segment_iters, flops / rate))

        plan = self._phase_plan()
        self.phase_report = []
        try:
            st, it, status, buf, _ = core.drive_phase_plan(
                [make_phase(s) for s in plan], state, self._reg0(),
                cfg.max_iter, buf_cap, self._dtype, report=self.phase_report,
            )
            for row, spec, loop in zip(self.phase_report, plan, loops):
                row.update(mode=_mode(spec[1]), **loop.report())
        finally:
            for loop in loops:
                loop.close()
        return st, it, status, buf

    def solve_full(self, state: IPMState):
        """The fused loop from ``state``: host-segmented when
        ``segment_iters > 0``, else one run. Returns ``(state, it,
        status, buf)``, the last three on the host; ``self.phase_report``
        gets one row per phase with the JAX package's keys (``phase``,
        ``iters``, ``wall_s``, ``mode``) plus ``bad_steps`` and the
        loop's report (``DeviceLoop.report``): each body launches K1
        once, so K1 runs ``1 + bodies`` times a solve."""
        cfg = self._cfg
        if core.use_segments(cfg.segment_iters, self.device.type):
            st, it, status, buf = self._solve_segmented(state)
        else:
            (params, fdt, refine, Af, window, _), = self._phase_plan()
            loop = {}
            t0 = time.perf_counter()
            st, it, status, buf = _dense_solve_full(
                self._step(params, fdt, refine, Af), state, self._reg0(), params,
                cfg.max_iter, cfg.max_refactor, cfg.reg_grow,
                core.buffer_cap(cfg.max_iter), window, report=loop, capture=self.capture,
            )
            it = int(it)
            self.phase_report = [{
                "phase": 0, "iters": it, "wall_s": round(time.perf_counter() - t0, 3),
                "mode": _mode(fdt), **loop,
            }]
        if self.device.type == "cuda":
            for row in self.phase_report:
                row.update(captured=self.capture, capture_off_reason=self.capture_off_reason)
        return st, torch.tensor(int(it)), status.cpu(), buf.cpu()

    def iterate(self, state: IPMState) -> Tuple[IPMState, StepStats]:
        new_state, stats = core.mehrotra_step(self._ops(), self._data, self._params, state)
        # One device→host copy of every scalar per iteration: the host loop
        # reads them all, and ten .item() calls would be ten syncs.
        host = torch.stack([v.to(self._dtype) for v in stats]).cpu().tolist()
        return new_state, StepStats(*host[:-1], bad=bool(host[-1]))

    def bump_regularization(self) -> bool:
        if self._reg * self._cfg.reg_grow > 1e-2:
            return False
        self._reg = max(self._reg, 1e-12) * self._cfg.reg_grow
        return True

    def to_host(self, state: IPMState) -> IPMState:
        n = self._n_orig
        x, y, s, w, z = (v.detach().cpu().numpy() for v in state)
        return IPMState(x=x[:n], y=y, s=s[:n], w=w[:n], z=z[:n])

    def from_host(self, state: IPMState) -> IPMState:
        n_extra = self._shape[1] - self._n_orig
        x, y, s, w, z = (np.asarray(v, dtype=np.float64) for v in state)
        if n_extra:
            # Padded columns (cost 1, zero A column): re-enter centered.
            x = np.concatenate([x, np.full(n_extra, 1e-8)])
            s = np.concatenate([s, np.ones(n_extra)])
            w = np.concatenate([w, np.ones(n_extra)])
            z = np.concatenate([z, np.zeros(n_extra)])
        return IPMState(
            *(torch.tensor(v, dtype=self._dtype, device=self.device) for v in (x, y, s, w, z))
        )

    def block_until_ready(self, obj) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
