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

``schedule_platform="tpu"`` is a parity seam, not a feature: it makes
the backend take every schedule decision that the JAX package takes from
``jax.default_backend()`` as that package does on a TPU, so that its
default TPU schedule can be run here and held to the reference (the JAX
package's tests force the same gate). Those decisions are the two-phase
schedule (``factor_dtype="auto"``), auto segmentation
(``segment_iters=None``) and auto PCG (``solve_mode=None`` at
``m·n ≥ _PCG_AUTO_ENTRIES`` inside the two-phase schedule). The
two-phase schedule (the reference's ``_dense_solve_two_phase`` and its
phase plans) runs phase 1 with f32 factorizations, K1 in f32 on a lazy
f32 copy of A, under a loosened tolerance, then hands the iterate to
full-precision f64 phases: directly (``[f32, f64]``), or through a PCG
phase that stops at ``pcg_handoff_tol`` (``[f32, pcg, f64]``, the
primal-row closure in every phase). The starting point of the direct
plan uses the f32 factorization; the host loop iterates in f64. The
reference's TPU factorization routes (the paneled explicit inverse,
``ops/chol_mxu.py``) are not taken: the factorizations stay cuSOLVER's.

The fused loop is the default path (``solve_full``, as in the JAX
package): one masked Mehrotra iteration (``core.fused_body``) run by
``ipm/device_loop.py``, on the card as a captured CUDA graph replayed by
the host, with the regularization a device scalar of the loop's carry.
``segment_iters > 0`` cuts it into host-driven segments
(``core.drive_phase_plan``); ``fused_loop=False`` runs the driver's host
loop over :meth:`DenseTorchBackend.iterate`, whose regularization is a
host float escalated by :meth:`~DenseTorchBackend.bump_regularization`.

Placement seams (``pad_multiple``, ``shardings``, ``prec_sharding``):
the variable axis is padded to a multiple of
:meth:`DenseTorchBackend.pad_multiple` with zero columns (cost 1,
unbounded) and A is placed by :meth:`shardings` (through ``_place``),
both as in the JAX package; ``prec_sharding`` is None here (one device
holds the PCG preconditioner whole). ``backends/sharded.py`` overrides
them, the step's ``LinOps`` and the closure's factor
(``_ensure_closure``) to split A's columns over a mesh.

``solve_mode="pcg"`` (the JAX package's forced-PCG schedule) replaces
every factorization with a preconditioner and every normal-equations
solve with ``core.pcg_solve`` (:func:`_pcg_ops`): K1 assembles ``M`` in
f32 on a precast copy of A, which is Jacobi-scaled, regularized, factored
in f32 and inverted explicitly; CG then runs in the iterate dtype over
the matrix-free operator ``A·(d∘Aᵀv) + reg·diag(M)∘v`` with two GEMVs of
the inverse as the preconditioner. The assembly, the inverse's build and
application and the operator's products are seams of :func:`_pcg_ops`
(as the assembly is of :func:`_cholesky_ops`, and the products of
:func:`_closure_project`), whose defaults are one device's; the sharded
backend passes its sums over the mesh and ``ops/dist_chol.py``'s column
slabs. The reference builds that inverse in
512-column TRSM panels (``_tri_inv_paneled``) because XLA's one TRSM with
m right-hand sides ran out of TPU memory at m = 10000; here it is one
``torch.linalg.solve_triangular(L, I)``. The starting point, the host
loop and the fused loop run PCG alone; the segmented loop also takes the
primal-row closure (:func:`_closure_factors`: ``G = A·Aᵀ`` through K1
with d = 1, built once per problem, applied with two refinement sweeps),
as only the reference's segmented route does. ``solve_mode=None`` stays
direct: the reference engages PCG only inside its two-phase schedule.

Not ported yet: the dense endgame (ROADMAP item 5b), the reference's
full-precision finish of a PCG plan at ``m·n ≥ _ENDGAME_ENTRIES``.
Under ``schedule_platform="tpu"`` such a plan raises in ``setup``.

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
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from distributedlpsolver_tpu_torch.backends.base import SolverBackend, register_backend
from distributedlpsolver_tpu_torch.ipm import core
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig, StepParams
from distributedlpsolver_tpu_torch.ipm.state import IPMState, StepStats
from distributedlpsolver_tpu_torch.models.problem import InteriorForm
from distributedlpsolver_tpu_torch.ops.normal_eq import normal_eq

_DTYPES = {"float64": torch.float64, "float32": torch.float32}

# m·n from which the reference's solve_mode=None engages PCG inside its
# two-phase schedule (below it the two-phase direct plan wins).
_PCG_AUTO_ENTRIES = 1 << 26
# m·n from which the reference finishes a PCG plan with its host-driven
# endgame instead of a fused f64 phase (not ported: ROADMAP item 5b).
_ENDGAME_ENTRIES = 1 << 28


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


def _jacobi_scaled(M, shift):
    """``(S·M·S + shift·I, s)`` with ``S = diag(s)``, ``s = rsqrt(max(diag
    M, tiny))``, in M's dtype. The scaling leaves a unit diagonal, so a
    relative diagonal shift becomes ``+ shift·I`` exactly."""
    s = torch.rsqrt(M.diagonal().clamp_min(torch.finfo(M.dtype).tiny))
    Ms = M * s[:, None] * s[None, :]
    Ms.diagonal().add_(shift)
    return Ms, s


def _tri_inverse(Ms):
    """``L⁻¹`` of ``chol(Ms)``: Cholesky and the explicit inverse in Ms's
    dtype. A failed factorization gives a NaN inverse on the device."""
    L, info = torch.linalg.cholesky_ex(Ms)
    L = torch.where(info == 0, L, float("nan"))
    eye = torch.eye(Ms.shape[0], dtype=Ms.dtype, device=Ms.device)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def _scaled_inverse(M, shift):
    """``(L⁻¹, s)`` for the Jacobi-scaled ``S·M·S + shift·I``
    (:func:`_jacobi_scaled`, :func:`_tri_inverse`)."""
    Ms, s = _jacobi_scaled(M, shift)
    return _tri_inverse(Ms), s


def _pcg_ops(A, Af, cg_tol, cg_iters, counts=None, assemble=None, invert=None, apply_prec=None,
             matvec=None, rmatvec=None):
    """factorize/solve closures of the PCG mode (the JAX package's
    ``_pcg_ops``).

    ``factorize(d, reg)`` builds only a preconditioner: ``M = Af·diag(d)·Afᵀ``
    through K1 on the f32 copy ``Af``, Jacobi-scaled and shifted by ``reg``
    (:func:`_jacobi_scaled`), then ``L⁻¹`` in f32 (library matmuls in true
    fp32: the backend turns TF32 off on a card), cast to A's dtype once,
    so each application is two exact GEMVs. ``solve`` is
    ``core.pcg_solve`` over the true operator ``A·(d∘Aᵀv) + reg·diag(M)∘v``
    in A's dtype; ``counts`` is its device tally of solves and CG
    iterations.

    The seams are the sharded backend's (``backends/sharded.py``), each
    defaulting to one device's: ``assemble(src, d)`` (K1 on all of
    ``src``), ``invert(Ms, dtype)`` (:func:`_tri_inverse` cast to dtype),
    ``apply_prec(inv, v)`` (``L⁻ᵀ·(L⁻¹·v)``), and the operator's
    ``matvec``/``rmatvec`` (``A @ v``, ``A.T @ y``).
    """
    assemble = assemble or normal_eq
    invert = invert or (lambda Ms, dt: _tri_inverse(Ms).to(dt))
    apply_prec = apply_prec or (lambda Linv, v: Linv.T @ (Linv @ v))
    matvec = matvec or (lambda v: A @ v)
    rmatvec = rmatvec or (lambda y: A.T @ y)

    def factorize(d, reg):
        M = assemble(Af, d.to(Af.dtype))
        Ms, s = _jacobi_scaled(M, reg)
        dt = A.dtype
        return invert(Ms, dt), s.to(dt), M.diagonal().to(dt), d, reg

    def solve(factors, rhs):
        inv, s, diagM, d, reg = factors
        regd = reg * diagM

        def op(v):
            return matvec(d * rmatvec(v)) + regd * v

        def prec(r):
            return s * apply_prec(inv, s * r)

        return core.pcg_solve(op, prec, rhs, cg_tol, cg_iters, counts)

    return factorize, solve


def _closure_factors(A32, assemble=None, n=None):
    """``(L⁻¹, s)`` of the loop-invariant ``G = A·Aᵀ`` in f32 — G through
    K1 with d = 1 (``assemble(A32, ones(n))``, by default K1 on all of
    ``A32``), Jacobi-scaled, shifted by 1e-6 (the reference's
    ``_closure_from_G``). Built once per problem; it powers the
    primal-row closure of :func:`_closure_project`."""
    assemble = assemble or normal_eq
    ones = torch.ones(n or A32.shape[1], dtype=A32.dtype, device=A32.device)
    return _scaled_inverse(assemble(A32, ones), 1e-6)


def _closure_project(A, closure, sweeps, matvec=None, rmatvec=None):
    """The primal-row closure ``rv ↦ Aᵀ·(A·Aᵀ)⁻¹·rv`` (the reference's
    ``pp`` of ``_make_ops``): the f32 factor through its scaling, then
    ``sweeps`` refinement sweeps on the true operator ``A·(Aᵀt)``
    (``matvec``/``rmatvec``: ``A @ v``, ``A.T @ y`` by default; the
    sharded backend's sum over its mesh)."""
    matvec = matvec or (lambda v: A @ v)
    rmatvec = rmatvec or (lambda y: A.T @ y)
    LinvG, sG = closure
    sG = sG.to(A.dtype)

    def prec(r):
        z = LinvG @ (sG * r).to(LinvG.dtype)
        return sG * (LinvG.T @ z).to(sG.dtype)

    def project(rv):
        t = prec(rv)
        for _ in range(sweeps):
            t = t + prec(rv - matvec(rmatvec(t)))
        return rmatvec(t)

    return project


def _make_ops(A, reg, factor_dtype, refine_steps, Af=None, tri_solves=False, cg_iters=0,
              cg_tol=0.0, closure=None, closure_sweeps=0, cg_counts=None) -> core.LinOps:
    """The step's linear algebra at regularization ``reg``: a host float
    (the host loop) or a device scalar (the fused loop, or one lane of the
    batched solver's). ``cg_iters > 0`` takes the PCG ops on ``Af`` (the
    f32 copy); ``closure`` adds the primal-row closure."""
    if cg_iters > 0:
        factorize, solve = _pcg_ops(A, Af, cg_tol, cg_iters, cg_counts)
    else:
        factorize, solve = _cholesky_ops(A, factor_dtype, refine_steps, Af, tri_solves)
    return core.LinOps(
        matvec=lambda v: A @ v,
        rmatvec=lambda v: A.T @ v,
        factorize=functools.partial(factorize, reg=reg),
        solve=solve,
        primal_project=None if closure is None else _closure_project(A, closure, closure_sweeps),
    )


class _Phase(NamedTuple):
    """One phase of the fused solve (the JAX package's phase-plan spec,
    less its TPU placement fields)."""

    params: StepParams
    factor_dtype: torch.dtype
    refine: int
    Af: Optional[torch.Tensor]
    window: int = 0
    patience: float = 0.0
    cg_iters: int = 0
    cg_tol: float = 0.0
    closure: Any = None
    closure_sweeps: int = 0

    @property
    def mode(self) -> str:
        return "pcg" if self.cg_iters else _mode(self.factor_dtype)


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


def _dense_solve_two_phase(
    step32, step64, state0, reg0, params, params_p1, max_iter, max_refactor, reg_grow,
    buf_cap, stall_window, report=None, capture=True,
):
    """The unsegmented two-phase solve (the JAX package's
    ``_dense_solve_two_phase``): two runs of the fused loop over one
    stats buffer and a global iteration count, each loop captured once.

    Phase 1 (``step32``: f32 factorizations on the f32 copy) runs under
    ``params_p1`` with the stall window and no patience, and does not
    finalize; whatever its status, phase 2 (``step64``: the f64 direct
    factorization) re-enters RUNNING from its iterate with a budget of
    ``max_iter`` more iterations, window 2w and the patience floor
    1e3·tol. ``report`` (a list) gets one row per phase."""
    rows = [{}, {}]
    t0 = time.perf_counter()
    st1, it1, status1, buf = core.fused_solve(
        step32, state0, reg0, params_p1, max_iter, max_refactor, reg_grow, buf_cap,
        stall_window=stall_window, finalize=False, report=rows[0], capture=capture,
    )
    it1 = int(it1)  # the loop has ended: its count is read on the host anyway
    t1 = time.perf_counter()
    # Every phase-1 verdict is provisional: phase 2 re-derives it in f64.
    status1 = torch.full_like(status1, core.STATUS_RUNNING)
    out = core.fused_solve(
        step64, st1, reg0, params, it1 + max_iter, max_refactor, reg_grow, buf_cap,
        stall_window=2 * stall_window if stall_window else 0,
        stall_patience_floor=1e3 * params.tol, carry_in=(it1, status1, buf),
        report=rows[1], capture=capture,
    )
    if report is not None:
        walls = (t1 - t0, time.perf_counter() - t1)
        iters = (it1, int(out[1]) - it1)
        for i, (mode, row) in enumerate(zip(("f32", "f64"), rows)):
            report.append({"phase": i, "iters": iters[i], "wall_s": round(walls[i], 3),
                           "mode": mode, **row})
    return out


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

    def __init__(self, device=None, schedule_platform: Optional[str] = None):
        self.device = resolve_device(device)
        if schedule_platform not in (None, "tpu", "cuda", "cpu"):
            raise ValueError(f"schedule_platform must be None, 'tpu', 'cuda' or 'cpu'; "
                             f"got {schedule_platform!r}")
        # The platform whose schedule decisions the backend takes (see the
        # module note): None = the device's own type.
        self.schedule_platform = schedule_platform
        self._reg: float = 0.0
        self._cfg: Optional[SolverConfig] = None
        self._n_orig: Optional[int] = None  # the unpadded column count (setup)
        self._two_phase = False
        self._pcg = False
        self._cg_counts: Optional[torch.Tensor] = None  # PCG mode's device tally

    @property
    def platform(self) -> str:
        """The platform string of the schedule decisions: ``"tpu"`` under
        the parity seam, else the device's type."""
        return self.schedule_platform or self.device.type

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

    def prec_sharding(self):
        """The placement of the PCG preconditioner's factor ``L⁻¹``
        (``parallel.mesh.Sharding``), or None: one device holds it
        whole."""
        return None

    def _place(self, A_host: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """The padded A on the device, cut by :meth:`shardings`' matrix
        sharding (this rank's column block on a mesh)."""
        m, n = A_host.shape
        mat_s, col_s, _ = self.shardings(m, n)
        if mat_s is not None:
            A_host = mat_s.local(A_host)
        if col_s is not None and col_s.axis is not None:
            raise NotImplementedError("column-sharded vectors: the port keeps them replicated")
        return torch.as_tensor(A_host, dtype=dtype, device=self.device).contiguous()

    def _make_linops(self, reg, spec: _Phase) -> core.LinOps:
        """The step's linear algebra at regularization ``reg`` for the
        phase ``spec``."""
        return _make_ops(self._A, reg, spec.factor_dtype, spec.refine, spec.Af,
                         cg_iters=spec.cg_iters, cg_tol=spec.cg_tol, closure=spec.closure,
                         closure_sweeps=spec.closure_sweeps, cg_counts=self._cg_counts)

    # -- SolverBackend ------------------------------------------------------
    def setup(self, inf: InteriorForm, config: SolverConfig) -> None:
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
        dev = self.device
        self._A = self._place(A_host, dtype)
        self._Af = (
            self._A.to(self._factor_dtype) if self._factor_dtype != dtype else None
        )
        # The schedule, resolved as the JAX package resolves it on
        # `platform`: two-phase only for factor_dtype="auto" on a TPU, and
        # PCG when forced or (auto) inside the two-phase schedule from
        # _PCG_AUTO_ENTRIES. The f32 copy of A is made at its first use.
        platform = self.platform
        self._two_phase = config.two_phase_enabled(platform)
        entries = m * n
        if config.solve_mode is None:
            self._pcg = self._two_phase and entries >= _PCG_AUTO_ENTRIES
        else:
            self._pcg = config.solve_mode == "pcg"
        if self._pcg and platform == "tpu" and entries >= _ENDGAME_ENTRIES:
            raise NotImplementedError(
                f"a PCG plan at m·n = {entries:,} ≥ 2²⁸ finishes with the reference's host-driven "
                "dense endgame on a TPU, which is not ported to the torch package yet (ROADMAP "
                "Queue 1 item 5b)"
            )
        self._A32 = None
        self._closure = None
        self._cg_counts = (
            torch.zeros(3, dtype=torch.int64, device=dev) if self._pcg else None
        )
        self._data = core.make_problem_data(c_host, np.asarray(inf.b, dtype=np.float64),
                                            u_host, dtype, dev)
        self._params = config.step_params()

    def _ops(self) -> core.LinOps:
        return self._make_linops(self._reg, self._point_spec())

    def _step(self, spec: _Phase):
        """``(state, reg) -> (state', stats)``: one Mehrotra step over this
        backend's ``LinOps``, the fused loop's ``step_fn``."""
        def step(state, reg):
            return core.mehrotra_step(self._make_linops(reg, spec), self._data, spec.params,
                                      state)

        return step

    def _ensure_A32(self) -> torch.Tensor:
        """The f32 copy of A (of this rank's block on a mesh), made at its
        first use: the f64 host loop of a two-phase schedule never reads
        it."""
        if self._A32 is None:
            self._A32 = self._A.to(torch.float32)
        return self._A32

    def _point_spec(self) -> _Phase:
        """The spec of the per-call entry points (``starting_point``,
        ``iterate``): the PCG ops on the f32 copy in PCG mode, else the
        direct factorization."""
        if self._pcg:
            return _Phase(self._params, torch.float32, 0, self._ensure_A32(),
                          cg_iters=self._cfg.cg_iters, cg_tol=self._cfg.cg_tol)
        return _Phase(self._params, self._factor_dtype, self._refine, self._Af)

    def _start_spec(self) -> _Phase:
        """The starting point's spec: a two-phase direct schedule takes it
        with the f32 factorization on the f32 copy (it is a heuristic, and
        phase 2 repairs f32 error); ``iterate`` keeps :meth:`_point_spec`,
        since the host loop has no second phase."""
        if self._two_phase and not self._pcg:
            return _Phase(self._params, torch.float32, 0, self._ensure_A32())
        return self._point_spec()

    def _ensure_closure(self):
        """The f32 factor of ``G = A·Aᵀ`` for the primal-row closure,
        built at the first segmented PCG solve of a problem."""
        if self._closure is None:
            self._closure = _closure_factors(self._ensure_A32())
        return self._closure

    def starting_point(self) -> IPMState:
        return core.starting_point(self._make_linops(self._reg, self._start_spec()), self._data,
                                   self._params)

    def _phase_plan(self, segmented: bool = True):
        """Per-phase specs of the fused solve (the JAX package's
        ``_phase_plan``). Every final phase has window 2·w and the
        near-tol patience floor 1e3·tol.

        * One phase without the two-phase schedule; in PCG mode the
          segmented route's phase also takes the primal-row closure with
          2 sweeps (the unsegmented route has none, as in the reference).
        * Two-phase direct: f32 under ``phase1_params()`` (window w, no
          patience), then f64.
        * Two-phase PCG (always segmented): f32 with the closure and 0
          sweeps; PCG at max(tol, ``pcg_handoff_tol``) with window
          min(3, w), no patience and 2 sweeps; f64 with 2 sweeps. The
          reference finishes with its endgame instead of the f64 phase
          from ``_ENDGAME_ENTRIES``, where ``setup`` refuses the plan.
        """
        cfg = self._cfg
        w = cfg.stall_window
        final = dict(window=2 * w if w else 0, patience=1e3 * cfg.tol)
        if not self._two_phase:
            spec = self._point_spec()._replace(**final)
            if self._pcg and segmented:
                spec = spec._replace(closure=self._ensure_closure(), closure_sweeps=2)
            return [spec]
        p1 = _Phase(cfg.phase1_params(), torch.float32, 0, self._ensure_A32(), window=w)
        f64 = _Phase(self._params, self._dtype, self._refine, None, **final)
        if not self._pcg:
            return [p1, f64]
        closure = self._ensure_closure()
        params_pcg = cfg.replace(tol=max(cfg.tol, cfg.pcg_handoff_tol)).step_params()
        pcg = _Phase(params_pcg, torch.float32, 0, self._A32, window=min(3, w) if w else 0,
                     cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol, closure=closure, closure_sweeps=2)
        return [p1._replace(closure=closure), pcg,
                f64._replace(closure=closure, closure_sweeps=2)]

    def cg_report(self) -> dict:
        """PCG mode's tally since ``setup``, in one device read: Newton
        solves (a fused body run past the loop's exit counts its solves),
        live CG iterations and masked ones."""
        solves, live, masked = self._cg_counts.tolist() if self._pcg else (0, 0, 0)
        return {"solves": solves, "cg_live": live, "cg_masked": masked}

    def _reg0(self) -> torch.Tensor:
        return torch.full((), self._reg, dtype=self._dtype, device=self.device)

    def _solve_segmented(self, state: IPMState):
        """Host-driven segmented fused solve: the phase plan feeds the
        shared driver (``core.drive_phase_plan``). Each phase captures its
        loop once; every segment of the phase replays it."""
        cfg = self._cfg
        # An explicit segment_iters=0 reaches here on the two-phase PCG
        # route (solve_full): segment sizing treats it as auto.
        seg_cfg = cfg.segment_iters or None
        # Each phase has its own max_iter budget; the buffer covers them all.
        n_phases = 1 + int(self._two_phase) + int(self._pcg)
        buf_cap = core.buffer_cap(n_phases * cfg.max_iter)
        m, n = self._shape
        flops = 2.0 * m * m * n + m**3 / 3.0  # per-iteration FLOP estimate
        loops = []

        def make_phase(spec):
            window, patience = spec.window, spec.patience
            rate = core.SEG_RATE_F32 if spec.factor_dtype == torch.float32 else core.SEG_RATE_F64

            def make_run_seg(bound):
                loop = _dense_loop(self._step(spec), spec.params, buf_cap,
                                   self._A.device, self._A.dtype, window, patience,
                                   capture=self.capture)
                loops.append(loop)

                def run_seg(c, stop):
                    return _dense_segment(loop, c, stop, bound, cfg.max_refactor,
                                          cfg.reg_grow)

                return run_seg

            # A PCG phase opens with one iteration (the reference's rule:
            # the FLOP model cannot see the CG sweeps); drive_segments
            # sizes the rest from measured time.
            seg0 = 1 if spec.cg_iters else core.seg_open(seg_cfg, flops / rate)
            return (make_run_seg, window, patience, seg0)

        plan = self._phase_plan()
        self.phase_report = []
        try:
            st, it, status, buf, _ = core.drive_phase_plan(
                [make_phase(s) for s in plan], state, self._reg0(),
                cfg.max_iter, buf_cap, self._dtype, report=self.phase_report,
            )
            for row, spec, loop in zip(self.phase_report, plan, loops):
                row.update(mode=spec.mode, **loop.report())
        finally:
            for loop in loops:
                loop.close()
        return st, it, status, buf

    def solve_full(self, state: IPMState):
        """The fused loop from ``state`` (the JAX package's routing):
        host-segmented when ``core.use_segments`` says so on the
        schedule's platform, and always for the two-phase PCG plan (only
        the segmented route has its f64 finish); the two-phase direct
        schedule otherwise as :func:`_dense_solve_two_phase`; else one
        run. Returns ``(state, it, status, buf)``, the last three on the
        host; ``self.phase_report`` gets one row per phase with the JAX
        package's keys (``phase``, ``iters``, ``wall_s``, ``mode``) plus
        ``bad_steps`` and the loop's report (``DeviceLoop.report``): each
        body launches K1 once, so K1 runs ``1 + bodies`` times a solve."""
        cfg = self._cfg
        if (core.use_segments(cfg.segment_iters, self.platform)
                or (self._pcg and self._two_phase)):
            st, it, status, buf = self._solve_segmented(state)
        elif self._two_phase:
            p1, p2 = self._phase_plan(segmented=False)
            # This route's phase 1 keys only its tol to the handoff: no
            # μ-vs-pinf floor, unlike phase1_params() of the segmented plan.
            params_p1 = cfg.replace(tol=max(cfg.tol, cfg.phase1_tol)).step_params()
            self.phase_report = []
            st, it, status, buf = _dense_solve_two_phase(
                self._step(p1._replace(params=params_p1)), self._step(p2), state, self._reg0(),
                p2.params, params_p1, cfg.max_iter, cfg.max_refactor, cfg.reg_grow,
                core.buffer_cap(2 * cfg.max_iter), cfg.stall_window, report=self.phase_report,
                capture=self.capture,
            )
        else:
            spec, = self._phase_plan(segmented=False)
            loop = {}
            t0 = time.perf_counter()
            st, it, status, buf = _dense_solve_full(
                self._step(spec), state, self._reg0(), spec.params,
                cfg.max_iter, cfg.max_refactor, cfg.reg_grow,
                core.buffer_cap(cfg.max_iter), spec.window, report=loop, capture=self.capture,
            )
            it = int(it)
            self.phase_report = [{
                "phase": 0, "iters": it, "wall_s": round(time.perf_counter() - t0, 3),
                "mode": spec.mode, **loop,
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
