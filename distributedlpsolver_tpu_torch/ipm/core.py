"""Mehrotra predictor-corrector step — the algorithm core, on torch tensors.

The port of the JAX package's ``ipm/core.py``. The math is the same line
for line; where the reference writes against a generic array namespace
``xp``, this module uses torch directly: every tensor it creates takes
its dtype and device from an input, scalars are clamped with
``clamp_min``/``clamp_max``, and data-dependent selections stay on the
device (``torch.where``, ``index_select``), so one step queues its work
without a host sync. Backends differ only in the four linear-algebra
callables of :class:`LinOps` — ``matvec``/``rmatvec`` with the constraint
matrix and ``factorize``/``solve`` for the normal equations
``M = A·diag(d)·Aᵀ``.

Problem form handled (ipm/state.py): ``min cᵀx  s.t. Ax=b, 0≤x, x+w=u`` on
the columns with finite upper bound.  Columns without a finite upper bound
carry ``w=1, z=0`` and every ``w``/``z`` term is masked by ``hub``.

Newton system and its elimination to normal equations::

    A dx               = r_p  := b - Ax
    dx + dw            = r_u  := u - x - w          (masked)
    Aᵀdy + ds - dz     = r_d  := c - Aᵀy - s + z
    S dx + X ds        = r_xs := target - x∘s
    Z dw + W dz        = r_wz := target - w∘z       (masked)

    ⇒  dinv = s/x + z/w,  h = r_d - r_xs/x + (r_wz - z∘r_u)/w
       (A·diag(1/dinv)·Aᵀ) dy = r_p + A(h/dinv)
       dx = (Aᵀdy - h)/dinv ;  ds = (r_xs - s∘dx)/x
       dw = r_u - dx ;  dz = (r_wz - z∘dw)/w

The fused loop (:func:`fused_solve`, the host segmentation of
:func:`drive_segments` and :func:`drive_phase_plan`) is here too. Where the
JAX package traces one ``lax.while_loop``, the port splits the loop into
:func:`fused_cond` and a pure, masked :func:`fused_body`, and
``ipm/device_loop.py`` runs the body: eagerly on the CPU, as one captured
CUDA graph replayed by the host on a card.

:func:`pcg_solve` is the reference's CG of the dense PCG mode. Its
``lax.while_loop`` becomes a masked iteration (:func:`_pcg_body`): inside
a CUDA-graph capture all ``max_iter`` iterations run, each a no-op once
the exit test fails, so the graph holds no host read; elsewhere the host
reads the exit flag once per chunk of iterations (``ops/pcg.py``'s
chunks: every iteration on the CPU). Either way x is the early exit's,
bit for bit.

Not ported here (it serves the JAX package's TPU schedules): the df32
``elementwise`` engine.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from distributedlpsolver_tpu_torch.ipm import device_loop
from distributedlpsolver_tpu_torch.ipm.config import StepParams
from distributedlpsolver_tpu_torch.ipm.state import IPMState, StepStats
from distributedlpsolver_tpu_torch.ops import pcg as pcg_ops


class LinOps(NamedTuple):
    """Backend linear-algebra seam (the `SolverBackend` interface's
    execution half)."""

    matvec: Callable[[Any], Any]  # v ↦ A @ v           (n,) → (m,)
    rmatvec: Callable[[Any], Any]  # v ↦ Aᵀ @ v          (m,) → (n,)
    factorize: Callable[[Any], Any]  # d ↦ factors of A·diag(d)·Aᵀ (+ reg)
    solve: Callable[[Any, Any], Any]  # (factors, rhs) ↦ M⁻¹ rhs
    # Optional exact primal-row closure: rv ↦ Aᵀ(A·Aᵀ)⁻¹·rv. When set,
    # each KKT solve corrects its final dx so A·dx equals its target
    # (see the JAX package's core.LinOps). The dense backend's segmented
    # PCG phase sets it.
    primal_project: Any = None


class ProblemData(NamedTuple):
    """Problem vectors as tensors. ``u_f`` is the upper-bound vector with
    +inf replaced by 1.0; ``hub`` the finite-ub mask as 0/1 floats."""

    c: Any  # (n,)
    b: Any  # (m,)
    u_f: Any  # (n,)
    hub: Any  # (n,)
    ncomp: Any  # scalar: n + #finite-ub (complementarity pair count)
    norm_b: Any  # scalar: 1 + ||b||₂
    norm_c: Any  # scalar: 1 + ||c||₂


def make_problem_data(c, b, u, dtype, device) -> ProblemData:
    c = torch.as_tensor(c, dtype=dtype, device=device)
    b = torch.as_tensor(b, dtype=dtype, device=device)
    u = torch.as_tensor(u, dtype=dtype, device=device)
    hub = torch.isfinite(u).to(dtype)
    u_f = torch.where(hub > 0, u, torch.ones_like(u))
    return ProblemData(
        c=c,
        b=b,
        u_f=u_f,
        hub=hub,
        ncomp=c.shape[0] + hub.sum(),
        norm_b=1.0 + torch.linalg.vector_norm(b),
        norm_c=1.0 + torch.linalg.vector_norm(c),
    )


def _solve_kkt_once(ops: LinOps, state: IPMState, hub, d, factors, r_p, r_u,
                    r_d, r_xs, r_wz):
    """Back-substitute one Newton solve through the normal equations."""
    x, y, s, w, z = state
    h = r_d - r_xs / x + (r_wz - z * r_u) / w
    dy = ops.solve(factors, r_p + ops.matvec(d * h))
    dx = d * (ops.rmatvec(dy) - h)
    ds = (r_xs - s * dx) / x
    dw = r_u - dx
    dz = hub * (r_wz - z * dw) / w
    return dx, dy, ds, dw, dz


def _solve_kkt(
    ops: LinOps, state: IPMState, hub, d, factors, r_p, r_u, r_d, r_xs, r_wz,
    refine: int,
):
    """Newton solve + ``refine`` rounds of KKT-level iterative refinement.

    Near convergence the scaling ``d`` spans ~1/μ orders of magnitude and
    the back-substitution ``dx = d·(Aᵀdy - h)`` loses ~μ⁻¹·ε of absolute
    accuracy to cancellation. Re-evaluating the full 5-block KKT residual
    and solving for a correction restores the lost digits at the cost of
    one extra factorization-reuse solve per round.
    """
    x, y, s, w, z = state
    dx, dy, ds, dw, dz = _solve_kkt_once(
        ops, state, hub, d, factors, r_p, r_u, r_d, r_xs, r_wz
    )
    for _ in range(refine):
        e_p = r_p - ops.matvec(dx)
        e_u = hub * (r_u - (dx + dw))
        e_d = r_d - (ops.rmatvec(dy) + ds - dz)
        e_xs = r_xs - (s * dx + x * ds)
        e_wz = hub * (r_wz - (z * dw + w * dz))
        cx, cy, cs, cw, cz = _solve_kkt_once(
            ops, state, hub, d, factors, e_p, e_u, e_d, e_xs, e_wz
        )
        dx, dy, ds, dw, dz = dx + cx, dy + cy, ds + cs, dw + cw, dz + cz
    if ops.primal_project is not None:
        # Exact primal-row closure, applied once on the final direction and
        # not fed back into ds/dz (see the JAX package's core._solve_kkt).
        delta = ops.primal_project(r_p - ops.matvec(dx))
        dx = dx + delta
        dw = dw - hub * delta
    return dx, dy, ds, dw, dz


def _max_step(v, dv, v2, dv2, mask):
    """Largest α ≤ 1 with v+αdv ≥ 0 and (masked) v2+αdv2 ≥ 0 (ratio test,
    kept on the device)."""
    inf = torch.full((), float("inf"), dtype=v.dtype, device=v.device)
    neg1 = dv < 0
    r1 = torch.where(neg1, -v / torch.where(neg1, dv, -1.0), inf)
    neg2 = (dv2 < 0) & (mask > 0)
    r2 = torch.where(neg2, -v2 / torch.where(neg2, dv2, -1.0), inf)
    return torch.minimum(r1.min(), r2.min()).clamp_max(1.0)


def _centrality_backoff(state, hub, dirs, ap_max, ad_max, ncomp, gamma):
    """N₋∞(γ) neighborhood guard: damp the steps until no complementarity
    product falls below γ·μ(α).

    Evaluates a geometric grid of 24 damped (α_p, α_d) candidates at once
    and picks the least-damped admissible one — no data-dependent control
    flow, so no host sync. If the current iterate already sits outside
    N₋∞(γ), the demand relaxes to 0.9× its current centrality ratio (see
    the JAX package's core._centrality_backoff for the observations).
    """
    if gamma <= 0:
        return ap_max, ad_max
    x, y, s, w, z = state
    dx, ds, dw, dz = dirs
    xs0 = x * s
    wz0 = w * z
    mu0 = (xs0.sum() + (wz0 * hub).sum()) / ncomp
    inf0 = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    minprod0 = torch.minimum(xs0.min(), torch.where(hub > 0, wz0, inf0).min())
    ratio0 = minprod0 / mu0.clamp_min(torch.finfo(x.dtype).tiny)
    gamma = torch.where(ratio0 < gamma, 0.9 * ratio0, gamma)
    fac = 0.8 ** torch.arange(24, dtype=x.dtype, device=x.device)
    aps = ap_max * fac
    ads = ad_max * fac
    xs = (x[None, :] + aps[:, None] * dx[None, :]) * (
        s[None, :] + ads[:, None] * ds[None, :]
    )
    wz = (w[None, :] + aps[:, None] * dw[None, :]) * (
        z[None, :] + ads[:, None] * dz[None, :]
    )
    comp = xs.sum(dim=1) + (wz * hub[None, :]).sum(dim=1)
    mu_a = comp / ncomp
    minprod = torch.minimum(
        xs.min(dim=1).values,
        torch.where(hub[None, :] > 0, wz, inf0).min(dim=1).values,
    )
    ok = minprod >= gamma * mu_a
    # Least-damped admissible candidate; fall back to the most damped one.
    idx = torch.argmax(ok.to(torch.int32))
    idx = torch.where(ok.any(), idx, len(fac) - 1).reshape(1)
    return aps.index_select(0, idx)[0], ads.index_select(0, idx)[0]


def _pcg_cond(carry, thresh, max_iter):
    """The reference CG loop's ``cond``; the carry holds ‖r‖ (``rn``)."""
    _, _, _, rz, it, rn = carry
    return (it < max_iter) & (rn > thresh) & torch.isfinite(rz)


def _pcg_body(op, prec, carry, thresh, max_iter):
    """One reference CG iteration, masked by its ``cond``: once the exit
    test fails, the carry comes back bit for bit."""
    go = _pcg_cond(carry, thresh, max_iter)
    x, r, p, rz, it, _ = carry
    Ap = op(p)
    denom = p @ Ap
    alpha = rz / torch.where(denom != 0, denom, 1.0)
    x1 = x + alpha * p
    r1 = r - alpha * Ap
    z = prec(r1)
    rz1 = r1 @ z
    beta = rz1 / torch.where(rz != 0, rz, 1.0)
    new = (x1, r1, z + beta * p, rz1, it + 1, torch.linalg.vector_norm(r1))
    return tuple(torch.where(go, a, b) for a, b in zip(new, carry))


def pcg_solve(op, prec, rhs, tol, max_iter, counts=None):
    """Preconditioned conjugate gradient (the JAX package's
    ``core.pcg_solve``): from zero, until ‖r‖ ≤ ``tol``·‖rhs‖,
    ``max_iter`` iterations or a non-finite ``rz``.

    ``op`` is the full-precision matrix-free normal-equations operator,
    ``prec`` the preconditioner. A non-finite result, or a residual left
    above max(1e-3·‖rhs‖, 10·tol·‖rhs‖), comes back as NaN, so a broken
    (f32-Cholesky) preconditioner reaches the step's finite check and the
    loop's bad-step path as a failed direct solve does.

    ``counts`` (an int64 (3,) device tensor), when given, gets ``[1,
    live, masked]`` added on the device: the solve, the iterations that
    moved the carry and those that ran masked past the exit.
    """
    norm0 = torch.linalg.vector_norm(rhs)
    thresh = tol * norm0
    z0 = prec(rhs)
    it0 = torch.zeros((), dtype=torch.int32, device=rhs.device)
    carry = (torch.zeros_like(rhs), rhs, z0, rhs @ z0, it0, norm0)
    # A graph capture holds every iteration and reads nothing; otherwise
    # the host reads the exit flag between chunks.
    capturing = rhs.is_cuda and torch.cuda.is_current_stream_capturing()
    chunks = pcg_ops._chunks(rhs.device, None)
    ran = 0
    while ran < max_iter:
        n = max_iter - ran if capturing else min(next(chunks), max_iter - ran)
        for _ in range(n):
            carry = _pcg_body(op, prec, carry, thresh, max_iter)
        ran += n
        if not capturing and not bool(_pcg_cond(carry, thresh, max_iter)):
            break
    x, _, _, rz, it, rn = carry
    bad = ~(torch.isfinite(rz) & torch.isfinite(x).all())
    bad = bad | (rn > torch.maximum(1e-3 * norm0, 10.0 * thresh))
    if counts is not None:
        live = it.to(torch.int64)
        counts.add_(torch.stack([torch.ones_like(live), live, ran - live]))
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def residual_norms(ops: LinOps, data: ProblemData, state: IPMState):
    """Relative primal/dual infeasibility, gap, and objectives of a state."""
    x, y, s, w, z = state
    r_p = data.b - ops.matvec(x)
    r_u = data.hub * (data.u_f - x - w)
    r_d = data.c - ops.rmatvec(y) - s + z
    pinf = torch.sqrt(torch.sum(r_p * r_p) + torch.sum(r_u * r_u)) / data.norm_b
    dinf = torch.linalg.vector_norm(r_d) / data.norm_c
    pobj = data.c @ x
    dobj = data.b @ y - (data.hub * data.u_f) @ z
    gap = torch.abs(pobj - dobj)
    rel_gap = gap / (1.0 + torch.abs(pobj))
    mu = (x @ s + (data.hub * w) @ z) / data.ncomp
    return pinf, dinf, gap, rel_gap, pobj, dobj, mu


def scaling_d(state: IPMState, data: ProblemData, cfg: StepParams):
    """The normal-equations diagonal ``d = 1/(s/x + z/w + reg_primal)``."""
    if cfg.elementwise != "native":
        raise NotImplementedError(
            f"elementwise={cfg.elementwise!r}: only the native engine is ported"
        )
    x, y, s, w, z = state
    dinv = s / x + data.hub * z / w + cfg.reg_primal
    return 1.0 / dinv


def mehrotra_step(
    ops: LinOps, data: ProblemData, cfg: StepParams, state: IPMState
):
    """One full predictor-corrector iteration: state ↦ (state', stats).

    Every operation is queued on the state's device; the returned
    :class:`StepStats` fields are 0-dim tensors there (the backend copies
    them to the host in one transfer).
    """
    x, y, s, w, z = state
    hub, u_f, c, b = data.hub, data.u_f, data.c, data.b

    # Residuals of the current iterate.
    r_p = b - ops.matvec(x)
    r_u = hub * (u_f - x - w)
    r_d = c - ops.rmatvec(y) - s + z
    mu = (x @ s + (hub * w) @ z) / data.ncomp

    # Diagonal scaling and one factorization, shared by both solves.
    d = scaling_d(state, data, cfg)
    factors = ops.factorize(d)

    # Aim the centering target at the convergence tolerance, not at zero
    # (0.03·tol keeps a 30× margin below the gap test; see the JAX
    # package's core.mehrotra_step for the observation behind it).
    pobj_now = c @ x
    mu_floor = 0.03 * cfg.tol * (1.0 + torch.abs(pobj_now)) / data.ncomp
    if cfg.mu_pinf_floor:
        pinf_now = torch.sqrt(torch.sum(r_p * r_p) + torch.sum(r_u * r_u)) / data.norm_b
        mu_floor = torch.maximum(
            mu_floor,
            cfg.mu_pinf_floor * pinf_now * (1.0 + torch.abs(pobj_now)) / data.ncomp,
        )

    if cfg.center:
        # Pure centering step: one KKT solve aiming every product at the
        # current μ — no predictor, no cross term.
        sigma = torch.ones((), dtype=x.dtype, device=x.device)
        target = torch.maximum(mu, mu_floor)
        rxs = target - x * s
        rwz = hub * (target - w * z)
    else:
        # Predictor (affine-scaling) direction.
        rxs_aff = -x * s
        rwz_aff = -(w * z) * hub
        dxa, dya, dsa, dwa, dza = _solve_kkt(
            ops, state, hub, d, factors, r_p, r_u, r_d, rxs_aff, rwz_aff,
            cfg.kkt_refine,
        )
        ap_aff = _max_step(x, dxa, w, dwa, hub)
        ad_aff = _max_step(s, dsa, z, dza, hub)
        mu_aff = (
            (x + ap_aff * dxa) @ (s + ad_aff * dsa)
            + ((w + ap_aff * dwa) * (z + ad_aff * dza)) @ hub
        ) / data.ncomp
        sigma = (mu_aff.clamp_min(0.0) / mu).pow(cfg.sigma_power).clamp(
            cfg.sigma_min, cfg.sigma_max
        )
        target = torch.maximum(sigma * mu, mu_floor)

        # Corrector: recenter to the target and cancel the second-order
        # term, reusing the factorization.
        rxs = target - x * s - dxa * dsa
        rwz = hub * (target - w * z - dwa * dza)
    dx, dy, ds, dw, dz = _solve_kkt(
        ops, state, hub, d, factors, r_p, r_u, r_d, rxs, rwz, cfg.kkt_refine,
    )

    ap_raw = _max_step(x, dx, w, dw, hub)
    ad_raw = _max_step(s, ds, z, dz, hub)
    if cfg.mcc and not cfg.center:
        # Gondzio multiple centrality correctors: each round solves once
        # more on the held factorization with a complementarity-only RHS
        # and keeps the corrected direction only if it lengthens the step.
        zm = torch.zeros_like(b)
        zn = torch.zeros_like(x)
        for mc in range(cfg.mcc):
            grow = 1.3 + 0.25 * mc
            ap_t = (grow * ap_raw + 0.1 * (mc + 1)).clamp_max(1.0)
            ad_t = (grow * ad_raw + 0.1 * (mc + 1)).clamp_max(1.0)
            v_xs = (x + ap_t * dx) * (s + ad_t * ds)
            v_wz = hub * ((w + ap_t * dw) * (z + ad_t * dz))
            lo, hi = 0.1 * target, 10.0 * target
            cxs = torch.minimum(torch.maximum(v_xs, lo), hi) - v_xs
            cwz = hub * (torch.minimum(torch.maximum(v_wz, lo), hi) - v_wz)
            gx, gy, gs, gw, gz = _solve_kkt_once(
                ops, state, hub, d, factors, zm, zn, zn, cxs, cwz
            )
            dx2, dy2, ds2, dw2, dz2 = dx + gx, dy + gy, ds + gs, dw + gw, dz + gz
            ap2 = _max_step(x, dx2, w, dw2, hub)
            ad2 = _max_step(s, ds2, z, dz2, hub)
            better = (ap2 + ad2) > (ap_raw + ad_raw) + 0.01
            keep = lambda new, old: torch.where(better, new, old)
            dx, dy, ds = keep(dx2, dx), keep(dy2, dy), keep(ds2, ds)
            dw, dz = keep(dw2, dw), keep(dz2, dz)
            ap_raw = keep(ap2, ap_raw)
            ad_raw = keep(ad2, ad_raw)

    alpha_p = (cfg.eta * ap_raw).clamp_max(1.0)
    alpha_d = (cfg.eta * ad_raw).clamp_max(1.0)
    alpha_p, alpha_d = _centrality_backoff(
        state, hub, (dx, ds, dw, dz), alpha_p, alpha_d, data.ncomp, cfg.gamma_cent
    )

    finite = (
        torch.isfinite(dx).all()
        & torch.isfinite(dy).all()
        & torch.isfinite(ds).all()
        & torch.isfinite(dw).all()
        & torch.isfinite(dz).all()
    )
    ok = finite & (alpha_p > 0) & (alpha_d > 0)

    def upd(v, dv, a):
        return torch.where(ok, v + a * dv, v)

    x1 = upd(x, dx, alpha_p)
    w1 = torch.where(hub > 0, upd(w, dw, alpha_p), 1.0)
    y1 = upd(y, dy, alpha_d)
    s1 = upd(s, ds, alpha_d)
    z1 = torch.where(hub > 0, upd(z, dz, alpha_d), 0.0)
    new_state = IPMState(x=x1, y=y1, s=s1, w=w1, z=z1)

    pinf, dinf, gap, rel_gap, pobj, dobj, mu1 = residual_norms(ops, data, new_state)
    stats = StepStats(
        mu=mu1,
        gap=gap,
        rel_gap=rel_gap,
        pinf=pinf,
        dinf=dinf,
        pobj=pobj,
        dobj=dobj,
        alpha_p=torch.where(ok, alpha_p, 0.0),
        alpha_d=torch.where(ok, alpha_d, 0.0),
        sigma=sigma,
        bad=~ok,
    )
    return new_state, stats


STATUS_RUNNING, STATUS_OPTIMAL, STATUS_MAXITER, STATUS_NUMERR = 0, 1, 2, 3
STATUS_PINFEAS, STATUS_DINFEAS = 4, 5
STATUS_STALL = 6  # no max(gap,pinf,dinf) improvement over the stall window
N_STAT = 10  # mu, gap, rel_gap, pinf, dinf, pobj, dobj, alpha_p, alpha_d, sigma

DIVERGE_MU = 1e30


def classify_divergence(mu, pinf, dinf, rel_gap, pobj, dobj):
    """Heuristic infeasibility/unboundedness signals, on host floats (the
    host loop) or on 0-d tensors (the fused body, which reads nothing on
    the host).

    * Primal infeasible: complementarity has converged (μ ≈ 0) while primal
      infeasibility is stuck far above tolerance, or the dual objective
      runs away upward.
    * Primal unbounded (dual infeasible): dual infeasibility is stuck while
      the primal objective dives along a recession ray; rel_gap→1 is the
      scale-free confirmation (gap ≈ |pobj|).

    Every test is scale-relative (see the JAX package's
    core.classify_divergence for the derivation of each constant).
    """
    scale_p = 1.0 + abs(pobj)
    scale_d = 1.0 + abs(dobj)
    pinfeas = ((mu < 1e-11 * scale_p) & (pinf > 1e-3)) | (
        dobj > 1e12 * scale_p
    )
    dinfeas = ((dinf > 1e-3) & (pobj < -1e8 * scale_d) & (rel_gap > 0.99)) | (
        pobj < -1e12 * scale_d
    )
    return pinfeas, dinfeas


def buffer_cap(max_iter: int, quantum: int = 512) -> int:
    """Rows of the fused loop's stats buffer, bucketed as in the JAX
    package (there the cap is a compile key; here it only sizes a
    (cap, N_STAT) buffer of ~40 KB)."""
    return ((max(int(max_iter), 1) + quantum - 1) // quantum) * quantum


def _scalar(value, like):
    """A 0-d tensor of ``like``'s dtype and device holding ``value``."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def fused_cond(carry, max_iter, buf_cap, it_stop=None, stall_window=0,
               stall_patience_floor=0.0):
    """Whether the fused loop runs another iteration from ``carry`` (the
    JAX package's while-loop ``cond``), as a 0-d bool tensor.
    ``max_iter`` and ``it_stop`` may be device scalars."""
    _, it, _, _, status, _, best_err, since = carry
    go = (status == STATUS_RUNNING) & (it < max_iter) & (it < buf_cap)
    if it_stop is not None:
        go = go & (it < it_stop)
    if stall_window:
        stall = since > stall_window
        if stall_patience_floor:
            stall = stall & (best_err > stall_patience_floor)
        go = go & ~stall
    return go


def fused_body(carry, step_fn, params, max_iter, max_refactor, reg_grow,
               buf_cap, *, it_stop=None, stall_window=0,
               stall_patience_floor=0.0):
    """One iteration of the fused loop, ``carry ↦ carry'``: the JAX
    package's while-loop ``body`` with every update masked by
    ``go = fused_cond(carry)``.

    A body run after the loop has exited returns the carry bit for bit
    unchanged, which is what lets the CUDA-graph runner queue replays
    past the exit before the host has seen it. The body reads nothing on
    the host: the stats row is written at the device scalar ``it``.
    ``step_fn(state, reg) -> (state', stats)`` is one Mehrotra step at
    regularization ``reg`` (a device scalar). The carry is ``(state, it,
    reg, badcount, status, buf, best_err, since)``.
    """
    go = fused_cond(carry, max_iter, buf_cap, it_stop, stall_window,
                    stall_patience_floor)
    state, it, reg, badcount, status, buf, best_err, since = carry
    new_state, stats = step_fn(state, reg)
    bad = stats.bad
    conv = (
        (stats.rel_gap <= params.tol)
        & (stats.pinf <= params.tol)
        & (stats.dinf <= params.tol)
    )
    state1 = IPMState(*(torch.where(bad, o, n) for n, o in zip(new_state, state)))
    row = torch.stack(
        [stats.mu, stats.gap, stats.rel_gap, stats.pinf, stats.dinf,
         stats.pobj, stats.dobj, stats.alpha_p, stats.alpha_d, stats.sigma]
    ).to(buf.dtype)
    # Clamped: a masked body may run at it == buf_cap.
    at = it.clamp(0, buf.shape[0] - 1).reshape(1).long()
    buf1 = buf.index_copy(0, at, torch.where(bad, buf.index_select(0, at), row[None]))
    it1 = torch.where(bad, it, it + 1)
    badcount1 = torch.where(bad, badcount + 1, badcount)
    numerr = _scalar(STATUS_NUMERR, status)
    status1 = torch.where(
        bad & ((badcount1 > max_refactor) | (reg * reg_grow > 1e-2)),
        numerr,
        torch.where(conv & ~bad, _scalar(STATUS_OPTIMAL, status), status),
    )
    ok = ~bad & (status1 == STATUS_RUNNING)
    pinfeas, dinfeas = classify_divergence(
        stats.mu, stats.pinf, stats.dinf, stats.rel_gap, stats.pobj, stats.dobj
    )
    status1 = torch.where(ok & pinfeas, _scalar(STATUS_PINFEAS, status), status1)
    status1 = torch.where(ok & dinfeas, _scalar(STATUS_DINFEAS, status), status1)
    status1 = torch.where(
        ok & (~torch.isfinite(stats.mu) | (stats.mu > DIVERGE_MU)), numerr, status1
    )
    err = torch.maximum(stats.rel_gap, torch.maximum(stats.pinf, stats.dinf))
    improved = ~bad & (err < 0.9 * best_err)
    best_err1 = torch.where(improved, err, best_err)
    since1 = torch.where(bad, since, torch.where(improved, torch.zeros_like(since), since + 1))
    reg1 = torch.where(bad, reg.clamp_min(1e-12) * reg_grow, reg)
    new = (state1, it1, reg1, badcount1, status1, buf1, best_err1, since1)
    leaves_new, rebuild = device_loop.flatten(new)
    leaves_old, _ = device_loop.flatten(carry)
    return rebuild([torch.where(go, n, o) for n, o in zip(leaves_new, leaves_old)])


def fused_loop(step_fn, params, buf_cap, device, dtype, *, stall_window=0,
               stall_patience_floor=0.0, capture=True):
    """The fused loop's masked body in a :class:`device_loop.DeviceLoop`.

    Its inputs ``max_iter``, ``it_stop``, ``max_refactor`` and
    ``reg_grow`` are device scalars that each ``run`` sets in place, so a
    new segment bound needs no new capture. ``capture=False`` runs every
    body eagerly on a card too (a body holding gloo collectives)."""
    def i32():
        return torch.zeros((), dtype=torch.int32, device=device)

    inputs = {
        "max_iter": i32(), "it_stop": i32(), "max_refactor": i32(),
        "reg_grow": torch.zeros((), dtype=dtype, device=device),
    }

    def cond(carry, s):
        return fused_cond(carry, s["max_iter"], buf_cap, s["it_stop"],
                          stall_window, stall_patience_floor)

    def body(carry, s):
        return fused_body(
            carry, step_fn, params, s["max_iter"], s["max_refactor"],
            s["reg_grow"], buf_cap, it_stop=s["it_stop"],
            stall_window=stall_window, stall_patience_floor=stall_patience_floor,
        )

    return device_loop.DeviceLoop(body, cond, pack_segment_meta, inputs, capture=capture)


def fused_solve(
    step_fn,
    state0,
    reg0,
    params,
    max_iter,
    max_refactor,
    reg_grow,
    buf_cap=None,
    *,
    stall_window=0,
    stall_patience_floor=0.0,
    carry_in=None,
    finalize=True,
    it_stop=None,
    resume=None,
    return_carry=False,
    report=None,
    capture=True,
):
    """The whole IPM solve as one device loop: :func:`fused_body` run by
    ``ipm/device_loop.py`` until :func:`fused_cond` is false. Returns
    ``(state, iterations, status, buffer)`` as device tensors.

    Semantics are the JAX package's ``core.fused_solve``: deterministic
    regularization escalation on bad steps (state frozen, reg ×= grow,
    give up after ``max_refactor``), convergence at ``params.tol``, the
    stall exit over ``stall_window`` accepted steps unless the best error
    is at or below ``stall_patience_floor``, one stats row per accepted
    iteration in a (buf_cap, N_STAT) buffer. ``carry_in`` continues a
    phase, ``finalize=False`` leaves a non-terminal exit RUNNING,
    ``it_stop`` bounds this call, ``resume``/``return_carry`` pass the raw
    carry. ``max_iter``, ``max_refactor`` and ``reg_grow`` become device
    scalars of the loop; ``buf_cap`` defaults to :func:`buffer_cap`.

    ``report`` (a dict), when given, receives the loop's body counts and the bad-step count.
    ``capture=False`` runs the loop uncaptured on a card (see :func:`fused_loop`).
    """
    if buf_cap is None:
        buf_cap = buffer_cap(int(max_iter))
    if resume is not None:
        carry0 = resume
    else:
        x = state0.x
        i32 = dict(dtype=torch.int32, device=x.device)
        if carry_in is not None:
            it0, status0, buf0 = carry_in
            it0 = torch.as_tensor(it0, **i32)
            status0 = torch.as_tensor(status0, **i32)
        else:
            it0 = torch.zeros((), **i32)
            status0 = torch.full((), STATUS_RUNNING, **i32)
            buf0 = torch.zeros((buf_cap, N_STAT), dtype=x.dtype, device=x.device)
        carry0 = (
            state0,
            it0,
            torch.as_tensor(reg0, dtype=x.dtype, device=x.device),
            torch.zeros((), **i32),
            status0,
            buf0,
            torch.full((), float("inf"), dtype=x.dtype, device=x.device),
            torch.zeros((), **i32),
        )
    x = carry0[0].x
    loop = fused_loop(
        step_fn, params, buf_cap, x.device, x.dtype, stall_window=stall_window,
        stall_patience_floor=stall_patience_floor, capture=capture,
    )
    try:
        carry, _ = loop.run(
            carry0, max_iter=max_iter,
            it_stop=max_iter if it_stop is None else it_stop,
            max_refactor=max_refactor, reg_grow=reg_grow,
        )
        if report is not None:
            report.update(loop.report(), bad_steps=int(carry[3]))
    finally:
        loop.close()
    if return_carry:
        return carry
    state, it, _, _, status, buf, _, since = carry
    if finalize:
        stalled = (
            (since > stall_window) if stall_window
            else torch.zeros((), dtype=torch.bool, device=x.device)
        )
        status = torch.where(
            status == STATUS_RUNNING,
            torch.where(stalled & (it < max_iter), _scalar(STATUS_STALL, status),
                        _scalar(STATUS_MAXITER, status)),
            status,
        )
    return state, it, status, buf


def seg_trace_enabled() -> bool:
    """Whether TPULP_SEG_VERBOSE asks for live progress lines
    (conventional 0/1 contract: "", "0", "false", "no" disable)."""
    return os.environ.get("TPULP_SEG_VERBOSE", "").lower() not in (
        "", "0", "false", "no",
    )


def drive_segments(
    run_seg, carry0, max_iter, stall_window, seg_init=16, target_s=15.0,
    stall_patience_floor=0.0, it0_status0=(0, STATUS_RUNNING),
    early_stop=None, seg_cap=256,
):
    """Host loop over bounded fused-loop segments (the JAX package's
    ``core.drive_segments``, line for line).

    ``run_seg(carry, it_stop) -> (carry, meta)`` continues the loop from
    ``carry`` until the iteration count reaches ``it_stop`` or the loop
    exits on its own; ``meta`` is the host copy of the packed ``[it,
    status, best_err, since]``. Repeats, adapting the segment length
    toward ``target_s`` seconds, until the status leaves RUNNING, the
    stall window fires, ``early_stop(it, status, best_err, since)`` says
    so, or ``max_iter`` is reached. Returns ``(carry, (it, status,
    best_err, since))``.
    """
    trace = seg_trace_enabled()
    carry = carry0
    seg = max(int(seg_init), 1)
    it, status = it0_status0
    best_err, since = float("inf"), 0
    first = True
    while status == STATUS_RUNNING and it < max_iter:
        prev_it = it
        stop = min(it + seg, max_iter)
        t0 = time.perf_counter()
        carry, meta = run_seg(carry, stop)
        meta = np.asarray(meta)
        dt = time.perf_counter() - t0
        it, status = int(meta[0]), int(meta[1])
        best_err, since = float(meta[2]), int(meta[3])
        if trace:
            print(
                f"[seg] it={it} status={status} best_err={best_err:.3e} "
                f"since={since} dt={dt:.1f}s seg={seg}",
                file=sys.stderr, flush=True,
            )
        if (
            stall_window
            and since > stall_window
            and (not stall_patience_floor or best_err > stall_patience_floor)
        ):
            break
        if early_stop is not None and early_stop(it, status, best_err, since):
            break
        if it == prev_it:  # no progress possible (defensive: avoid spinning)
            break
        if not first:  # the first call's time includes warm-up: don't adapt
            seg = max(1, min(seg_cap, int(seg * target_s / max(dt, 1e-3))))
        first = False
    return carry, (it, status, best_err, since)


def pack_segment_meta(carry):
    """[it, status, best_err, since] as one tensor — see drive_segments."""
    _, it, _, _, status, _, best_err, since = carry
    f = best_err.dtype
    return torch.stack([it.to(f), status.to(f), best_err, since.to(f)])


def fresh_segment_carry(state, reg0, buf_cap, dtype):
    """Initial drive_segments carry for a fused solve starting at
    ``state`` (fused_solve's carry layout)."""
    dev = state.x.device
    i32 = dict(dtype=torch.int32, device=dev)
    return (
        state,
        torch.zeros((), **i32),
        torch.as_tensor(reg0, dtype=dtype, device=dev),
        torch.zeros((), **i32),
        torch.full((), STATUS_RUNNING, **i32),
        torch.zeros((buf_cap, N_STAT), dtype=dtype, device=dev),
        torch.full((), float("inf"), dtype=dtype, device=dev),
        torch.zeros((), **i32),
    )


def segment_phase_reset(carry, reg0):
    """Phase-boundary reset: keep state, iteration count and stats
    buffer; reset what is provisional (regularization, bad-count, status,
    stall tracking)."""
    st, it, _, badcount, status, buf, best_err, _ = carry
    return (
        st, it, torch.as_tensor(reg0, dtype=buf.dtype, device=buf.device),
        torch.zeros_like(badcount), torch.full_like(status, STATUS_RUNNING), buf,
        torch.full_like(best_err, float("inf")), torch.zeros_like(badcount),
    )


def drive_phase_plan(phases, state, reg0, max_iter, buf_cap, dtype,
                     report=None):
    """Host driver for a multi-phase segmented fused solve (the JAX
    package's ``core.drive_phase_plan``).

    ``phases`` is a list of ``(make_run_seg, stall_window,
    stall_patience_floor, seg_init)``; ``make_run_seg(bound) ->
    run_seg(carry, it_stop)`` builds the phase's runner around its global
    iteration bound. Each phase gets its own ``max_iter`` budget; between
    phases the carry is reset by :func:`segment_phase_reset`. Returns
    ``(state, iterations, status, stats_buffer, reg)`` with the final
    RUNNING status mapped to STALL/MAXITER as the fused loop maps it.

    ``report`` (optional list) receives one ``{"phase", "iters",
    "wall_s", "bad_steps"}`` row per phase.
    """
    carry = fresh_segment_carry(state, reg0, buf_cap, dtype)
    it, status = 0, STATUS_RUNNING
    window, patience, bound = 0, 0.0, max_iter
    best, since = float("inf"), 0
    for pi, (make_run_seg, window, patience, seg_init) in enumerate(phases):
        bound = it + max_iter
        it_before, t_ph = it, time.perf_counter()
        carry, (it, status, best, since) = drive_segments(
            make_run_seg(bound), carry, bound, window, seg_init,
            stall_patience_floor=patience, it0_status0=(it, status),
        )
        if report is not None:
            report.append({
                "phase": pi, "iters": int(it - it_before),
                "wall_s": round(time.perf_counter() - t_ph, 3),
                "bad_steps": int(carry[3]),
            })
        if pi < len(phases) - 1:
            carry = segment_phase_reset(carry, reg0)
            status = STATUS_RUNNING
    st, buf = carry[0], carry[5]
    if status == STATUS_RUNNING:
        stalled = (
            window
            and since > window
            and it < bound
            and (not patience or best > patience)
        )
        status = STATUS_STALL if stalled else STATUS_MAXITER
    return st, it, torch.tensor(status, dtype=torch.int32), buf, carry[2]


# Opening-segment cap in auto mode and the effective rates that seed the
# segment length: the JAX package's values (its TPU watchdog model), kept
# so that both packages cut the same segments. On a card they only size
# the first segment; drive_segments adapts the rest to measured time.
SEG_OPEN_CAP = 32
SEG_RATE_F32 = 2e12
SEG_RATE_F64 = 2.5e11


def use_segments(seg_cfg, platform: str) -> bool:
    """Whether a backend should host-segment its fused loop: explicit
    ``segment_iters=0`` disables, any positive value enables, and auto
    (None) enables exactly on TPU — so only under the dense backend's
    ``schedule_platform="tpu"`` parity seam in this package, whose
    platforms are ``"cuda"`` and ``"cpu"``."""
    if seg_cfg is None:
        return platform == "tpu"
    return seg_cfg > 0


def seg_open(seg_cfg, est_iter_seconds, target_s: float = 15.0) -> int:
    """Opening segment length: the FLOP-estimated iteration count toward
    ``target_s``, capped by SEG_OPEN_CAP in auto mode or by the user's
    explicit ``segment_iters``."""
    cap = seg_cfg if seg_cfg is not None else SEG_OPEN_CAP
    return max(1, min(cap, int(target_s / max(est_iter_seconds, 1e-3))))


def starting_point(ops: LinOps, data: ProblemData, cfg: StepParams) -> IPMState:
    """Mehrotra's least-squares starting point, extended to upper bounds.

    ``x̂ = Aᵀ(AAᵀ)⁻¹b`` (min-norm primal), ``ŷ = (AAᵀ)⁻¹Ac``, ``ŝ = c-Aᵀŷ``,
    then positive shifts sized so initial complementarity is balanced
    (Mehrotra 1992 §7). Bounded columns are clamped into (5%, 95%) of
    [0, u] and their dual is split ``s-z = ŝ`` with both parts positive,
    so r_d starts at 0 there.
    """
    c, b, u_f, hub = data.c, data.b, data.u_f, data.hub
    ones = torch.ones_like(c)
    factors = ops.factorize(ones)
    x_hat = ops.rmatvec(ops.solve(factors, b))
    y_hat = ops.solve(factors, ops.matvec(c))
    s_hat = c - ops.rmatvec(y_hat)

    dx = (-1.5 * x_hat.min()).clamp_min(0.0)
    ds = (-1.5 * s_hat.min()).clamp_min(0.0)
    x1 = x_hat + dx
    s1 = s_hat + ds
    xs = x1 @ s1
    dx_hat = dx + 0.5 * xs / s1.sum().clamp_min(1e-30)
    ds_hat = ds + 0.5 * xs / x1.sum().clamp_min(1e-30)
    x0 = (x_hat + dx_hat).clamp_min(1e-2)
    s0_free = (s_hat + ds_hat).clamp_min(1e-2)

    # Bounded columns: interior of [0, u] and positive dual split.
    x0 = torch.where(hub > 0, torch.clamp(x0, 0.05 * u_f, 0.95 * u_f), x0)
    w0 = torch.where(hub > 0, u_f - x0, 1.0)
    pad = 1.0 + torch.abs(s_hat)
    s0 = torch.where(hub > 0, s_hat.clamp_min(0.0) + 0.1 * pad, s0_free)
    z0 = torch.where(hub > 0, s0 - s_hat, 0.0)
    return IPMState(x=x0, y=y_hat, s=s0, w=w0, z=z0)
