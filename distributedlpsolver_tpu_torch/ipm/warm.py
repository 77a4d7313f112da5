"""Warm-started IPM: safeguarded initial iterates from prior solutions.

A copy of the JAX package's ``ipm/warm.py`` (host numpy only), so both
packages build the same candidate from the same prior.

Production LP traffic is correlated — the same model re-solved with
perturbed b/c (MPAX-style parameterized streams, arXiv:2412.09734), so a
prior optimum of the *same structure* is a far better starting point than
Mehrotra's least-squares cold start... once it is pushed back into the
strict interior. A converged iterate sits essentially ON the boundary
(x_i·s_i ≈ tol-level for every pair); restarting there stalls the very
first step. The classic remedy (Gondzio-style warm start) is applied
here in two moves:

1. **shift** — clip every primal/dual pair component to a relative
   interior floor (bounded columns are additionally pulled strictly
   inside [0, u]);
2. **recentre** — lift the *smaller* factor of any complementarity pair
   whose product sits below ``β·μ_w`` (the candidate's own average), so
   no single pair starts the solve anti-centered.

The candidate is then **safeguarded** against adversarial priors: its
initial residual merit ``max(pinf, dinf)`` is compared against the
Mehrotra cold start's, and the warm iterate is only used when it does
not regress by more than :data:`WARM_ACCEPT_FACTOR` — otherwise the
solve falls back to the cold start (counted by the
``warm_start_rejected_total`` metric). In the JAX package the same
construction also runs traced inside the batched bucket programs, which
this package does not have yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from distributedlpsolver_tpu_torch.ipm.state import IPMState

# Warm candidate accepted iff merit(warm) <= factor * merit(cold): a
# near-duplicate prior lands orders below the cold start's residuals, an
# adversarial (far-off) one lands orders above — 10x tolerates honest
# perturbation noise without admitting garbage.
WARM_ACCEPT_FACTOR = 10.0
# Second acceptance guard: the candidate's complementarity must not
# exceed this multiple of the cold start's μ. The primal/dual refresh
# makes even a far-off prior nearly FEASIBLE on the new instance (its
# residual merit alone would pass), but a e.g. 1e9-scaled iterate still
# carries a μ orders above any useful start — the μ guard is what
# actually rejects it.
MU_ACCEPT_FACTOR = 10.0
# Relative interior floor of the shift step (fraction of the vector's
# own mean magnitude): big enough that no pair starts frozen, small
# enough to stay near the prior optimum.
INTERIOR_FLOOR = 1e-4
# Recentre target: every pair product is lifted to at least β·μ_w.
CENTRALITY_BETA = 0.1
# Residual-aware μ floor of the recentre step, in mehrotra_step's
# mu_pinf_floor units: a prior OPTIMUM has μ ≈ 0, but on the *new*
# instance the candidate carries residuals ~‖Δb‖/‖Δc‖ — restarting with
# μ orders below that infeasibility hands the solver an iterate
# over-committed to the old active set (the exact failure
# StepParams.mu_pinf_floor exists for, observed here as warm solves
# SLOWER than cold). The recentre target is therefore
# max(β·μ_w, this·merit·(1+|pobj|)/ncomp).
MERIT_MU_FLOOR = 0.1


@dataclasses.dataclass
class WarmStart:
    """A prior iterate offered as a warm start (SAFEGUARDED: the driver
    shifts/recentres it and falls back to a cold start when its initial
    residuals regress — unlike a raw IPMState ``warm_start``, which is
    the trusted checkpoint-resume path and used verbatim).

    ``state`` is in the *unscaled interior space* of the same structure
    (what ``IPMResult``-adjacent host states and the warm cache hold).
    """

    state: IPMState
    source: str = ""  # provenance tag (telemetry: "cache", "caller", ...)


# Primal-projection size bound of the host engine: above this row count
# the AAᵀ factorization is real money on the host and the projection is
# skipped (the bucket engine projects in-program regardless — its
# factorization is MXU microseconds at serve shapes).
PROJECT_MAX_M = 4096


def interior_candidate(state: IPMState, inf) -> IPMState:
    """Build a warm candidate from a prior iterate for the NEW instance
    ``inf`` (host numpy). Four moves:

    1. shift every pair component to a strict relative interior;
    2. **primal projection** (dense A, m ≤ PROJECT_MAX_M): one AAᵀ
       solve moves x onto the new ``Ax = b`` affine — the same-A
       delta-solve refresh, killing the ‖Δb‖ residual outright;
    3. **dual slack refresh**: s is re-derived from ``c − Aᵀy`` (split
       positively with z on bounded columns), killing the ‖Δc‖ residual;
    4. residual-aware centrality lift: every pair product is raised to
       ``max(β·μ_w, MERIT_MU_FLOOR·merit·(1+|pobj|)/ncomp)``.
    """
    x = np.asarray(state.x, dtype=np.float64).copy()
    y = np.asarray(state.y, dtype=np.float64)
    s = np.asarray(state.s, dtype=np.float64)
    z = np.asarray(state.z, dtype=np.float64)
    u = np.asarray(inf.u, dtype=np.float64)
    hub = np.isfinite(u)
    u_f = np.where(hub, u, 1.0)
    b = np.asarray(inf.b, dtype=np.float64)
    c = np.asarray(inf.c, dtype=np.float64)

    xm = max(float(np.mean(np.abs(x))), 1.0)
    sm = max(float(np.mean(np.abs(s))), 1.0)
    x = np.maximum(x, INTERIOR_FLOOR * xm)
    A = inf.A
    if isinstance(A, np.ndarray) and A.shape[0] <= PROJECT_MAX_M:
        try:
            import scipy.linalg as _sla

            M = A @ A.T
            M[np.diag_indices_from(M)] += 1e-10 * max(
                float(np.trace(M)) / max(A.shape[0], 1), 1.0
            )
            F = _sla.cho_factor(M)
            x = x + A.T @ _sla.cho_solve(F, b - A @ x)
            x = np.maximum(x, INTERIOR_FLOOR * xm)
        except Exception:  # degenerate AAᵀ: keep the shifted iterate
            pass
    # Bounded columns: strictly inside [0, u], slack re-derived.
    x = np.where(hub, np.clip(x, 0.01 * u_f, 0.99 * u_f), x)
    w = np.where(hub, u_f - x, 1.0)
    # Dual refresh: s − z = c − Aᵀy exactly wherever the positive split
    # allows, a floor-shift on both parts elsewhere.
    s_hat = c - np.asarray(A.T @ y).ravel()
    z = np.where(hub, np.maximum(z, INTERIOR_FLOOR * sm), 0.0)
    s = np.where(hub, s_hat + z, np.maximum(s_hat, INTERIOR_FLOOR * sm))
    deficit = np.where(hub, np.maximum(INTERIOR_FLOOR * sm - s, 0.0), 0.0)
    s = s + deficit
    z = z + deficit

    ncomp = x.shape[0] + int(hub.sum())
    mu = (x @ s + (hub * w) @ z) / max(ncomp, 1)
    # Residual-aware target (MERIT_MU_FLOOR): μ is rebalanced against
    # the candidate's remaining infeasibility before any step runs.
    merit = residual_merit(
        inf, IPMState(x=x, y=y, s=s, w=w, z=np.where(hub, z, 0.0))
    )
    pobj = float(c @ x)
    target = max(
        CENTRALITY_BETA * mu,
        MERIT_MU_FLOOR * merit * (1.0 + abs(pobj)) / max(ncomp, 1),
        1e-300,
    )
    # Lift the SMALLER factor of any pair below the centering target —
    # raising the larger one would move the iterate further than needed.
    with np.errstate(over="ignore", divide="ignore"):
        lift = np.sqrt(np.clip(target / np.maximum(x * s, 1e-300), 1.0, 1e16))
        liftw = np.sqrt(np.clip(target / np.maximum(w * z, 1e-300), 1.0, 1e16))
    x2 = np.where(x <= s, x * lift, x)
    s2 = np.where(s < x, s * lift, s)
    w2 = np.where(hub & (w <= z), w * liftw, w)
    z2 = np.where(hub & (z < w), z * liftw, z)
    # The lifted w may poke past u; the IPM tolerates r_u != 0 (it is an
    # infeasible-start method), and the pair stays strictly positive.
    return IPMState(x=x2, y=y, s=s2, w=np.where(hub, w2, 1.0),
                    z=np.where(hub, z2, 0.0))


def state_mu(state: IPMState, u) -> float:
    """Average complementarity of a host iterate (the μ-guard input)."""
    x = np.asarray(state.x, dtype=np.float64)
    s = np.asarray(state.s, dtype=np.float64)
    w = np.asarray(state.w, dtype=np.float64)
    z = np.asarray(state.z, dtype=np.float64)
    hub = np.isfinite(np.asarray(u, dtype=np.float64)).astype(np.float64)
    ncomp = x.shape[0] + int(hub.sum())
    return float((x @ s + (hub * w) @ z) / max(ncomp, 1))


def residual_merit(inf, state: IPMState) -> float:
    """``max(pinf, dinf)`` of a host-space iterate against an interior
    form — the same relative norms core.residual_norms computes, in
    plain numpy (A may be dense or scipy-sparse). The warm-vs-cold
    safeguard comparison runs on this."""
    x = np.asarray(state.x, dtype=np.float64)
    y = np.asarray(state.y, dtype=np.float64)
    s = np.asarray(state.s, dtype=np.float64)
    w = np.asarray(state.w, dtype=np.float64)
    z = np.asarray(state.z, dtype=np.float64)
    u = np.asarray(inf.u, dtype=np.float64)
    hub = np.isfinite(u).astype(np.float64)
    u_f = np.where(hub > 0, u, 1.0)
    b = np.asarray(inf.b, dtype=np.float64)
    c = np.asarray(inf.c, dtype=np.float64)
    r_p = b - np.asarray(inf.A @ x).ravel()
    r_u = hub * (u_f - x - w)
    r_d = c - np.asarray(inf.A.T @ y).ravel() - s + z
    pinf = float(np.sqrt(r_p @ r_p + r_u @ r_u) / (1.0 + np.linalg.norm(b)))
    dinf = float(np.linalg.norm(r_d) / (1.0 + np.linalg.norm(c)))
    return max(pinf, dinf)
