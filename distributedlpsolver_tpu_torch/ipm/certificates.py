"""Infeasibility / unboundedness certificates (Farkas rays).

Upgrades the driver's divergence *heuristics* (core.classify_divergence)
to checkable mathematical certificates, extracted from the diverging
iterate on the host (VERDICT.md round 1, item 10; the reference has no
such machinery on available evidence — SURVEY.md §5.3 — so this is a
capability addition, not a parity item).

All certificates are stated on the interior form
``min cᵀx  s.t.  Ax = b, 0 ≤ x, x_j ≤ u_j (j ∈ bounded)``:

* **Primal infeasibility** (Farkas): a pair ``(y, z)`` with ``z ≥ 0``
  supported on the bounded columns such that ``Aᵀy − z ≤ 0``
  componentwise (so ``Aᵀy ≤ 0`` on unbounded columns) and
  ``bᵀy − Σ u_j z_j > 0``. For any feasible x this gives
  ``bᵀy = xᵀAᵀy ≤ xᵀz ≤ Σ u_j z_j`` — a contradiction, so no feasible
  x exists. The candidate comes from the diverging dual iterate y with
  the optimal compensating ``z = max(Aᵀy, 0)`` on bounded columns.
* **Dual infeasibility / primal unboundedness**: a ray ``r ≥ 0`` with
  ``r_j = 0`` on bounded columns, ``Ar ≈ 0`` and ``cᵀr < 0`` — moving
  along r stays feasible and decreases the objective without bound. The
  candidate is the (blowing-up) primal iterate direction ``x/‖x‖``.

Quality is reported as the certified objective-separation relative to
the residual violation; ``certified`` requires the violation to be at
roundoff-ish scale relative to the separation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class Certificate:
    """A checkable Farkas certificate (interior-form space)."""

    kind: str  # "primal_infeasible" | "dual_infeasible"
    ray: np.ndarray  # y for primal certificates, x-ray for dual ones
    z: Optional[np.ndarray]  # bound multipliers (primal certificates)
    separation: float  # bᵀy − uᵀz  (primal) / −cᵀr (dual); > 0 when valid
    violation: float  # max constraint violation of the ray
    certified: bool  # violation small relative to separation

    def summary(self) -> str:
        tag = "CERTIFIED" if self.certified else "uncertified"
        return (
            f"{self.kind} certificate [{tag}]: separation="
            f"{self.separation:.3e}, violation={self.violation:.3e}"
        )


def _matvecs(A):
    if sp.issparse(A):
        return (lambda v: A @ v), (lambda v: A.T @ v)
    Ad = np.asarray(A)
    return (lambda v: Ad @ v), (lambda v: Ad.T @ v)


def primal_infeasibility_certificate(
    inf, y, rel_tol: float = 1e-6
) -> Optional[Certificate]:
    """Try to certify primal infeasibility from a dual iterate ``y``."""
    y = np.asarray(y, dtype=np.float64)
    ny = float(np.linalg.norm(y))
    if not np.isfinite(ny) or ny == 0.0:
        return None
    yh = y / ny
    _, rmat = _matvecs(inf.A)
    g = np.asarray(rmat(yh)).ravel()
    u = np.asarray(inf.u, dtype=np.float64)
    bounded = np.isfinite(u)
    z = np.where(bounded, np.maximum(g, 0.0), 0.0)
    # Violation: positive reduced ray-cost on UNBOUNDED columns cannot be
    # compensated by any z — it is the certificate's defect.
    viol = float(np.max(np.maximum(g, 0.0) * (~bounded), initial=0.0))
    sep = float(np.asarray(inf.b) @ yh - u[bounded] @ z[bounded])
    scale = 1.0 + float(np.abs(np.asarray(inf.b) @ yh)) + float(
        np.abs(u[bounded] @ z[bounded]) if bounded.any() else 0.0
    )
    # The violation is one component of Aᵀŷ with ‖ŷ‖₂ = 1 — and only
    # UNBOUNDED columns can contribute it — so its natural magnitude is
    # the largest unbounded-column norm of A. Test it relative to that,
    # NOT to max(1, sep): a feasible problem whose feasible points all
    # have huge ‖x‖₁ drives sep large, and a sep-relative tolerance
    # would then admit a materially violated "certificate" that falsely
    # upgrades STALLED to PRIMAL_INFEASIBLE. (Frobenius would be
    # √(m·n)-looser than the component's scale at reference sizes, and a
    # large-norm BOUNDED column must not inflate the tolerance either.)
    A = inf.A
    col_sq = (
        np.asarray(A.power(2).sum(axis=0)).ravel() if sp.issparse(A)
        else np.einsum("ij,ij->j", np.asarray(A), np.asarray(A))
    )
    col_scale = float(np.sqrt(np.max(col_sq[~bounded], initial=0.0)))
    certified = (
        sep > rel_tol * scale and viol <= rel_tol * max(col_scale, 1e-30)
    )
    if sep <= 0:
        return None
    return Certificate(
        kind="primal_infeasible", ray=yh, z=z,
        separation=sep, violation=viol, certified=bool(certified),
    )


def dual_infeasibility_certificate(
    inf, x, rel_tol: float = 1e-6
) -> Optional[Certificate]:
    """Try to certify primal unboundedness from a primal iterate ``x``."""
    x = np.asarray(x, dtype=np.float64)
    nx = float(np.linalg.norm(x))
    if not np.isfinite(nx) or nx == 0.0:
        return None
    u = np.asarray(inf.u, dtype=np.float64)
    bounded = np.isfinite(u)
    r = np.maximum(x / nx, 0.0)
    r[bounded] = 0.0  # a recession ray cannot move bounded coordinates
    nr = float(np.linalg.norm(r))
    if nr == 0.0:
        return None
    r /= nr
    mat, _ = _matvecs(inf.A)
    viol = float(np.linalg.norm(np.asarray(mat(r)).ravel()))
    sep = -float(np.asarray(inf.c) @ r)
    if sep <= 0:
        return None
    # Scale-relative test: ||Ar|| must be small relative to ||A||'s scale
    # (a uniformly tiny A makes every unit ray "near-null" in absolute
    # terms) and the objective descent relative to ||c|| — otherwise a
    # feasible problem with small data could be "certified" unbounded.
    A = inf.A
    normA = float(
        np.sqrt((A.power(2)).sum()) if sp.issparse(A)
        else np.linalg.norm(np.asarray(A))
    )
    normc = float(np.linalg.norm(np.asarray(inf.c)))
    certified = (
        sep > rel_tol * max(normc, 1e-30)
        and viol <= rel_tol * max(normA, 1e-30)
    )
    return Certificate(
        kind="dual_infeasible", ray=r, z=None,
        separation=sep, violation=viol, certified=bool(certified),
    )


def extract_certificate(inf, host_state, status_name: str):
    """Certificate attempt for a non-optimal terminal state.

    Tries the certificate matching the heuristic verdict first, then the
    other one (an ITERATION_LIMIT run may still carry a clean ray).
    Returns the best Certificate or None.
    """
    cands = []
    if status_name != "dual_infeasible":
        c = primal_infeasibility_certificate(inf, host_state.y)
        if c is not None:
            cands.append(c)
    if status_name != "primal_infeasible":
        c = dual_infeasibility_certificate(inf, host_state.x)
        if c is not None:
            cands.append(c)
    certified = [c for c in cands if c.certified]
    if certified:
        return max(certified, key=lambda c: c.separation)
    return max(cands, key=lambda c: c.separation) if cands else None
