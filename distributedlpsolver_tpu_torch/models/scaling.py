"""Ruiz equilibration of the interior form (presolve scaling).

Real Netlib/Mittelmann files mix coefficient magnitudes across many
orders (SURVEY.md §0.1 item 5 lists presolve/scaling as a reference
capability to verify); iterative ∞-norm equilibration (Ruiz 2001) brings
every row and column of A to ~unit max magnitude, which directly tightens
the conditioning of A·diag(d)·Aᵀ — the quantity that limits how far the
f64 normal-equations path can push the duality gap (see ipm/core.py).

Transformation: ``A' = Dr·A·Dc`` with
``x' = Dc⁻¹x, y' = Dr⁻¹y·(scale), s' = Dc·s`` chosen so the scaled
problem is again a valid interior form; :meth:`Scaling.unscale_state`
maps a solved iterate back. Objective values are invariant
(``c'ᵀx' = cᵀx``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from distributedlpsolver_tpu_torch.ipm.state import IPMState
from distributedlpsolver_tpu_torch.models.problem import InteriorForm


@dataclasses.dataclass
class Scaling:
    dr: np.ndarray  # (m,) row scale factors applied to A's rows
    dc: np.ndarray  # (n,) column scale factors applied to A's columns

    def unscale_state(self, st: IPMState) -> IPMState:
        """Scaled-space iterate → original-space iterate.

        x = Dc·x', w = Dc·w' (primal-like, column space);
        y = Dr·y' (A'ᵀy' = Dc·Aᵀ·Dr·y'); s = s'/Dc, z = z'/Dc.
        """
        return IPMState(
            x=np.asarray(st.x) * self.dc,
            y=np.asarray(st.y) * self.dr,
            s=np.asarray(st.s) / self.dc,
            w=np.asarray(st.w) * self.dc,
            z=np.asarray(st.z) / self.dc,
        )

    def scale_state(self, st: IPMState) -> IPMState:
        """Original-space iterate → scaled space (warm starts)."""
        return IPMState(
            x=np.asarray(st.x) / self.dc,
            y=np.asarray(st.y) / self.dr,
            s=np.asarray(st.s) * self.dc,
            w=np.asarray(st.w) / self.dc,
            z=np.asarray(st.z) * self.dc,
        )


def _row_col_maxabs(A):
    if sp.issparse(A):
        Aa = abs(A)
        row = np.asarray(Aa.max(axis=1).todense()).ravel()
        col = np.asarray(Aa.max(axis=0).todense()).ravel()
    else:
        Aa = np.abs(A)
        row = Aa.max(axis=1, initial=0.0)
        col = Aa.max(axis=0, initial=0.0)
    return row, col


def equilibrate(inf: InteriorForm, iterations: int = 10, tol: float = 1e-2):
    """Ruiz-equilibrate an interior form. Returns (scaled_form, Scaling).

    Empty rows/columns keep scale 1. Stops early once every row/col max is
    within ``tol`` of 1.
    """
    m, n = inf.m, inf.n
    dr = np.ones(m)
    dc = np.ones(n)
    if sp.issparse(inf.A):
        A = inf.A.copy().astype(np.float64)
        for _ in range(iterations):
            row, col = _row_col_maxabs(A)
            if (np.abs(row[row > 0] - 1.0) < tol).all() and (
                np.abs(col[col > 0] - 1.0) < tol
            ).all():
                break
            with np.errstate(divide="ignore"):
                r = np.where(row > 0, 1.0 / np.sqrt(row), 1.0)
                c = np.where(col > 0, 1.0 / np.sqrt(col), 1.0)
            A = sp.diags(r) @ A @ sp.diags(c)
            dr *= r
            dc *= c
    else:
        # Dense path works on ONE |A| buffer, updated in place: at the
        # 10k×50k reference scale a per-iteration `(A*r)*c` allocates two
        # fresh 4 GB arrays per sweep (~270 s total observed); in-place
        # sweeps over the magnitude matrix are ~10× faster, and the scaled
        # A itself is formed once at the end from the accumulated factors.
        absA = np.abs(np.asarray(inf.A, dtype=np.float64))
        for _ in range(iterations):
            row = absA.max(axis=1, initial=0.0)
            col = absA.max(axis=0, initial=0.0)
            if (np.abs(row[row > 0] - 1.0) < tol).all() and (
                np.abs(col[col > 0] - 1.0) < tol
            ).all():
                break
            with np.errstate(divide="ignore"):
                r = np.where(row > 0, 1.0 / np.sqrt(row), 1.0)
                c = np.where(col > 0, 1.0 / np.sqrt(col), 1.0)
            absA *= r[:, None]
            absA *= c
            dr *= r
            dc *= c
        A = absA  # reuse the buffer: refill with signed scaled values
        np.multiply(inf.A, dr[:, None], out=A)
        A *= dc

    scaled = InteriorForm(
        c=inf.c * dc,
        A=A,
        b=inf.b * dr,
        u=np.where(np.isfinite(inf.u), inf.u / dc, np.inf),
        c0=inf.c0,
        orig_n=inf.orig_n,
        col_kind=inf.col_kind,
        col_orig=inf.col_orig,
        col_shift=inf.col_shift,
        col_sign=inf.col_sign,
        name=inf.name,
        block_structure=inf.block_structure,
    )
    return scaled, Scaling(dr=dr, dc=dc)
