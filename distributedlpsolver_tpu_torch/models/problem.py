"""LP problem representations and standard-form conversion.

Two representations:

* :class:`LPProblem` — the *general* form produced by the MPS reader and the
  generators: ``min cᵀx + c0  s.t.  rlb ≤ Ax ≤ rub,  lb ≤ x ≤ ub``.
  Row senses (E/L/G/ranged) are encoded purely via ``rlb``/``rub``.

* :class:`InteriorForm` — the canonical form consumed by the IPM core:
  ``min c̃ᵀx̃  s.t.  Ãx̃ = b,  0 ≤ x̃ (≤ u where finite)``.
  Inequality rows become slack columns, finite lower bounds are shifted to
  zero, upper-bounded-only columns are negated, and free columns are split —
  so the IPM only ever sees equality rows plus non-negative variables with
  optional finite upper bounds. The conversion records enough metadata to
  recover the original ``x`` and objective value.

The reference's LP model layer is reconstructed from BASELINE.json:5,7-11
(see SURVEY.md §2 "LP standard-form model"); no reference source was
available to cite (SURVEY.md §0).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import scipy.sparse as sp

Matrix = Union[np.ndarray, sp.spmatrix]

_INF = np.inf


def _is_sparse(A: Matrix) -> bool:
    return sp.issparse(A)


@dataclasses.dataclass
class LPProblem:
    """General-form LP: ``min cᵀx + c0  s.t.  rlb ≤ Ax ≤ rub, lb ≤ x ≤ ub``."""

    c: np.ndarray  # (n,)
    A: Matrix  # (m, n) dense ndarray or scipy sparse
    rlb: np.ndarray  # (m,) row lower bounds (-inf for L rows)
    rub: np.ndarray  # (m,) row upper bounds (+inf for G rows)
    lb: np.ndarray  # (n,) column lower bounds
    ub: np.ndarray  # (n,) column upper bounds
    c0: float = 0.0  # objective constant
    name: str = "LP"
    row_names: Optional[list] = None
    col_names: Optional[list] = None
    integer_cols: list = dataclasses.field(default_factory=list)  # LP-relaxed
    maximize: bool = False  # original sense; c/c0 are always stored minimized
    # Optional block-angular layout hint {num_blocks, block_m, block_n,
    # link_m} describing A's row/col grouping (rows: K·block_m block rows
    # then link_m linking rows; cols: block k owns columns
    # [k·block_n, (k+1)·block_n)). Consumed by the Schur-complement backend.
    block_structure: Optional[dict] = None

    def __post_init__(self):
        if not sp.issparse(self.A):
            self.A = np.asarray(self.A, dtype=np.float64)
        self.c = np.asarray(self.c, dtype=np.float64).ravel()
        self.rlb = np.asarray(self.rlb, dtype=np.float64).ravel()
        self.rub = np.asarray(self.rub, dtype=np.float64).ravel()
        self.lb = np.asarray(self.lb, dtype=np.float64).ravel()
        self.ub = np.asarray(self.ub, dtype=np.float64).ravel()
        m, n = self.shape
        if self.c.shape != (n,):
            raise ValueError(f"c has shape {self.c.shape}, expected ({n},)")
        for arr, k, nm in [
            (self.rlb, m, "rlb"),
            (self.rub, m, "rub"),
            (self.lb, n, "lb"),
            (self.ub, n, "ub"),
        ]:
            if arr.shape != (k,):
                raise ValueError(f"{nm} has shape {arr.shape}, expected ({k},)")
        if np.any(self.rlb > self.rub):
            raise ValueError("rlb > rub for some row")
        if np.any(self.lb > self.ub):
            raise ValueError("lb > ub for some column")

    @property
    def shape(self) -> tuple:
        return self.A.shape

    @property
    def m(self) -> int:
        return self.A.shape[0]

    @property
    def n(self) -> int:
        return self.A.shape[1]

    def objective(self, x: np.ndarray) -> float:
        return float(self.c @ x) + self.c0

    def to_dict(self) -> dict:
        """JSON-serializable round-trip of the problem — the durable job
        journal's replay payload (serve/journal.py). Dense ``A`` stores
        row lists; sparse ``A`` stores COO triplets so journaling never
        densifies. Infinities survive as the strings "inf"/"-inf"
        (strict JSON has no Infinity literal)."""

        def _vec(v):
            return [
                float(x) if np.isfinite(x) else ("inf" if x > 0 else "-inf")
                for x in np.asarray(v, dtype=np.float64).ravel()
            ]

        d = {
            "c": _vec(self.c),
            "rlb": _vec(self.rlb),
            "rub": _vec(self.rub),
            "lb": _vec(self.lb),
            "ub": _vec(self.ub),
            "c0": float(self.c0),
            "name": self.name,
            "maximize": bool(self.maximize),
            "shape": [int(self.m), int(self.n)],
        }
        if _is_sparse(self.A):
            coo = self.A.tocoo()
            d["A_coo"] = {
                "row": [int(i) for i in coo.row],
                "col": [int(j) for j in coo.col],
                "val": [float(v) for v in coo.data],
            }
        else:
            d["A"] = [[float(v) for v in row] for row in np.asarray(self.A)]
        if self.block_structure:
            # Hints carry ints (block sizes), strings ("kind") and index
            # arrays (detection's row_block/col_block) — all must survive
            # the journal round-trip, not just the int fields.
            def _hint_val(v):
                if isinstance(v, str):
                    return v
                if isinstance(v, np.ndarray):
                    return [int(x) for x in v.ravel()]
                if isinstance(v, (list, tuple)):
                    return [int(x) for x in v]
                return int(v)

            d["block_structure"] = {
                k: _hint_val(v) for k, v in self.block_structure.items()
            }
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "LPProblem":
        """Inverse of :meth:`to_dict`."""

        def _vec(v):
            # float("inf")/float("-inf") parse the to_dict sentinels.
            return np.array([float(x) for x in v], dtype=np.float64)

        m, n = (int(v) for v in d["shape"])
        if "A_coo" in d:
            coo = d["A_coo"]
            A: Matrix = sp.csr_matrix(
                (coo["val"], (coo["row"], coo["col"])), shape=(m, n)
            )
        else:
            A = np.asarray(d["A"], dtype=np.float64).reshape(m, n)
        hint = d.get("block_structure")
        if hint is not None:
            # Index arrays were listified by to_dict; the block backends
            # consume them as numpy arrays.
            hint = {
                k: (
                    np.asarray(v, dtype=np.int64)
                    if isinstance(v, list)
                    else v
                )
                for k, v in hint.items()
            }
        return cls(
            c=_vec(d["c"]),
            A=A,
            rlb=_vec(d["rlb"]),
            rub=_vec(d["rub"]),
            lb=_vec(d["lb"]),
            ub=_vec(d["ub"]),
            c0=float(d.get("c0", 0.0)),
            name=str(d.get("name", "LP")),
            maximize=bool(d.get("maximize", False)),
            block_structure=hint,
        )

    def row_activity(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(self.A @ x).ravel()

    def max_violation(self, x: np.ndarray) -> float:
        """Worst constraint/bound violation of ``x`` (0 if feasible)."""
        ax = self.row_activity(x)
        v = 0.0
        v = max(v, float(np.max(self.rlb - ax, initial=0.0)))
        v = max(v, float(np.max(ax - self.rub, initial=0.0)))
        v = max(v, float(np.max(self.lb - x, initial=0.0)))
        v = max(v, float(np.max(x - self.ub, initial=0.0)))
        return v


# Column transform codes recorded by to_interior_form for solution recovery.
_SHIFT = 0  # x_orig = x_tilde + lb
_NEGSHIFT = 1  # x_orig = -(x_tilde + (-ub))  [upper bound only]
_FREE = 2  # x_orig = x_plus - x_minus (two tilde columns)
_SLACK = 3  # synthetic slack column (no original counterpart)


@dataclasses.dataclass
class InteriorForm:
    """Canonical IPM form: ``min cᵀx  s.t.  Ax = b, 0 ≤ x, x_j ≤ u_j (u_j may be +inf)``.

    ``u`` is +inf where the variable is only bounded below. ``has_ub`` is the
    boolean mask of finite upper bounds (precomputed for the IPM's boundary
    handling). Recovery metadata maps tilde-columns back to original columns.
    """

    c: np.ndarray  # (nt,)
    A: Matrix  # (m, nt)
    b: np.ndarray  # (m,)
    u: np.ndarray  # (nt,) finite or +inf upper bounds (lower bounds are 0)
    c0: float  # objective constant (includes contributions of shifts)
    # recovery metadata
    orig_n: int
    col_kind: np.ndarray  # (nt,) one of _SHIFT/_NEGSHIFT/_FREE/_SLACK
    col_orig: np.ndarray  # (nt,) original column index (-1 for slacks)
    col_shift: np.ndarray  # (nt,) additive shift applied before sign flip
    col_sign: np.ndarray  # (nt,) +1 or -1
    name: str = "LP"
    block_structure: Optional[dict] = None  # propagated LPProblem hint
    # Baseline contribution per original column: nonzero only for fixed
    # (lb == ub) columns, which are substituted out during conversion — a
    # zero-width interior variable (u = 0) has no interior point and
    # breaks the IPM's 1/x arithmetic.
    x_base: Optional[np.ndarray] = None

    @property
    def m(self) -> int:
        return self.A.shape[0]

    @property
    def n(self) -> int:
        return self.A.shape[1]

    @property
    def has_ub(self) -> np.ndarray:
        return np.isfinite(self.u)

    def recover(self, x_tilde: np.ndarray) -> np.ndarray:
        """Map an interior-form solution back to the original variable space."""
        x = (
            np.zeros(self.orig_n, dtype=np.float64)
            if self.x_base is None
            else np.asarray(self.x_base, dtype=np.float64).copy()
        )
        contrib = self.col_sign * (np.asarray(x_tilde, dtype=np.float64) + self.col_shift)
        mask = self.col_orig >= 0
        np.add.at(x, self.col_orig[mask], contrib[mask])
        return x

    def objective(self, x_tilde: np.ndarray) -> float:
        return float(self.c @ x_tilde) + self.c0


def to_interior_form(p: LPProblem) -> InteriorForm:
    """Convert a general-form :class:`LPProblem` to :class:`InteriorForm`.

    Transformations, in order:

    1. Every non-equality row ``rlb ≤ aᵀx ≤ rub`` gains a slack column:
       ``aᵀx - s = 0`` with ``rlb ≤ s ≤ rub`` — all rows become equalities
       with rhs 0, and row-bound information moves onto the slack's bounds.
    2. Columns (including slacks) are normalized to ``0 ≤ x̃ ≤ ũ``:
       finite-lb columns are shifted (``x = x̃ + lb``); upper-bound-only
       columns are negated then shifted (``x = -(x̃ - ub)``); free columns
       are split (``x = x̃⁺ - x̃⁻``). The rhs absorbs the shifts.

    Works for dense ndarray and scipy-sparse ``A``; sparse stays sparse (CSC
    during column surgery, returned as CSR).
    """
    m, n = p.shape
    sparse = _is_sparse(p.A)

    # Fixed columns (lb == ub) are substituted out up front: a zero-width
    # variable has no interior point (u = 0 ⇒ x̃ = 0 on the boundary) and
    # wrecks the IPM's 1/x arithmetic. The substitution moves a·v into the
    # row bounds and c·v into the objective constant; recovery restores the
    # value via ``x_base``.
    fixed = np.isfinite(p.lb) & (p.ub <= p.lb)  # validated lb <= ub
    if fixed.any():
        keep = np.flatnonzero(~fixed)
        fidx = np.flatnonzero(fixed)
        v = p.lb[fixed]
        Ac = p.A.tocsc() if sparse else p.A
        shift_rows = np.asarray(Ac[:, fidx] @ v).ravel()
        q = LPProblem(
            c=p.c[keep],
            A=Ac[:, keep],
            rlb=np.where(np.isfinite(p.rlb), p.rlb - shift_rows, p.rlb),
            rub=np.where(np.isfinite(p.rub), p.rub - shift_rows, p.rub),
            lb=p.lb[keep],
            ub=p.ub[keep],
            c0=p.c0 + float(p.c[fidx] @ v),
            name=p.name,
            maximize=p.maximize,
            block_structure=p.block_structure,
        )
        inf = to_interior_form(q)
        x_base = np.zeros(n)
        x_base[fidx] = v
        # Remap reduced column indices back to the original numbering.
        col_orig = inf.col_orig.copy()
        live = col_orig >= 0
        col_orig[live] = keep[col_orig[live]]
        return dataclasses.replace(
            inf, orig_n=n, col_orig=col_orig, x_base=x_base
        )

    is_eq = (p.rlb == p.rub) & np.isfinite(p.rlb)
    ineq_rows = np.flatnonzero(~is_eq)
    n_slack = len(ineq_rows)

    # --- step 1: append slack columns; rows become Ax - s = rhs_eq ---------
    if sparse:
        A = sp.csc_matrix(p.A, dtype=np.float64)
        if n_slack:
            S = sp.csc_matrix(
                (-np.ones(n_slack), (ineq_rows, np.arange(n_slack))),
                shape=(m, n_slack),
            )
            A = sp.hstack([A, S], format="csc")
    else:
        A = np.asarray(p.A, dtype=np.float64)
        if n_slack:
            S = np.zeros((m, n_slack))
            S[ineq_rows, np.arange(n_slack)] = -1.0
            A = np.hstack([A, S])

    b = np.where(is_eq, p.rlb, 0.0).astype(np.float64)
    c = np.concatenate([p.c, np.zeros(n_slack)])
    lb = np.concatenate([p.lb, p.rlb[ineq_rows]])
    ub = np.concatenate([p.ub, p.rub[ineq_rows]])
    col_orig = np.concatenate(
        [np.arange(n), np.full(n_slack, -1, dtype=np.int64)]
    ).astype(np.int64)
    is_slack = col_orig < 0

    # --- step 2: normalize columns to 0 ≤ x̃ ≤ ũ ---------------------------
    lb_f = np.isfinite(lb)
    ub_f = np.isfinite(ub)
    free = ~lb_f & ~ub_f
    negate = ~lb_f & ub_f  # upper bound only → flip sign

    sign = np.where(negate, -1.0, 1.0)
    # After sign flip the effective bounds are [-ub, -lb] for negated cols.
    lo = np.where(negate, -ub, lb)
    hi = np.where(negate, -lb, ub)
    shift = np.where(np.isfinite(lo), lo, 0.0)  # free cols have shift 0

    n_free = int(np.count_nonzero(free))
    free_idx = np.flatnonzero(free)

    # Apply sign to A columns, then fold the shift into b: A(x̃+shift)=b_eq
    # → A x̃ = b_eq - A·shift  (using the signed A).
    if sparse:
        D = sp.diags(sign)
        A = (A @ D).tocsc()
        b = b - A @ shift
        if n_free:
            A_neg = -A[:, free_idx]
            A = sp.hstack([A, A_neg], format="csr")
        else:
            A = A.tocsr()
    else:
        A = A * sign[None, :]
        b = b - A @ shift
        if n_free:
            A = np.hstack([A, -A[:, free_idx]])

    c_signed = c * sign
    c0 = p.c0 + float(c_signed @ shift)
    u_t = hi - shift  # 0-based upper bounds; inf stays inf
    u_t = np.where(np.isfinite(hi), u_t, _INF)

    if n_free:
        c_t = np.concatenate([c_signed, -c_signed[free_idx]])
        u_t = np.concatenate([u_t, np.full(n_free, _INF)])
        col_orig_t = np.concatenate([col_orig, col_orig[free_idx]])
        shift_t = np.concatenate([shift, np.zeros(n_free)])
        sign_t = np.concatenate([sign, -np.ones(n_free)])
        kind = np.where(is_slack, _SLACK, np.where(free, _FREE, np.where(negate, _NEGSHIFT, _SHIFT))).astype(np.int8)
        kind_t = np.concatenate([kind, np.full(n_free, _FREE, dtype=np.int8)])
    else:
        c_t = c_signed
        col_orig_t = col_orig
        shift_t = shift
        sign_t = sign
        kind_t = np.where(is_slack, _SLACK, np.where(negate, _NEGSHIFT, _SHIFT)).astype(np.int8)

    # Slack columns never contribute to recovery.
    col_orig_t = np.where(kind_t == _SLACK, -1, col_orig_t)

    return InteriorForm(
        c=c_t,
        A=A,
        b=b,
        u=u_t,
        c0=c0,
        orig_n=n,
        col_kind=kind_t,
        col_orig=col_orig_t.astype(np.int64),
        col_shift=shift_t,
        col_sign=sign_t,
        name=p.name,
        block_structure=p.block_structure,
    )
