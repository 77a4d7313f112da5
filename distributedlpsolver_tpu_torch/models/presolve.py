"""Structural presolve for general-form LPs (+ exact postsolve).

SURVEY.md §0.1 item 5 lists "presolve / scaling / ordering steps" as a
reference capability to verify; with the reference tree unavailable
(SURVEY.md §0) this module implements the standard reduction set every
production LP solver applies before the IPM sees the problem:

* **empty rows** — feasibility-checked and dropped;
* **singleton rows** — one live nonzero ``a·x_j ∈ [rlb, rub]`` becomes a
  bound on ``x_j`` and the row is dropped (dual recovered at postsolve);
* **fixed columns** (``lb == ub``) — substituted into the rhs and the
  objective constant;
* **empty columns** — set to their cost-optimal bound (detecting primal
  unboundedness when that bound is infinite);
* **redundant rows** — rows whose activity range, implied by the column
  bounds, already lies inside ``[rlb, rub]`` (skipped for large dense
  matrices where the scan would cost more than it saves);
* **infeasibility** — crossing bounds / unsatisfiable rows found during
  any of the above.

Reductions iterate to a fixpoint (a singleton row may fix a column, which
may empty another row, ...). The returned :class:`PresolveInfo` maps a
solution of the reduced problem back to the original space — primal
*and* dual: removed rows get exact multipliers (zero for redundant rows;
the absorbed reduced cost ``s_j / a`` for a singleton row whose derived
bound is binding), and the full reduced-cost vector is re-derived as
``s = c - Aᵀy`` so dual feasibility holds by construction.

Everything here is host-side NumPy/SciPy — presolve is a per-problem
O(nnz) pass, not device work. Counts are maintained *incrementally*
(eliminating a column decrements only the rows it touches) so a no-op
presolve on a large dense matrix costs one scan and no large temporaries.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from distributedlpsolver_tpu_torch.ipm.state import Status
from distributedlpsolver_tpu_torch.models.problem import LPProblem

_INF = np.inf

# Above this many dense entries the redundant-row activity scan (which
# needs sign-split full passes over A) is skipped: a large *dense* LP has
# essentially no removable rows and the temporaries are real memory.
_DENSE_SCAN_LIMIT = 1 << 25


@dataclasses.dataclass
class _SingletonRow:
    """Provenance of a bound derived from a singleton row (dual recovery)."""

    row: int
    col: int
    coeff: float
    lo: float  # derived lower bound on x_col (-inf if none)
    hi: float  # derived upper bound on x_col (+inf if none)


@dataclasses.dataclass
class PresolveInfo:
    """Reduction record; maps reduced-space solutions back to the original.

    ``status`` is non-None when presolve itself settled the problem:
    ``OPTIMAL`` (every variable fixed), ``PRIMAL_INFEASIBLE``, or
    ``DUAL_INFEASIBLE`` (primal unbounded — reported only when the
    remaining problem is trivially feasible, otherwise presolve returns
    the reduced problem and lets the IPM decide).
    """

    orig_m: int
    orig_n: int
    row_live: np.ndarray  # (m,) bool — rows kept in the reduced problem
    col_live: np.ndarray  # (n,) bool — columns kept
    xfix: np.ndarray  # (n,) fixed values (NaN where live)
    singletons: List[_SingletonRow]
    lb0: np.ndarray  # original column bounds (binding-side attribution)
    ub0: np.ndarray
    status: Optional[Status] = None
    objective: Optional[float] = None  # set when status == OPTIMAL
    reductions: dict = dataclasses.field(default_factory=dict)

    @property
    def reduced_shape(self) -> Tuple[int, int]:
        return int(self.row_live.sum()), int(self.col_live.sum())

    def postsolve_x(self, x_red: np.ndarray) -> np.ndarray:
        """Reduced-space primal solution → original space."""
        x = self.xfix.copy()
        x[self.col_live] = np.asarray(x_red, dtype=np.float64)
        # Fully-fixed problems may postsolve with an empty x_red.
        return np.nan_to_num(x, nan=0.0) if np.isnan(x).any() else x

    def postsolve_duals(
        self, p: LPProblem, x_full: np.ndarray, y_red: Optional[np.ndarray]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Recover ``(y, s)`` for the original problem (minimized sense).

        ``y`` are row multipliers, ``s = c - Aᵀy`` reduced costs. Dropped
        rows get ``y = 0`` except singleton rows whose derived bound is
        binding at ``x_full`` and strictly tighter than the original
        column bound — those absorb the column's reduced cost
        (``y = s_j / a``), which keeps complementary slackness and strong
        duality exact instead of leaving a phantom bound multiplier.
        """
        y = np.zeros(self.orig_m, dtype=np.float64)
        if y_red is not None and self.row_live.any():
            y[self.row_live] = np.asarray(y_red, dtype=np.float64)
        A = p.A.tocsc() if sp.issparse(p.A) else np.asarray(p.A)

        def scol(j: int) -> float:  # current reduced cost of column j
            return float(p.c[j] - (A[:, j].T @ y))

        # Replay singleton-row eliminations in REVERSE chronological order,
        # recomputing the column's reduced cost against the *current* y each
        # time. A cascade can put an earlier-eliminated column back into a
        # later singleton row (x0 fixed by row 0 turns row 1 = x0+x1 into a
        # singleton on x1); assigning every multiplier from one pre-pass
        # snapshot of s would then double-count and hand back a
        # dual-infeasible certificate. Reverse replay processes row 1's
        # multiplier first, so row 0's attribution sees its effect on x0's
        # reduced cost.
        btol = 1e-7
        for rec in reversed(self.singletons):
            j = rec.col
            sj = scol(j)
            if abs(sj) <= 1e-9 * (1.0 + abs(p.c[j])):
                continue
            if sj > 0:  # binding at a lower bound
                bound, orig = rec.lo, self.lb0[j]
            else:  # binding at an upper bound
                bound, orig = rec.hi, self.ub0[j]
            if not np.isfinite(bound):
                continue
            scale = 1.0 + abs(bound)
            row_supplies_bound = (
                abs(x_full[j] - bound) <= btol * scale
                and (not np.isfinite(orig) or abs(bound - orig) > btol * scale)
            )
            if row_supplies_bound:
                y[rec.row] = sj / rec.coeff
        s = p.c - np.asarray(p.A.T @ y).ravel()
        return y, s


class _Entries:
    """Uniform (rows, vals) / (cols, vals) access over dense or sparse A."""

    def __init__(self, A):
        self.sparse = sp.issparse(A)
        if self.sparse:
            self.Ac = A.tocsc()
            self.Ac.eliminate_zeros()
            self.Ar = self.Ac.tocsr()
        else:
            self.A = np.asarray(A, dtype=np.float64)
        self._split = None

    def sign_split(self):
        """Loop-invariant (pos, neg, pat_p, pat_n) operands of the
        activity-bound scan, built once and reused across presolve rounds
        (A never changes; only bounds and liveness do)."""
        if self._split is None:
            if self.sparse:
                pos = self.Ar.maximum(0)
                neg = self.Ar.minimum(0)
            else:
                pos = np.clip(self.A, 0.0, None)
                neg = self.A - pos
            self._split = (
                pos,
                neg,
                (pos != 0).astype(np.float64),
                (neg != 0).astype(np.float64),
            )
        return self._split

    def row_nnz(self) -> np.ndarray:
        if self.sparse:
            return np.diff(self.Ar.indptr).astype(np.int64)
        return np.count_nonzero(self.A, axis=1).astype(np.int64)

    def col_nnz(self) -> np.ndarray:
        if self.sparse:
            return np.diff(self.Ac.indptr).astype(np.int64)
        return np.count_nonzero(self.A, axis=0).astype(np.int64)

    def col(self, j: int) -> Tuple[np.ndarray, np.ndarray]:
        if self.sparse:
            sl = slice(self.Ac.indptr[j], self.Ac.indptr[j + 1])
            return self.Ac.indices[sl], self.Ac.data[sl]
        col = self.A[:, j]
        rows = np.flatnonzero(col)
        return rows, col[rows]

    def row(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        if self.sparse:
            sl = slice(self.Ar.indptr[i], self.Ar.indptr[i + 1])
            return self.Ar.indices[sl], self.Ar.data[sl]
        row = self.A[i, :]
        cols = np.flatnonzero(row)
        return cols, row[cols]


def _activity_bounds(E: _Entries, lb, ub, col_live):
    """Vectorized per-row (min, max) of ``Σ_j a_ij x_j`` over live columns
    within their bounds. Dead columns contribute 0 (their substituted value
    already moved into the row bounds). Infinite bounds propagate to ±inf
    via sign-pattern matmuls, so no ``0 · inf`` NaNs arise."""
    lbe = np.where(col_live, lb, 0.0)
    ube = np.where(col_live, ub, 0.0)
    linf = (~np.isfinite(lbe)).astype(np.float64)  # -inf lower bounds
    uinf = (~np.isfinite(ube)).astype(np.float64)  # +inf upper bounds
    lbf = np.where(np.isfinite(lbe), lbe, 0.0)
    ubf = np.where(np.isfinite(ube), ube, 0.0)
    pos, neg, pat_p, pat_n = E.sign_split()
    dot = (lambda M, v: np.asarray(M @ v).ravel()) if E.sparse else (lambda M, v: M @ v)
    minact = dot(pos, lbf) + dot(neg, ubf)
    maxact = dot(pos, ubf) + dot(neg, lbf)
    minact = np.where((dot(pat_p, linf) + dot(pat_n, uinf)) > 0, -_INF, minact)
    maxact = np.where((dot(pat_p, uinf) + dot(pat_n, linf)) > 0, _INF, maxact)
    return minact, maxact


def presolve(
    p: LPProblem,
    max_rounds: int = 10,
    feas_tol: float = 1e-9,
    redundant_rows: bool = True,
) -> Tuple[LPProblem, PresolveInfo]:
    """Apply structural reductions; returns ``(reduced, info)``.

    When ``info.status`` is non-None the problem was settled during
    presolve and ``reduced`` should not be solved (it may be degenerate).
    The reduced problem drops any ``block_structure`` hint — row/column
    indices no longer align with it.
    """
    m, n = p.shape
    E = _Entries(p.A)
    rlb = p.rlb.astype(np.float64).copy()
    rub = p.rub.astype(np.float64).copy()
    lb = p.lb.astype(np.float64).copy()
    ub = p.ub.astype(np.float64).copy()
    c = p.c
    c0 = float(p.c0)

    row_live = np.ones(m, dtype=bool)
    col_live = np.ones(n, dtype=bool)
    xfix = np.full(n, np.nan)
    singletons: List[_SingletonRow] = []
    red = {
        "empty_rows": 0, "singleton_rows": 0, "fixed_cols": 0,
        "empty_cols": 0, "redundant_rows": 0, "rounds": 0,
    }
    info = PresolveInfo(
        orig_m=m, orig_n=n, row_live=row_live, col_live=col_live,
        xfix=xfix, singletons=singletons, lb0=p.lb.copy(), ub0=p.ub.copy(),
        reductions=red,
    )

    row_cnt = E.row_nnz()
    col_cnt = E.col_nnz()
    unbounded_cols: set = set()  # empty cols whose optimal bound is infinite

    def tol_of(*vals) -> float:
        fin = [abs(v) for v in vals if np.isfinite(v)]
        return feas_tol * (1.0 + max(fin, default=0.0))

    def infeasible() -> Tuple[LPProblem, PresolveInfo]:
        info.status = Status.PRIMAL_INFEASIBLE
        return _build_reduced(p, info, rlb, rub, lb, ub, c0), info

    def kill_row(i: int) -> None:
        row_live[i] = False
        cols, _ = E.row(i)
        col_cnt[cols] -= 1

    def fix_col(j: int, v: float) -> None:
        nonlocal c0
        xfix[j] = v
        col_live[j] = False
        c0 += float(c[j]) * v
        rows, vals = E.col(j)
        live = row_live[rows]
        rows, vals = rows[live], vals[live]
        rlb[rows] = np.where(np.isfinite(rlb[rows]), rlb[rows] - vals * v, rlb[rows])
        rub[rows] = np.where(np.isfinite(rub[rows]), rub[rows] - vals * v, rub[rows])
        row_cnt[rows] -= 1

    for rnd in range(max_rounds):
        changed = False
        red["rounds"] = rnd + 1

        # --- rows: empty + singleton -----------------------------------
        for i in np.flatnonzero(row_live & (row_cnt <= 1)):
            if row_cnt[i] == 0:
                if rlb[i] > tol_of(rlb[i]) or rub[i] < -tol_of(rub[i]):
                    return infeasible()
                kill_row(i)
                red["empty_rows"] += 1
                changed = True
                continue
            cols, vals = E.row(i)
            live = col_live[cols]
            cols, vals = cols[live], vals[live]
            if len(cols) != 1:  # stale count (already-eliminated col)
                continue
            j, a = int(cols[0]), float(vals[0])
            lo_b, hi_b = rlb[i] / a, rub[i] / a
            if a < 0:
                lo_b, hi_b = hi_b, lo_b
            lo_b = lo_b if np.isfinite(lo_b) else -_INF
            hi_b = hi_b if np.isfinite(hi_b) else _INF
            singletons.append(_SingletonRow(i, j, a, lo_b, hi_b))
            lb[j] = max(lb[j], lo_b)
            ub[j] = min(ub[j], hi_b)
            kill_row(i)
            red["singleton_rows"] += 1
            changed = True

        # --- bound sanity ----------------------------------------------
        live_idx = np.flatnonzero(col_live)
        bad = lb[live_idx] > ub[live_idx] + feas_tol * (
            1.0 + np.abs(np.where(np.isfinite(ub[live_idx]), ub[live_idx], 0.0))
        )
        if bad.any():
            return infeasible()

        # --- columns: fixed + empty ------------------------------------
        for j in live_idx:
            if col_cnt[j] == 0:
                if j in unbounded_cols:
                    continue
                # Cost decides the optimal value; an infinite optimal bound
                # means the problem is unbounded *if* the rest is feasible —
                # leave the column live so the IPM settles that question.
                # The costless branch requires c_j == 0 EXACTLY: a
                # tiny-but-real cost with wide bounds contributes up to
                # |c_j|*(ub-lb) objective error if fixed at an arbitrary
                # feasible value instead of its cost-optimal bound.
                if c[j] > 0.0:
                    v = lb[j]
                elif c[j] < 0.0:
                    v = ub[j]
                else:  # costless: any feasible value (finite by lb<=ub)
                    v = min(max(0.0, lb[j]), ub[j])
                if np.isfinite(v):
                    fix_col(j, float(v))
                    red["empty_cols"] += 1
                    changed = True
                else:
                    unbounded_cols.add(int(j))
            elif ub[j] - lb[j] <= 1e-14 * (1.0 + abs(lb[j])) and np.isfinite(lb[j]):
                fix_col(j, 0.5 * (lb[j] + ub[j]))
                red["fixed_cols"] += 1
                changed = True

        # --- redundant / infeasible rows by activity bounds ------------
        scan_ok = E.sparse or (m * n <= _DENSE_SCAN_LIMIT)
        if redundant_rows and scan_ok and row_live.any():
            minact, maxact = _activity_bounds(E, lb, ub, col_live)
            t = feas_tol * (
                1.0
                + np.abs(np.where(np.isfinite(rlb), rlb, 0.0))
                + np.abs(np.where(np.isfinite(rub), rub, 0.0))
            )
            live_rows = np.flatnonzero(row_live & (row_cnt > 1))
            if ((minact[live_rows] > rub[live_rows] + t[live_rows])
                    | (maxact[live_rows] < rlb[live_rows] - t[live_rows])).any():
                return infeasible()
            for i in live_rows[
                (minact[live_rows] >= rlb[live_rows] - t[live_rows])
                & (maxact[live_rows] <= rub[live_rows] + t[live_rows])
            ]:
                kill_row(int(i))
                red["redundant_rows"] += 1
                changed = True

        if not changed:
            break

    reduced = _build_reduced(p, info, rlb, rub, lb, ub, c0)
    if not col_live.any():
        # Fully solved by presolve; verify any remaining rows.
        x = info.postsolve_x(np.empty(0))
        if p.max_violation(x) > 1e-6:
            info.status = Status.PRIMAL_INFEASIBLE
        else:
            info.status = Status.OPTIMAL
            info.objective = float(p.c @ x) + float(p.c0)
    elif unbounded_cols and not row_live.any():
        # Every constraint row is gone, so the problem is trivially
        # feasible — an unbounded column settles it as primal-unbounded.
        info.status = Status.DUAL_INFEASIBLE
    return reduced, info


def _build_reduced(p, info, rlb, rub, lb, ub, c0) -> LPProblem:
    rl, cl = info.row_live, info.col_live
    ridx, cidx = np.flatnonzero(rl), np.flatnonzero(cl)
    if sp.issparse(p.A):
        A = p.A.tocsr()[ridx][:, cidx]
    else:
        A = np.asarray(p.A, dtype=np.float64)[np.ix_(ridx, cidx)]
    remap = -np.ones(info.orig_n, dtype=np.int64)
    remap[cidx] = np.arange(len(cidx))
    # Tolerated tiny crossings (within feas_tol) must not trip the
    # constructor's strict lb<=ub / rlb<=rub validation.
    return LPProblem(
        c=p.c[cidx],
        A=A,
        rlb=np.minimum(rlb, rub)[ridx],
        rub=rub[ridx],
        lb=np.minimum(lb, ub)[cidx],
        ub=ub[cidx],
        c0=c0,
        name=p.name,
        row_names=[p.row_names[i] for i in ridx] if p.row_names else None,
        col_names=[p.col_names[j] for j in cidx] if p.col_names else None,
        integer_cols=[int(remap[j]) for j in p.integer_cols if remap[j] >= 0],
        maximize=p.maximize,
        block_structure=None,  # indices no longer align with any hint
    )
