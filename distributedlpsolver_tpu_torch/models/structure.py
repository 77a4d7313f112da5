"""Automatic block-angular structure detection.

A copy of the JAX package's ``models/structure.py`` (numpy and scipy
only): ``backends/auto.py`` routes hint-less sparse problems with it.

The reference's core distributed path row-partitions block-angular
problems (pds-* multicommodity flow, stormG2 stochastic programs —
BASELINE.json:8) and combines per-block Schur contributions with an
all-reduce (BASELINE.json:5). Generated problems carry an explicit
``block_structure`` hint; real MPS files do not. This module recovers the
structure from the sparsity pattern alone, so hint-less problems still
route to the Schur backend (backends/block_angular.py) instead of the
dense path.

Method (deterministic, O(trials · nnz) with a union-find):

1. Candidate *linking* rows are the densest rows — a block-angular matrix
   in arrow form has linking rows touching many blocks' columns while
   block rows touch only their own. Trials sweep a decreasing nnz
   threshold (each trial marks rows with nnz ≥ threshold as linking).
2. For each trial, union-find over columns joins the columns of every
   non-linking row; the resulting column components are the candidate
   blocks. A trial succeeds when there are ≥ ``min_blocks`` components,
   the linking set stays under ``max_link_frac``·m, and the row padding
   the backend would pay (blocks are padded to the largest) stays under
   ``max_pad_ratio``.
3. Components are bin-packed (largest first into the lightest bin) into
   ``target_blocks`` groups so block row counts are balanced — a union of
   components is still block-angular.

Returns the generalized hint consumed by the block backend:
``{"num_blocks": K, "row_block": (m,) int array}`` with ``-1`` marking
linking rows. Detection never raises on unsuitable inputs — it returns
``None`` and callers fall back to the dense/sparse paths.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import scipy.sparse as sp

from distributedlpsolver_tpu_torch.models.problem import LPProblem

# Dense matrices above this entry count are not scanned (detection needs a
# sparse pattern; a big dense LP has no block structure worth finding).
_DENSE_LIMIT = 1 << 24


def detect_block_structure(
    problem: Union[LPProblem, np.ndarray, sp.spmatrix],
    min_blocks: int = 2,
    max_link_frac: float = 0.25,
    max_pad_ratio: float = 1.5,
    target_blocks: Optional[int] = None,
    max_trials: int = 8,
) -> Optional[dict]:
    """Recover a block-angular row partition from the sparsity pattern.

    ``target_blocks`` caps the number of blocks (components are bin-packed
    into that many groups); the default keeps the NATURAL component count
    (capped at 256) — merging distinct blocks squares their share of the
    per-block assembly/Cholesky flops on known-zero cross terms, so the
    partition the sparsity pattern actually has is the cheapest one to
    execute. Returns ``{"num_blocks", "row_block"}`` or ``None`` when no
    acceptable structure exists.
    """
    A = problem.A if isinstance(problem, LPProblem) else problem
    if not sp.issparse(A):
        A = np.asarray(A)
        if A.size > _DENSE_LIMIT:
            return None
        A = sp.csr_matrix(A)
    R = A.tocsr()
    m, n = R.shape
    if m < 2 * min_blocks or n < 2 * min_blocks:
        return None
    nnz_row = np.diff(R.indptr)

    # Threshold sweep: from "only the very densest rows are linking" toward
    # the linking-budget limit. Use nnz quantiles so the sweep adapts to
    # the pattern instead of absolute counts.
    qs = np.unique(
        np.quantile(nnz_row, [1.0, 0.99, 0.97, 0.95, 0.9, 0.85, 0.8, 0.75])
    )[::-1]
    best = None
    trials = 0
    for thr in qs:
        if trials >= max_trials:
            break
        trials += 1
        linking = nnz_row >= max(thr, 1)
        # Degenerate sweep points: all rows linking, or none. The strict
        # linking budget is enforced after refinement below; this loose
        # pre-check just bounds the component work.
        n_link = int(linking.sum())
        if n_link == 0 or n_link > 0.5 * m:
            continue
        # Connected components of the bipartite (non-linking rows, cols)
        # graph — all C-speed. Components holding only columns (border
        # columns untouched by block rows) are irrelevant: components are
        # re-indexed over the rows that appear.
        block_rows = np.flatnonzero(~linking)
        Rsub = R[block_rows]
        G = sp.bmat([[None, Rsub], [Rsub.T, None]], format="csr")
        _, labels = sp.csgraph.connected_components(G, directed=False)
        row_labels = labels[: len(block_rows)]
        # Empty rows form singleton components; park them with the linking
        # set (they contribute nothing to any block's Cholesky).
        nonempty = np.diff(Rsub.indptr) > 0
        uniq, packed = np.unique(row_labels[nonempty], return_inverse=True)
        comp_of_row = np.full(m, -1, dtype=np.int64)
        comp_of_row[block_rows[nonempty]] = packed
        n_comp = len(uniq)
        if n_comp < min_blocks:  # also covers uniq empty (all rows empty)
            continue
        # Refinement: the nnz threshold over-marks dense *block* rows as
        # linking. A marked row whose columns all sit inside ONE component
        # is really a block row — reassign it (true linking rows span
        # several components and stay). Shrinks the dense Schur system.
        col_labels = labels[len(block_rows) :]
        pos = np.searchsorted(uniq, col_labels)
        pos_c = np.minimum(pos, len(uniq) - 1)
        comp_of_col = np.where(uniq[pos_c] == col_labels, pos_c, -1)
        for i in np.flatnonzero(linking):
            cols = R.indices[R.indptr[i] : R.indptr[i + 1]]
            comps = np.unique(comp_of_col[cols])
            if len(comps) == 1 and comps[0] >= 0:
                comp_of_row[i] = comps[0]
        n_link = int((comp_of_row == -1).sum())
        if n_link > max_link_frac * m:
            continue
        # Balance check at the component level: row padding the backend
        # pays is K·max(rows) / Σrows once grouped; grouping can only
        # improve it, so test after grouping below.
        #
        # Default K = the NATURAL component count (capped at 256): the
        # block backend's per-iteration cost is K·(mb²·nb + mb³/3) with
        # mb ≈ m/K, so merging c components into one multiplies their
        # assembly/factor flops by ~c² — on a 20k-row, 256-block
        # stormG2-class instance, packing into 16 super-blocks costs
        # ~250× the flops of the natural partition, all spent on known-
        # zero cross terms. Tiny blocks batch fine (vmap'd Cholesky).
        # IMBALANCED natural partitions (one big component among many
        # small) fail the pad-ratio test at the natural K, so halve K
        # until bin-packing balances the groups — the flop-optimal K
        # that still passes, falling back toward the coarse packing an
        # explicit target would give. An EXPLICIT target_blocks is a
        # single attempt (the caller asked for exactly that K).
        K = min(n_comp, target_blocks or 256)
        while True:
            row_block = _pack_components(comp_of_row, n_comp, K)
            sizes = np.bincount(row_block[row_block >= 0], minlength=K)
            pad_ratio = K * sizes.max() / max(sizes.sum(), 1)
            if sizes.min() > 0 and pad_ratio <= max_pad_ratio:
                break
            if target_blocks is not None or K <= max(min_blocks, 2):
                row_block = None
                break
            K = max(K // 2, max(min_blocks, 2))
        if row_block is None:
            continue
        cand = {"num_blocks": K, "row_block": row_block, "link_rows": n_link,
                "pad_ratio": float(pad_ratio)}
        # Prefer the trial with the fewest linking rows that passes —
        # linking rows are the dense Schur system everyone pays for.
        if best is None or n_link < best["link_rows"]:
            best = cand
    if best is None:
        return None
    return {"num_blocks": int(best["num_blocks"]), "row_block": best["row_block"]}


def detect_two_stage(
    problem: Union[LPProblem, np.ndarray, sp.spmatrix],
    min_scenarios: int = 2,
    max_first_frac: float = 0.25,
    max_pad_ratio: float = 1.5,
    max_trials: int = 8,
) -> Optional[dict]:
    """Recover a TWO-STAGE (bordered / dual block-angular) structure from
    the sparsity pattern: scenario row blocks that couple only through a
    small set of shared first-stage COLUMNS (the transpose of the
    primal block-angular arrow :func:`detect_block_structure` finds —
    there the border is dense linking ROWS).

    Method: candidate first-stage columns are the densest columns (a
    first-stage column carries T-entries from every scenario; a
    recourse column only its own block's). Trials sweep a decreasing
    column-nnz threshold; for each trial the border columns are
    stripped, connected components of the remaining (row, column)
    bipartite graph are the candidate scenario blocks, and rows left
    empty by the strip (they touch only first-stage columns) are the
    first-stage rows. A border column whose rows all sit in ONE
    component is really scenario-local and is reassigned (the exact
    mirror of the linking-row refinement above).

    Returns the generalized ``two_stage`` hint consumed by
    backends/auto routing, the scenario engine's layout resolution,
    and — on first-stage-row-free patterns — the bordered-Woodbury
    preconditioner::

        {"kind": "two_stage", "num_blocks": K,
         "row_block": (m,) int array (-1 = first-stage row),
         "col_block": (n,) int array (-1 = first-stage column),
         "first_stage_n": n0, "first_stage_m": m0,
         "block_m": max rows/block, "block_n": max cols/block}

    Never raises on unsuitable inputs — returns ``None`` and callers
    fall back to the other rungs.
    """
    A = problem.A if isinstance(problem, LPProblem) else problem
    if not sp.issparse(A):
        A = np.asarray(A)
        if A.size > _DENSE_LIMIT:
            return None
        A = sp.csr_matrix(A)
    C = A.tocsc()
    m, n = C.shape
    if m < min_scenarios or n < 2 * min_scenarios:
        return None
    nnz_col = np.diff(C.indptr)

    qs = np.unique(
        np.quantile(nnz_col, [1.0, 0.99, 0.97, 0.95, 0.9, 0.85, 0.8, 0.75])
    )[::-1]
    best = None
    trials = 0
    R = C.tocsr()
    for thr in qs:
        if trials >= max_trials:
            break
        trials += 1
        border = nnz_col >= max(thr, 1)
        n_border = int(border.sum())
        if n_border == 0 or n_border > 0.5 * n:
            continue
        block_cols = np.flatnonzero(~border)
        Csub = C[:, block_cols]  # (m, n_block)
        G = sp.bmat([[None, Csub], [Csub.T, None]], format="csr")
        _, labels = sp.csgraph.connected_components(G, directed=False)
        row_labels = labels[:m]
        # Rows with no non-border entries are first-stage rows (their
        # singleton components are irrelevant).
        nonempty = np.asarray(Csub.getnnz(axis=1)).ravel() > 0
        uniq, packed = np.unique(row_labels[nonempty], return_inverse=True)
        row_block = np.full(m, -1, dtype=np.int64)
        row_block[nonempty] = packed
        K = len(uniq)
        if K < min_scenarios:
            continue
        col_labels = labels[m:]
        pos = np.searchsorted(uniq, col_labels)
        pos_c = np.minimum(pos, max(len(uniq) - 1, 0))
        comp_of_sub = np.where(uniq[pos_c] == col_labels, pos_c, -1)
        col_block = np.full(n, -1, dtype=np.int64)
        col_block[block_cols] = comp_of_sub
        # Refinement: a border column whose rows all sit in one
        # component is scenario-local (an over-marked dense recourse
        # column) — reassign it; true first-stage columns span blocks.
        for j in np.flatnonzero(border):
            rows = C.indices[C.indptr[j] : C.indptr[j + 1]]
            comps = np.unique(row_block[rows])
            comps = comps[comps >= 0]
            if len(comps) == 1:
                col_block[j] = comps[0]
        # Consistency: a first-stage row must touch only first-stage
        # columns. A -1 row whose (reassigned) columns sit in exactly
        # one block is that block's row; one spanning several blocks
        # breaks the arrow — the trial is not two-stage.
        consistent = True
        for i in np.flatnonzero(row_block == -1):
            cols = R.indices[R.indptr[i] : R.indptr[i + 1]]
            comps = np.unique(col_block[cols])
            comps = comps[comps >= 0]
            if len(comps) == 1:
                row_block[i] = comps[0]
            elif len(comps) > 1:
                consistent = False
                break
        if not consistent:
            continue
        # Empty columns constrain nothing and belong to no block; park
        # them with block 0 (a zero column in any W_k is inert) so the
        # first-stage set stays the true border — the bordered-Woodbury
        # preconditioner keys on its leading-contiguous layout.
        col_block[nnz_col == 0] = 0
        n0 = int((col_block == -1).sum())
        if n0 == 0 or n0 > max_first_frac * n:
            continue
        # A first-stage ROW must touch only first-stage columns; a row
        # assigned to block k must touch only first-stage + block-k
        # columns. Components guarantee the latter for non-border
        # columns; verify the refined assignment stayed consistent.
        sizes = np.bincount(row_block[row_block >= 0], minlength=K)
        csizes = np.bincount(col_block[col_block >= 0], minlength=K)
        if sizes.min() == 0 or csizes.min() == 0:
            continue
        pad = K * sizes.max() / max(sizes.sum(), 1)
        cpad = K * csizes.max() / max(csizes.sum(), 1)
        if pad > max_pad_ratio or cpad > max_pad_ratio:
            continue
        cand = {
            "kind": "two_stage",
            "num_blocks": int(K),
            "row_block": row_block,
            "col_block": col_block,
            "first_stage_n": n0,
            "first_stage_m": int((row_block == -1).sum()),
            "block_m": int(sizes.max()),
            "block_n": int(csizes.max()),
            "_n0": n0,
        }
        # Prefer the trial with the smallest first-stage column set —
        # those columns are the dense linking work every solve pays for.
        if best is None or n0 < best["_n0"]:
            best = cand
    if best is None:
        return None
    best.pop("_n0")
    return best


def column_block_ids(
    A_csc: sp.csc_matrix, row_block: np.ndarray, validate: bool = False
) -> np.ndarray:
    """Per-column block id from the CSC pattern: the block of the column's
    non-linking rows (-1 for border columns touched only by linking rows).

    Segment reductions over ``indptr`` — no per-column Python loop. With
    ``validate``, a column whose non-linking rows disagree on the block
    (min != max over the segment) raises — it breaks the arrow structure.
    Shared by the block backend's layout analysis and the tensor-footprint
    estimator, so the two can never diverge.
    """
    n = A_csc.shape[1]
    rb_vals = row_block[A_csc.indices]
    nnz_col = np.diff(A_csc.indptr)
    nz = np.flatnonzero(nnz_col > 0)
    block_of_col = np.full(n, -1, dtype=np.int64)
    if len(nz):
        vmax = np.maximum.reduceat(
            np.where(rb_vals >= 0, rb_vals, -1), A_csc.indptr[nz]
        )
        if validate:
            big = np.iinfo(np.int64).max
            vmin = np.minimum.reduceat(
                np.where(rb_vals >= 0, rb_vals, big), A_csc.indptr[nz]
            )
            spans = (vmax >= 0) & (vmin != vmax)
            if spans.any():
                k = int(np.argmax(spans))
                raise ValueError(
                    f"column {int(nz[k])} spans blocks "
                    f"[{int(vmin[k])}, {int(vmax[k])}] — not block-angular"
                )
        block_of_col[nz] = vmax  # border columns reduce to -1
    return block_of_col


def estimate_block_tensor_entries(A, hint: dict) -> int:
    """Dense entries the block backend's stacked tensors would hold for
    ``hint`` — B_all (K·mb·nb) + L_all (K·link·nb) + A0 (link·n0). Used by
    auto-dispatch to veto detections whose padded tensors wouldn't fit in
    memory (the sparse-direct CPU path is then the better executor)."""
    rb = np.asarray(hint["row_block"], dtype=np.int64)
    K = int(hint["num_blocks"])
    Ac = sp.csc_matrix(A)
    sizes = np.bincount(rb[rb >= 0], minlength=K)
    mb = int(sizes.max()) if K else 0
    link = int((rb == -1).sum())
    colmax = column_block_ids(Ac, rb)
    counts = np.bincount(colmax[colmax >= 0], minlength=K)
    nb = int(counts.max()) if K else 0
    n0 = int((colmax == -1).sum())
    return K * mb * nb + K * link * nb + link * n0


def _pack_components(comp_of_row: np.ndarray, n_comp: int, K: int) -> np.ndarray:
    """Greedy bin-pack components into K balanced blocks by row count."""
    comp_rows = np.bincount(comp_of_row[comp_of_row >= 0], minlength=n_comp)
    order = np.argsort(comp_rows)[::-1]  # largest first
    load = np.zeros(K, dtype=np.int64)
    group_of_comp = np.empty(n_comp, dtype=np.int64)
    for comp in order:
        g = int(np.argmin(load))
        group_of_comp[comp] = g
        load[g] += comp_rows[comp]
    row_block = np.where(comp_of_row >= 0, group_of_comp[comp_of_row], -1)
    return row_block.astype(np.int64)
