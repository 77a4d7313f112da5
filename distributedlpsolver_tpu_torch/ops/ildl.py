"""Incomplete-LDLᵀ (IC(0)-class) preconditioner on the normal-equation
pattern — the rung between diag-Jacobi and falling off to cpu-sparse.

The port of the JAX package's ``ops/ildl.py``: a zero-fill incomplete
LDLᵀ factor of ``M = A·diag(d)·Aᵀ + reg·I`` on the sparsity pattern of
A·Aᵀ, computed on the symmetrically scaled matrix S·M·S + α·I.

* **Symbolic phase (host, once per pattern):** :func:`_pattern_terms`,
  copied from the reference: every column of A is a clique of rows; the
  per-column row pairs enumerate the nonzero positions of M and their
  product terms, flattened into static index arrays, and the
  factorization DAG is level-scheduled.
* **Numeric phase (per factor):** the exact shifted IC(0), a loop over
  the static level count; each level runs the same segment sums and
  commits the columns of that level, so the loop reproduces sequential
  up-looking factorization.
* **Apply:** truncated Neumann triangular solves, ``P⁻¹ r =
  S·Kᵀ·D⁻¹·K·S·r`` with K = Σ_{t<T} (−N)ᵗ — SPD for any truncation depth.

The reference's ``segment_sum``/``.at[].add`` become segment sums over
segment ids sorted once at setup (``torch.segment_reduce`` on the sorted
values): each segment is summed in one fixed order, with no atomic
scatter on a card. The caps, the term budgets, ``DEFAULT_SHIFT`` and
``DEFAULT_TRI_SWEEPS`` are the reference's; a pattern over a budget
raises ValueError, which callers read as "stay on jacobi".
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

# Refuse symbolic setup beyond these sizes: the per-column cliques give
# Σ_c |rows(c)|² product terms, which explodes on dense-ish columns.
_MAX_PRODUCT_TERMS = 4_000_000
_MAX_FILL_TERMS = 8_000_000
_MAX_ROWS = 16_384

# Manteuffel diagonal shift on the scaled (unit-diagonal) matrix: the
# factor computed is IC0(S·M·S + α·I).
DEFAULT_SHIFT = 0.3

# Neumann terms per triangular solve in the apply.
DEFAULT_TRI_SWEEPS = 6

# Residual-breakdown clamp: a diagonal update at or below this resets to
# the shifted unit diagonal — the local jacobi fallback.
_D_FLOOR = 1e-10


def _pattern_terms(A: sp.csr_matrix):
    """Host symbolic phase: flatten the normal-matrix pattern of A·Aᵀ,
    its product/fill term lists, and the factorization level schedule
    into static index arrays (see ILDLPrecond fields)."""
    A = sp.csr_matrix(A)
    m, _ = A.shape
    if m > _MAX_ROWS:
        raise ValueError(f"ildl: {m} rows exceeds the {_MAX_ROWS} cap")
    Ac = A.tocsc()

    # --- product terms: one per (row-pair, column) clique membership ---
    ti, tj, tv, tc = [], [], [], []
    di, dv, dc = [], [], []
    budget = 0
    for c in range(Ac.shape[1]):
        lo, hi = Ac.indptr[c], Ac.indptr[c + 1]
        rows = Ac.indices[lo:hi].astype(np.int64)
        vals = Ac.data[lo:hi]
        r = len(rows)
        budget += r * r
        if budget > _MAX_PRODUCT_TERMS:
            raise ValueError("ildl: product-term budget exceeded")
        di.append(rows)
        dv.append(vals * vals)
        dc.append(np.full(r, c, dtype=np.int64))
        if r < 2:
            continue
        ii = np.repeat(rows, r).reshape(r, r)
        vv = np.multiply.outer(vals, vals)
        low = ii > ii.T
        ti.append(ii[low])
        tj.append(ii.T[low])
        tv.append(vv[low])
        tc.append(np.full(int(low.sum()), c, dtype=np.int64))

    d_seg = np.concatenate(di) if di else np.zeros(0, dtype=np.int64)
    d_coef = np.concatenate(dv) if dv else np.zeros(0)
    d_col = np.concatenate(dc) if dc else np.zeros(0, dtype=np.int64)

    if ti:
        p_i = np.concatenate(ti)
        p_j = np.concatenate(tj)
        p_coef = np.concatenate(tv)
        p_col = np.concatenate(tc)
    else:
        p_i = np.zeros(0, dtype=np.int64)
        p_j = np.zeros(0, dtype=np.int64)
        p_coef = np.zeros(0)
        p_col = np.zeros(0, dtype=np.int64)

    # Unique strictly-lower pattern entries (i > j), in (i, j) order.
    key = p_i * m + p_j
    uniq, inv = np.unique(key, return_inverse=True)
    l_i = (uniq // m).astype(np.int32)
    l_j = (uniq % m).astype(np.int32)
    nl = len(uniq)

    # --- fill terms for the factorization updates ---
    # For entry e=(i,j): pairs (a,b) of lower-entry indices with
    # a=(i,k), b=(j,k), k<j. For diagonal i: entries a=(i,k), k<i.
    pos = {(int(i), int(j)): e for e, (i, j) in enumerate(zip(l_i, l_j))}
    nbr = [[] for _ in range(m)]  # nbr[i] = ks with (i,k) in L, k<i
    for i, j in zip(l_i, l_j):
        nbr[int(i)].append(int(j))
    f_a, f_b, f_k, f_seg = [], [], [], []
    g_a, g_k, g_seg = [], [], []
    fill = 0
    for e in range(nl):
        i, j = int(l_i[e]), int(l_j[e])
        ks = np.intersect1d(
            np.asarray(nbr[i], dtype=np.int64),
            np.asarray(nbr[j], dtype=np.int64),
            assume_unique=False,
        )
        ks = ks[ks < j]
        fill += len(ks)
        if fill > _MAX_FILL_TERMS:
            raise ValueError("ildl: fill-term budget exceeded")
        for k in ks:
            f_a.append(pos[(i, int(k))])
            f_b.append(pos[(j, int(k))])
            f_k.append(int(k))
            f_seg.append(e)
    for i in range(m):
        for k in nbr[i]:
            g_a.append(pos[(i, k)])
            g_k.append(k)
            g_seg.append(i)

    # --- level schedule: column j finalizes one step after the deepest
    # column its row touches (columns with empty rows are level 0) ---
    lvl = np.zeros(m, dtype=np.int32)
    for j in range(m):
        lvl[j] = 1 + max((lvl[k] for k in nbr[j]), default=-1)
    depth = int(lvl.max()) + 1 if m else 0

    asi32 = lambda x: np.asarray(x, dtype=np.int32)
    return {
        "m": m,
        "nl": nl,
        "depth": depth,
        "l_i": l_i,
        "l_j": l_j,
        "lvl": lvl,
        "d_seg": asi32(d_seg),
        "d_coef": d_coef,
        "d_col": asi32(d_col),
        "p_seg": asi32(inv),
        "p_coef": p_coef,
        "p_col": asi32(p_col),
        "f_a": asi32(f_a),
        "f_b": asi32(f_b),
        "f_k": asi32(f_k),
        "f_seg": asi32(f_seg),
        "g_a": asi32(g_a),
        "g_k": asi32(g_k),
        "g_seg": asi32(g_seg),
    }



class _SegmentSum:
    """``out[s] = Σ_{e: seg[e] = s} vals[e]`` over static segment ids: the
    entries are permuted once (stable, so each segment keeps the
    reference's entry order) and summed per segment by
    ``torch.segment_reduce``, in a fixed order."""

    def __init__(self, seg: np.ndarray, num: int, device):
        seg = np.asarray(seg, dtype=np.int64)
        order = np.argsort(seg, kind="stable")
        self.perm = None if np.array_equal(order, np.arange(len(seg))) else (
            torch.from_numpy(order).to(device))
        self.lengths = torch.from_numpy(np.bincount(seg, minlength=num)).to(device)
        self.num = num
        self.empty = len(seg) == 0

    def __call__(self, vals):
        if self.empty:
            return vals.new_zeros(self.num)
        v = vals if self.perm is None else vals[self.perm]
        return torch.segment_reduce(v, "sum", lengths=self.lengths)

    def nbytes(self) -> int:
        arrays = (self.lengths,) if self.perm is None else (self.lengths, self.perm)
        return sum(int(a.numel()) * a.element_size() for a in arrays)


class ILDLPrecond:
    """Incomplete-LDLᵀ preconditioner of A·diag(d)·Aᵀ + reg·I, with the
    ``factor(d, reg)`` / ``apply_with(factors)`` protocol of
    :class:`ops.pcg.BlockJacobi`. Factors are ``(Lvals, D, S)`` —
    strictly-lower values on the static pattern, the positive diagonal,
    and the symmetric scaling."""

    def __init__(self, A_csr: sp.csr_matrix, dtype=torch.float64, device="cpu",
                 shift: float = DEFAULT_SHIFT, tri_sweeps: int = DEFAULT_TRI_SWEEPS):
        t = _pattern_terms(A_csr)
        device = torch.device(device)
        self.m = t["m"]
        self.nl = t["nl"]
        self.depth = t["depth"]
        self.shift = float(shift)
        self.tri_sweeps = int(tri_sweeps)
        idx = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)  # noqa: E731
        val = lambda a: torch.from_numpy(np.asarray(a)).to(device=device, dtype=dtype)  # noqa: E731
        self.l_i, self.l_j = idx(t["l_i"]), idx(t["l_j"])
        self.lvl = idx(t["lvl"])
        self.lvl_e = idx(t["lvl"][t["l_j"]])
        self.d_coef, self.d_col = val(t["d_coef"]), idx(t["d_col"])
        self.p_coef, self.p_col = val(t["p_coef"]), idx(t["p_col"])
        self.f_a, self.f_b, self.f_k = idx(t["f_a"]), idx(t["f_b"]), idx(t["f_k"])
        self.g_a, self.g_k = idx(t["g_a"]), idx(t["g_k"])
        m, nl = self.m, self.nl
        self._seg_d = _SegmentSum(t["d_seg"], m, device)
        self._seg_p = _SegmentSum(t["p_seg"], nl, device)
        self._seg_g = _SegmentSum(t["g_seg"], m, device)
        self._seg_f = _SegmentSum(t["f_seg"], nl, device)
        self._seg_i = _SegmentSum(t["l_i"], m, device)  # N·x: rows of the lower entries
        self._seg_j = _SegmentSum(t["l_j"], m, device)  # Nᵀ·x: their columns

    # -- numeric factorization ------------------------------------------

    def factor(self, d, reg):
        """d (n,) → ``(Lvals, D, S)``: exact level-scheduled shifted IC(0)
        of S·(A·diag(d)·Aᵀ + reg·I)·S + α·I."""
        s_diag = self._seg_d(self.d_coef * d[self.d_col]) + reg
        s_low = self._seg_p(self.p_coef * d[self.p_col])
        S = 1.0 / torch.sqrt(s_diag)
        sh = s_low * S[self.l_i] * S[self.l_j]
        dg = 1.0 + self.shift
        L = sh.new_zeros(self.nl)
        D = torch.full((self.m,), dg, dtype=sh.dtype, device=sh.device)
        for s in range(self.depth):
            # Diagonals of this level: their row entries are all in
            # earlier-level columns, already final.
            La = L[self.g_a]
            Dn = dg - self._seg_g(La * La * D[self.g_k])
            Dn = torch.where(Dn > _D_FLOOR, Dn, dg)  # breakdown fallback
            D = torch.where(self.lvl == s, Dn, D)
            # Column entries of this level: need D_j (just committed) and
            # pairs of earlier-level entries.
            corr = self._seg_f(L[self.f_a] * L[self.f_b] * D[self.f_k])
            L = torch.where(self.lvl_e == s, (sh - corr) / D[self.l_j], L)
        return L, D, S

    # -- apply ------------------------------------------------------------

    def _napply(self, L, x):
        """N·x with N the strictly-lower part: out[i] += L_e · x[j]."""
        return self._seg_i(L * x[self.l_j])

    def _ntapply(self, L, x):
        """Nᵀ·x: out[j] += L_e · x[i]."""
        return self._seg_j(L * x[self.l_i])

    def _neumann(self, nap, L, r):
        """K·r = Σ_{t<T} (−N)ᵗ r — the truncated triangular solve."""
        acc = r
        term = r
        for _ in range(self.tri_sweeps - 1):
            term = -nap(L, term)
            acc = acc + term
        return acc

    def apply_with(self, factors):
        L, D, S = factors

        def one(r):
            z = self._neumann(self._napply, L, S * r)
            z = z / D
            return S * self._neumann(self._ntapply, L, z)

        def apply(r):
            if r.dim() == 2:
                return torch.stack([one(rr) for rr in r])
            return one(r)

        return apply

    # -- reporting ----------------------------------------------------------

    def nbytes(self) -> int:
        tensors = (self.l_i, self.l_j, self.lvl, self.lvl_e, self.d_coef, self.d_col,
                   self.p_coef, self.p_col, self.f_a, self.f_b, self.f_k, self.g_a, self.g_k)
        segs = (self._seg_d, self._seg_p, self._seg_g, self._seg_f, self._seg_i, self._seg_j)
        return (sum(int(a.numel()) * a.element_size() for a in tensors)
                + sum(s.nbytes() for s in segs))

    def memory_report(self) -> dict:
        return {"ildl_pattern": {"shape": (self.nl,), "nbytes": self.nbytes()}}
