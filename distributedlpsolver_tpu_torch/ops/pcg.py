"""Preconditioned conjugate gradient and matrix-free preconditioners for the
inexact-IPM (huge-sparse) tier.

The port of the JAX package's ``ops/pcg.py`` on torch tensors:

* :func:`pcg` — single-RHS PCG returning ``(x, iterations)``, with the
  reference's stall window and its NaN-honest failure test;
* :func:`pcg_batched` — (B, m) lanes with a per-lane active mask, and
  :func:`solve_chunked` to split wide batches into ≤``CHUNK_WIDTH``-lane
  solves;
* preconditioners: :func:`jacobi`, :class:`BlockJacobi` (exact bs×bs
  diagonal blocks of the normal matrix, batched Cholesky) and
  :class:`BorderedPrecond` (block-Jacobi over scenario row blocks plus a
  Woodbury capacitance correction for the first-stage columns).

Where the JAX package runs CG as a ``lax.while_loop`` inside one jitted
step, eager torch must ask the host whether to go on, and a ``.item()``
per CG iteration would serialise launch and execution. The loop here runs
in chunks of masked iterations: an iteration whose exit test (the
reference's ``cond``) fails changes no carry, so the returned x and
iteration count are the unmasked loop's, bit for bit, and the host reads
the exit flag once per chunk (counted in ``pcg.syncs``). The first chunk
is sized by the caller from the previous solve's count.

The per-block products are library calls (``torch.bmm``,
``torch.linalg.cholesky_ex``, ``torch.linalg.solve_triangular``), as they
are XLA in the JAX package. A Cholesky that fails gives a NaN factor on the
device (no host sync, no exception), as the JAX package's does, so PCG's
failure test and the step's finite check see it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from distributedlpsolver_tpu_torch.ops.sparse import SparseOperator

# Batch lanes per batched PCG solve (the JAX package's program width).
CHUNK_WIDTH = 128

# Stall exit: CG iterations without a meaningful residual reduction before
# the loop gives up on its tolerance (the reference's constants).
_STALL_WINDOW = 96
_STALL_FACTOR = 0.999  # an iteration must beat best·this to count as progress

# Masked CG iterations queued between two host reads of the exit flag:
# the first chunk is the caller's guess (the previous solve's count), at
# most CG_FIRST_MAX; later chunks grow with the iterations done (a quarter
# of them, between CG_CHUNK and CG_CHUNK_MAX), so a long solve reads the
# flag O(log) times and runs at most a chunk past its exit. On the CPU
# every iteration reads it (a host read costs nothing there, a masked
# iteration does).
CG_CHUNK = 4
CG_FIRST_MAX = 32
CG_CHUNK_MAX = 64


def _masked(go, new, old):
    return tuple(torch.where(go, a, b) for a, b in zip(new, old))


def _cg_cond(carry, thresh, max_iter):
    x, r, p, rz, it, best, stall, rn = carry
    return (it < max_iter) & (stall < _STALL_WINDOW) & (rn > thresh) & torch.isfinite(rz)


def _cg_body(op, prec, carry, thresh, max_iter):
    """One reference CG iteration, masked by its ``cond``. The carry holds
    ‖r‖ (``rn``), which the reference recomputes in ``cond``."""
    go = _cg_cond(carry, thresh, max_iter)
    x, r, p, rz, it, best, stall, rn = carry
    Ap = op(p)
    denom = p @ Ap
    alpha = rz / torch.where(denom != 0, denom, 1.0)
    x1 = x + alpha * p
    r1 = r - alpha * Ap
    z = prec(r1)
    rz1 = r1 @ z
    beta = rz1 / torch.where(rz != 0, rz, 1.0)
    p1 = z + beta * p
    res = torch.linalg.vector_norm(r1)
    improved = res < _STALL_FACTOR * best
    best1 = torch.minimum(best, res)
    stall1 = torch.where(improved, 0, stall + 1)
    return _masked(go, (x1, r1, p1, rz1, it + 1, best1, stall1, res), carry)


def _chunks(device, first_chunk):
    """Chunk sizes of masked iterations between host reads."""
    if device.type == "cpu":
        while True:
            yield 1
    n = max(1, min(int(first_chunk or CG_CHUNK), CG_FIRST_MAX))
    done = 0
    while True:
        yield n
        done += n
        n = max(CG_CHUNK, min(done // 4, CG_CHUNK_MAX))


def pcg(op, prec, rhs, tol, max_iter, first_chunk: Optional[int] = None):
    """Preconditioned CG; returns ``(x, iters)`` with ``iters`` a host int.

    ``op``/``prec`` are matrix-free callables. Terminates at relative
    residual ``tol`` (of ‖rhs‖), ``max_iter`` or a stalled residual. A
    breakdown (non-finite curvature) or a run that failed to reduce the
    residual meaningfully returns NaN, so the caller's bad-step ladder sees
    the failure (the reference's contract)."""
    norm0 = torch.linalg.vector_norm(rhs)
    thresh = tol * norm0
    z0 = prec(rhs)
    zero = torch.zeros((), dtype=torch.int32, device=rhs.device)
    carry = (torch.zeros_like(rhs), rhs, z0, rhs @ z0, zero, norm0, zero, norm0)
    for n in _chunks(rhs.device, first_chunk):
        for _ in range(n):
            carry = _cg_body(op, prec, carry, thresh, max_iter)
        go = _cg_cond(carry, thresh, max_iter)
        flag, it = torch.stack([go.to(torch.int64), carry[4].to(torch.int64)]).tolist()
        pcg.syncs += 1
        if not flag:
            break
    x, r, p, rz, _, best, stall, rn = carry
    bad = ~(torch.isfinite(rz) & torch.isfinite(x).all())
    bad = bad | (rn > torch.maximum(1e-3 * norm0, 10.0 * thresh))
    return torch.where(bad, torch.full_like(x, float("nan")), x), it


# Host reads of the exit flag since the last reset (one per chunk).
pcg.syncs = 0


def pcg_batched(op, prec, rhs, tol, max_iter, active=None, first_chunk=None):
    """Batched PCG over (B, m) lanes with per-lane early exit.

    A lane leaves the active mask when its relative residual passes its
    ``tol`` (scalar or (B,)) or it breaks down. Returns ``(X, iters,
    ok)``: per-lane solutions (NaN where failed), iteration counts (an
    int32 tensor) and success flags. The loop runs in masked chunks as
    :func:`pcg`'s; an iteration after the last lane left changes nothing.
    """
    B, m = rhs.shape
    dtype, dev = rhs.dtype, rhs.device
    tol = torch.broadcast_to(torch.as_tensor(tol, dtype=dtype, device=dev), (B,))
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=dev)
    active = torch.as_tensor(active, dtype=torch.bool, device=dev)
    norm0 = torch.linalg.vector_norm(rhs, dim=1)
    thresh = tol * norm0
    Z0 = prec(rhs)
    zeros_i = torch.zeros(B, dtype=torch.int32, device=dev)
    carry = (torch.zeros_like(rhs), rhs, Z0, torch.sum(rhs * Z0, dim=1), zeros_i,
             active & (norm0 > thresh), norm0, zeros_i)

    def body(carry):
        X, R, P, rz, it, act, best, stall = carry
        go = act.any()
        AP = op(P)
        denom = torch.sum(P * AP, dim=1)
        alpha = rz / torch.where(denom != 0, denom, 1.0)
        am = torch.where(act, alpha, 0.0)
        X1 = X + am[:, None] * P
        R1 = R - am[:, None] * AP
        Z = prec(R1)
        rz_new = torch.sum(R1 * Z, dim=1)
        beta = rz_new / torch.where(rz != 0, rz, 1.0)
        P1 = torch.where(act[:, None], Z + beta[:, None] * P, P)
        rz1 = torch.where(act, rz_new, rz)
        it1 = torch.where(act, it + 1, it)
        res = torch.linalg.vector_norm(R1, dim=1)
        improved = res < _STALL_FACTOR * best
        best1 = torch.where(act, torch.minimum(best, res), best)
        stall1 = torch.where(act, torch.where(improved, 0, stall + 1), stall)
        act1 = (act & (res > thresh) & torch.isfinite(rz1) & (it1 < max_iter)
                & (stall1 < _STALL_WINDOW))
        return _masked(go, (X1, R1, P1, rz1, it1, act1, best1, stall1), carry)

    for n in _chunks(dev, first_chunk):
        for _ in range(n):
            carry = body(carry)
        pcg.syncs += 1
        if not bool(carry[5].any()):
            break
    X, R, P, rz, it, act, best, stall = carry
    res = torch.linalg.vector_norm(R, dim=1)
    bad = ~(torch.isfinite(rz) & torch.isfinite(X).all(dim=1))
    bad = bad | (res > torch.maximum(1e-3 * norm0, 10.0 * thresh))
    # Lanes the caller never activated keep their zeros and are not judged
    # by the residual test (their R is still the untouched rhs).
    bad = bad & active
    X = torch.where(bad[:, None], torch.full_like(X, float("nan")), X)
    return X, it, ~bad


def solve_chunked(solve_fn, rhs, chunk: int = CHUNK_WIDTH):
    """Split a (B, m) batched solve into ≤``chunk``-lane solves and
    concatenate. ``solve_fn(rhs_chunk) -> (X, iters, ok)``. The last
    partial chunk is zero-padded to the chunk width, as the reference pads
    it (one program width there)."""
    B = rhs.shape[0]
    outs = []
    for lo in range(0, B, chunk):
        part = rhs[lo: lo + chunk]
        pad = chunk - part.shape[0] if B > chunk else 0
        if pad > 0:
            part = torch.cat([part, part.new_zeros((pad,) + tuple(part.shape[1:]))])
        X, it, ok = solve_fn(part)
        if pad > 0:
            X, it, ok = X[:-pad], it[:-pad], ok[:-pad]
        outs.append((X, it, ok))
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


# -- preconditioners --------------------------------------------------------


def jacobi(op: SparseOperator, d, reg):
    """Diagonal (Jacobi) preconditioner of A·diag(d)·Aᵀ + reg·I. Returns
    ``apply(r)`` ((m,) or (B, m))."""
    idiag = 1.0 / op.normal_diag(d, reg)

    def apply(r):
        return r * idiag

    return apply


_BLOCK_W_QUANTUM = 16


def _canonical(A_csr) -> sp.csr_matrix:
    A = sp.csr_matrix(A_csr)
    if not A.has_canonical_format:
        A = A.copy()
        A.sum_duplicates()
    return A


def _block_entries(A_csr: sp.csr_matrix, starts, sizes):
    """(block, local row, col, val) of every stored entry of the row
    blocks, vectorized over the CSR."""
    starts = np.asarray(starts, dtype=np.int64)
    sizes = np.asarray(sizes, dtype=np.int64)
    K = len(starts)
    blk_of = np.repeat(np.arange(K), sizes)
    lrow = np.arange(int(sizes.sum())) - np.repeat(np.cumsum(sizes) - sizes, sizes)
    rows = np.repeat(starts, sizes) + lrow
    lo = A_csr.indptr[rows].astype(np.int64)
    cnt = A_csr.indptr[rows + 1].astype(np.int64) - lo
    pos = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt) + np.repeat(lo, cnt)
    return (np.repeat(blk_of, cnt), np.repeat(lrow, cnt), A_csr.indices[pos].astype(np.int64),
            A_csr.data[pos])


def _block_slices(A_csr, starts, sizes, exclude_cols=None, dtype=torch.float64, device="cpu"):
    """Host symbolic setup shared by the block preconditioners: for each
    row block, the dense (bs, w) slice of its touched columns (put on
    ``device`` as one (K, bs, w) tensor) plus the padded column-index list
    (pad entries point at a synthetic column n whose d is fixed to 0).
    The JAX package's loop over blocks, vectorized over the CSR (the same
    arrays)."""
    A = _canonical(A_csr)
    m, n = A.shape
    K = len(starts)
    excl = np.zeros(n, dtype=bool) if exclude_cols is None else np.asarray(exclude_cols, bool)
    e_blk, e_row, e_col, e_val = _block_entries(A, starts, sizes)
    keep = ~excl[e_col]
    # Sorted unique (block, column) pairs: each block's touched columns.
    key = e_blk[keep] * (n + 1) + e_col[keep]
    uniq, inv = np.unique(key, return_inverse=True)
    u_blk, u_col = uniq // (n + 1), uniq % (n + 1)
    per_blk = np.bincount(u_blk, minlength=K)
    w = max(1, int(per_blk.max(initial=0)))
    w = max(_BLOCK_W_QUANTUM, -(-w // _BLOCK_W_QUANTUM) * _BLOCK_W_QUANTUM)
    bs = int(max(sizes))
    slot = np.arange(len(uniq)) - np.repeat(np.cumsum(per_blk) - per_blk, per_blk)
    colidx = np.full((K, w), n, dtype=np.int32)  # n = synthetic zero-d col
    colidx[u_blk, slot] = u_col
    rowmask = np.zeros((K, bs), dtype=bool)
    for b, size in enumerate(sizes):
        rowmask[b, :size] = True
    A_blocks = torch.zeros((K, bs, w), dtype=dtype, device=device)
    idx = [torch.from_numpy(a).to(device) for a in (e_blk[keep], e_row[keep], slot[inv])]
    A_blocks.index_put_(idx, torch.from_numpy(e_val[keep]).to(device=device, dtype=dtype))
    return A_blocks, colidx, rowmask, bs, w


def _scalar(value, like):
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def _nan_where_failed(L, info):
    """A factor whose Cholesky failed becomes NaN (per batch entry), on
    the device."""
    bad = info != 0
    return L.masked_fill_(bad.reshape(bad.shape + (1, 1)), float("nan"))


def _block_factor(A_blocks, colidx, rowmask, d_pad, reg, chunk: int = 128):
    """Per-block normal blocks M_b = A_b·diag(d)·A_bᵀ + reg·I and their
    Cholesky factors — bs×bs each, never m×m. The product runs over
    ``chunk`` blocks at a time (its scaled copy of A_blocks stays small)."""
    K, bs, _ = A_blocks.shape
    dg = d_pad[colidx]  # (K, w)
    M = A_blocks.new_empty((K, bs, bs))
    for lo in range(0, K, chunk):
        Ab = A_blocks[lo: lo + chunk]
        torch.bmm(Ab * dg[lo: lo + chunk, None, :], Ab.transpose(1, 2), out=M[lo: lo + chunk])
    # Real rows get the +reg ridge; padded tail rows (all-zero A slice) a
    # unit diagonal so the factor stays SPD (their rhs entries are zero).
    M.diagonal(dim1=1, dim2=2).add_(torch.where(rowmask, _scalar(reg, M), _scalar(1.0, M)))
    L, info = torch.linalg.cholesky_ex(M)
    del M
    return _nan_where_failed(L, info)


def _cho_solve(L, B):
    """L·Lᵀ·X = B for batched lower factors L (..., k, k) and B (..., k, r):
    two triangular solves, as the reference's ``cho_solve``. (The
    factor is read in place; ``torch.cholesky_solve`` copies it into a
    column-major working copy on every call, ~2 GB a Newton-solve
    iteration at stormG2_1000's shape.)"""
    Y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mT, Y, upper=True)


def _block_apply(L, r_blocks):
    """Blockwise two-triangular solve: (K, bs) rhs → (K, bs)."""
    return _cho_solve(L, r_blocks[..., None])[..., 0]


class BlockJacobi:
    """Exact bs×bs diagonal blocks of the normal matrix as the
    preconditioner. Setup is host-side symbolic (per-block dense row slices
    + padded column lists); the per-step factor is one batched product and
    Cholesky, O(K·bs²·w), never forming the m×m matrix."""

    def __init__(self, A_csr, block_size: int = 32, starts=None, sizes=None, exclude_cols=None,
                 dtype=torch.float64, device="cpu"):
        A_csr = sp.csr_matrix(A_csr)
        m = A_csr.shape[0]
        if starts is None:
            starts = list(range(0, m, block_size))
            sizes = [min(block_size, m - lo) for lo in starts]
        device = torch.device(device)
        self.A_blocks, colidx, rowmask, bs, w = _block_slices(
            A_csr, starts, sizes, exclude_cols, dtype, device)
        self.m = m
        self.n = A_csr.shape[1]
        self.starts = np.asarray(starts, dtype=np.int64)
        self.sizes = np.asarray(sizes, dtype=np.int64)
        self.bs = bs
        self.colidx = torch.from_numpy(colidx).to(device)
        self.rowmask = torch.from_numpy(rowmask).to(device)
        # Scatter index from (K, bs) block layout back to flat rows.
        flat = np.full((len(starts), bs), m, dtype=np.int64)
        for b, (lo, szz) in enumerate(zip(starts, sizes)):
            flat[b, :szz] = np.arange(lo, lo + szz)
        self.flatidx = torch.from_numpy(flat).to(device)
        # Blocks that tile the rows in order, all of one size: gather and
        # scatter are reshapes.
        self._tiled = bool(len(starts) * bs == m and np.array_equal(flat.ravel(), np.arange(m)))

    def factor(self, d, reg):
        """d (n,) → per-block Cholesky factors."""
        d_pad = torch.cat([d, d.new_zeros(1)])  # synthetic pad column
        return _block_factor(self.A_blocks, self.colidx, self.rowmask, d_pad, reg)

    def gather(self, r):
        """(m,) → (K, bs) with zero-padded tail rows."""
        if self._tiled:
            return r.reshape(-1, self.bs)
        return torch.cat([r, r.new_zeros(1)])[self.flatidx]

    def scatter(self, xb):
        """(K, bs) → (m,), inverse of :meth:`gather` (each real row is
        written once; pad slots land in a discarded synthetic row)."""
        if self._tiled:
            return xb.reshape(-1)
        out = xb.new_zeros(self.m + 1)
        out[self.flatidx.reshape(-1)] = xb.reshape(-1)
        return out[: self.m]

    def apply_with(self, L):
        def one(r):
            return self.scatter(_block_apply(L, self.gather(r)))

        return _lanes(one)

    def nbytes(self) -> int:
        return sum(int(a.numel()) * a.element_size()
                   for a in (self.A_blocks, self.colidx, self.rowmask, self.flatidx))

    def memory_report(self) -> dict:
        return {"A_blocks": {"shape": tuple(int(s) for s in self.A_blocks.shape),
                             "nbytes": int(self.A_blocks.numel()) * self.A_blocks.element_size()}}


def _lanes(one):
    """``apply(r)`` for (m,) or (B, m) (one lane at a time)."""
    def apply(r):
        if r.dim() == 2:
            return torch.stack([one(rr) for rr in r])
        return one(r)

    return apply


def _bordered_factor(A_blocks, colidx, rowmask, V, d_pad, d1, reg):
    """Factors of the bordered (Woodbury) preconditioner

        P = B̃ + V·diag(d1)·Vᵀ,  B̃ = blockdiag(W_b·D2_b·W_bᵀ) + reg·I

    as (L_blocks, Zb, capL): per-scenario Cholesky factors, the
    block-solved border Zb = B̃⁻¹V in block layout, and the n1×n1
    capacitance factor of C = diag(1/d1) + VᵀZ."""
    L = _block_factor(A_blocks, colidx, rowmask, d_pad, reg)
    K, bs = rowmask.shape
    n1 = V.shape[1]
    # Row-major, so that every apply reads it as one (m, n1) matrix.
    Zb = _cho_solve(L, V.reshape(K, bs, n1)).contiguous()
    C = V.T @ Zb.view(K * bs, n1)
    C.diagonal().add_(1.0 / d1)
    capL, info = torch.linalg.cholesky_ex(C)
    return L, Zb, _nan_where_failed(capL, info)


def _bordered_apply(L, Zb, capL, V, r_blocks):
    """P⁻¹r via Woodbury: B̃⁻¹r − Z·C⁻¹·Vᵀ·B̃⁻¹r, in block layout."""
    K, bs = r_blocks.shape
    n1 = V.shape[1]
    xb = _block_apply(L, r_blocks)
    vtx = V.T @ xb.reshape(-1)
    y = _cho_solve(capL, vtx[:, None])[:, 0]
    return xb - (Zb.view(K * bs, n1) @ y).view(K, bs)


class BorderedPrecond:
    """Woodbury preconditioner for bordered (dual block-angular /
    two-stage stochastic) patterns: scenario row blocks coupled only
    through ``n1`` first-stage columns. Everything stays (K, bs, ·)/(m,
    n1)-shaped — the m×m normal matrix never exists in any format."""

    def __init__(self, A_csr, hint: dict, dtype=torch.float64, device="cpu"):
        A_csr = _canonical(A_csr)
        m, n = A_csr.shape
        n1 = int(hint["first_stage_n"])
        K = int(hint["num_blocks"])
        mb = int(hint["block_m"])
        if K * mb != m:
            raise ValueError(f"bordered hint K={K}, block_m={mb} does not tile m={m}")
        device = torch.device(device)
        self.n1 = n1
        first = np.zeros(n, dtype=bool)
        first[:n1] = True
        self.blocks = BlockJacobi(A_csr, starts=[b * mb for b in range(K)], sizes=[mb] * K,
                                  exclude_cols=first, dtype=dtype, device=device)
        # V = A[:, :n1], dense (m, n1), put together on the device from the
        # CSR entries of the first-stage columns.
        coo = A_csr.tocoo()
        sel = coo.col < n1
        self.V = torch.zeros((m, n1), dtype=dtype, device=device)
        self.V.index_put_(
            [torch.from_numpy(coo.row[sel].astype(np.int64)).to(device),
             torch.from_numpy(coo.col[sel].astype(np.int64)).to(device)],
            torch.from_numpy(coo.data[sel]).to(device=device, dtype=dtype),
        )

    def factor(self, d, reg):
        d1 = d[: self.n1]
        d_pad = torch.cat([d, d.new_zeros(1)])
        d_pad[: self.n1] = 0.0  # first-stage cols live in V·D1·Vᵀ
        b = self.blocks
        return _bordered_factor(b.A_blocks, b.colidx, b.rowmask, self.V, d_pad, d1, reg)

    def apply_with(self, factors):
        L, Zb, capL = factors
        blocks = self.blocks

        def one(r):
            return blocks.scatter(_bordered_apply(L, Zb, capL, self.V, blocks.gather(r)))

        return _lanes(one)

    def nbytes(self) -> int:
        return self.blocks.nbytes() + int(self.V.numel()) * self.V.element_size()

    def memory_report(self) -> dict:
        rep = self.blocks.memory_report()
        rep["V"] = {"shape": tuple(int(s) for s in self.V.shape),
                    "nbytes": int(self.V.numel()) * self.V.element_size()}
        return rep
