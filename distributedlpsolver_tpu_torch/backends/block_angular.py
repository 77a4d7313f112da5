"""Block-angular Schur-complement backend — the pds family's tier.

The port of the JAX package's ``backends/block_angular.py``
(``BlockAngularBackend``, registered as ``block``/``schur``/
``block-angular``), on its direct full-precision path: the one the
reference takes on any platform but a TPU, where neither the two-phase
schedule nor the panel Cholesky runs.

A primal block-angular LP (multicommodity flow pds-*, the stochastic
stormG2 class) has K diagonal blocks ``B_k`` coupled only through a few
linking rows ``L_k`` and border columns ``A0`` touched by linking rows
alone. The normal matrix then has an arrow structure, and each step
factors it by the Schur complement of the linking system::

    M_kk = B_k·D_k·B_kᵀ                        (K lanes of K1)
    G_k  = L_k·D_k·B_kᵀ                        (batched GEMM)
    S    = Σ_k L_k·D_k·L_kᵀ + A0·D0·A0ᵀ − Σ_k G_k·M_kk⁻¹·G_kᵀ

Layout (``BlockTensors``): the diagonal blocks are a (K, mb, nb) stack,
zero-padded to the largest block, as in the reference. The linking rows
are ONE dense row-major (link, K·nb + n0) matrix ``L_cat`` — each block's
nb columns in turn, then the border's — where the reference keeps a
(K, link, nb) stack and ``A0``. Both terms of the linking normal matrix
are then one launch of the normal-equations kernel (``ops/normal_eq.py``)
on ``L_cat`` with ``d`` gathered in the same column order; the reference
sums the same products as two einsums. The summation order differs, so
the two agree to rounding, not bit for bit.

Per step on the card: two K1 launches (the K lanes and the linking
matrix), one batched Cholesky (``cholesky_ex``) and two batched
triangular solves for ``H_k = M_kk⁻¹·G_kᵀ`` (on the factor in place —
``cholesky_solve`` would copy it), one (link, K·mb)×(K·mb, link) GEMM
for ``Σ_k G_k·H_k`` (no (K, link, link) temporary), and the linking
Cholesky. Scatters back to the interior rows and columns are gathers
through inverse maps, so x is the same bit for bit on a repeat (no
``index_add_`` whose atomics could reorder a sum). The reference's
K-grouping (``_K_GROUP``, a TPU program fault's workaround) has no
counterpart: the K axis runs in one shot.

The solve runs in the fused loop (``core.fused_solve``, one CUDA graph
of the masked step on the card), host-segmented with ``segment_iters >
0`` (``core.drive_phase_plan``), or in the driver's host loop
(:meth:`BlockAngularBackend.iterate`), as the dense backend does.

On a mesh (``BlockAngularBackend(mesh=)``, ``parallel/mesh.py``) the K
axis is split over the mesh's first axis, as the reference shards it (on
a hybrid mesh, its outer axis); a K that the axis does not divide is
padded with dead blocks (:func:`build_arrays`'s ``pad_blocks``: sentinel
index maps and a unit pad diagonal, so they add nothing). Each member
holds its contiguous K/R blocks: their (K/R, mb, nb) stack and their
columns of ``L_cat``, the border columns on the first member only, and
runs K1 on its lanes and on its linking columns; its partial Σ L·D·Lᵀ −
Σ G·H is summed over the axis (the reference's ``MPI_Allreduce`` of
Schur blocks, ``BASELINE.json:5``). The link×link factor is then
``ops/dist_chol.py::chol_tri_inv_mesh`` over the mesh's last axis, as in
the reference: an explicit inverse split by columns, applied as
``Ls·v`` (a sum of slab products) and ``Lsᵀ·u`` (zero-filled slots,
summed), so a mesh solve is numerically another route than ``mesh=None``
(here as in the reference). Vectors stay replicated on every member;
each member's rows and columns of a product come back in a zero-filled
vector summed over the axis, so every rank holds the same bits. A sum
is one all-reduce on a process-group mesh (NCCL records it into the
fused loop's graph; gloo on a card runs the loop uncaptured, and says
so) and a sum in member order on a local mesh. :meth:`BlockAngularBackend.
reshard` is the SHRINK rung's seam: a fresh backend on the survivors'
mesh, whose setup pads K to the new width. ``SolverConfig.mesh_shape``
is not read, as in the reference: such a config solves on one device.

Not ported, and refused with ``NotImplementedError`` naming the ROADMAP
item: the TPU schedules (``mixed``, ``f64c``, ``pcg`` and the two-phase
plan; item 5b).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from distributedlpsolver_tpu_torch.backends.base import SolverBackend, register_backend
from distributedlpsolver_tpu_torch.backends.dense import _mode, _torch_dtype, resolve_device
from distributedlpsolver_tpu_torch.ipm import core
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.ipm.state import IPMState, StepStats
from distributedlpsolver_tpu_torch.models.problem import InteriorForm
from distributedlpsolver_tpu_torch.models.structure import column_block_ids
from distributedlpsolver_tpu_torch.ops import dist_chol
from distributedlpsolver_tpu_torch.ops.normal_eq import normal_eq
from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib


class BlockLayout(NamedTuple):
    K: int
    mb: int
    nb: int
    link: int
    n0: int
    n: int
    m: int


class BlockArrays(NamedTuple):
    """The arrow-structured A as host arrays (what :func:`build_arrays`
    slices out of the sparse matrix)."""

    B_all: np.ndarray  # (K, mb, nb) diagonal blocks, zero-padded rows/cols
    L_cat: np.ndarray  # (link, K·nb + n0) linking rows: block columns, then border
    col_idx: np.ndarray  # (K, nb) interior column of each block column (n: padding)
    border_idx: np.ndarray  # (n0,) interior columns of the border
    row_idx: np.ndarray  # (K, mb) interior row of each block row (m: padding)
    link_idx: np.ndarray  # (link,) interior rows of the linking system


class BlockTensors(NamedTuple):
    """:class:`BlockArrays` on the device, with the maps the operators
    read: ``cat_idx`` gathers x (padded with a zero at n) into ``L_cat``'s
    column order; ``row_pos``/``col_pos`` map each interior row/column to
    its slot in the flattened (blocks, then linking/border) outputs;
    ``pad_diag`` is 1 on the padding rows of each block."""

    B_all: torch.Tensor
    L_cat: torch.Tensor
    col_idx: torch.Tensor
    border_idx: torch.Tensor
    row_idx: torch.Tensor
    link_idx: torch.Tensor
    cat_idx: torch.Tensor
    row_pos: torch.Tensor
    col_pos: torch.Tensor
    pad_diag: torch.Tensor


def analyze_structure(inf: InteriorForm) -> Tuple[BlockLayout, dict]:
    """Derive the interior-form block layout from the problem's hint (the
    reference's ``analyze_structure``, line for line).

    Two hint formats are accepted: the uniform ``{num_blocks, block_m,
    link_m}`` (rows ordered [K·block_m block rows, link_m linking rows])
    and the general ``{num_blocks, row_block}`` with ``row_block[i] ∈ {-1
    (linking), 0..K-1}`` in any order with ragged block sizes (what
    ``models/structure.py``'s detector emits). A column belongs to the
    block of its non-linking rows; columns touched only by linking rows
    form the border. Raises ValueError when the hint is missing or wrong,
    or a column spans two blocks."""
    hint = inf.block_structure
    if not hint:
        raise ValueError(
            "block backend needs problem.block_structure "
            "{num_blocks, block_m, link_m} or {num_blocks, row_block}"
        )
    m, n = inf.m, inf.n
    K = int(hint["num_blocks"])
    if "row_block" in hint:
        row_block = np.asarray(hint["row_block"], dtype=np.int64)
        if row_block.shape != (m,):
            raise ValueError(f"row_block has shape {row_block.shape}, expected ({m},)")
        if row_block.min() < -1 or row_block.max() >= K:
            # An out-of-range id would drop that row's equation from every
            # operator: reject instead of solving another LP.
            raise ValueError(
                f"row_block ids must lie in [-1, {K - 1}], got range "
                f"[{row_block.min()}, {row_block.max()}]"
            )
    else:
        mb_u, link_u = int(hint["block_m"]), int(hint["link_m"])
        if K * mb_u + link_u != m:
            raise ValueError(f"structure hint rows {K}*{mb_u}+{link_u} != m={m}")
        row_block = np.concatenate(
            [np.repeat(np.arange(K, dtype=np.int64), mb_u), np.full(link_u, -1)]
        )
    sizes = np.bincount(row_block[row_block >= 0], minlength=K)
    mb = int(sizes.max()) if K else 0
    link = int((row_block == -1).sum())

    A = sp.csc_matrix(inf.A) if sp.issparse(inf.A) else sp.csc_matrix(np.asarray(inf.A))
    block_of_col = column_block_ids(A, row_block, validate=True)
    counts = np.bincount(block_of_col[block_of_col >= 0], minlength=K)
    nb = int(counts.max()) if K else 0
    border = np.flatnonzero(block_of_col == -1)
    layout = BlockLayout(K=K, mb=mb, nb=nb, link=link, n0=len(border), n=n, m=m)
    return layout, {"block_of_col": block_of_col, "border": border, "A": A, "row_block": row_block}


def build_arrays(inf: InteriorForm, pad_blocks: int = 0) -> Tuple[BlockArrays, BlockLayout]:
    """Slice the blocks out of the sparse matrix on the host, densifying
    only the (mb, nb_k) and (link, nb_k) tiles that exist — never the
    whole A (the reference's ``build_tensors``, with the linking rows laid
    out as ``L_cat``). ``pad_blocks`` appends DEAD blocks to the K axis,
    as the reference's does: all-sentinel index maps, zero tiles and zero
    ``L_cat`` columns; the unit pad diagonal factors them cleanly, G_k = 0
    adds nothing to the Schur sum, and nothing scatters back (the ragged
    tail that lets any mesh width divide the K axis)."""
    lay, info = analyze_structure(inf)
    lay = lay._replace(K=lay.K + max(0, int(pad_blocks)))
    K, mb, nb, link, n0, n, m = lay
    Ar = info["A"].tocsr()
    block_of_col, border, row_block = info["block_of_col"], info["border"], info["row_block"]
    link_rows = np.flatnonzero(row_block == -1)
    A_link = Ar[link_rows].tocsc() if link else sp.csc_matrix((0, n))

    B_all = np.zeros((K, mb, nb))
    L_cat = np.zeros((link, K * nb + n0))
    col_idx = np.full((K, nb), n, dtype=np.int64)
    row_idx = np.full((K, mb), m, dtype=np.int64)
    for k in range(K):
        cols = np.flatnonzero(block_of_col == k)
        rows = np.flatnonzero(row_block == k)
        col_idx[k, : len(cols)] = cols
        row_idx[k, : len(rows)] = rows
        B_all[k, : len(rows), : len(cols)] = Ar[rows][:, cols].toarray()
        L_cat[:, k * nb : k * nb + len(cols)] = A_link[:, cols].toarray()
    if n0:
        L_cat[:, K * nb :] = A_link[:, border].toarray()
    return BlockArrays(B_all, L_cat, col_idx, border.astype(np.int64), row_idx, link_rows), lay


def place_tensors(arrays: BlockArrays, lay: BlockLayout, dtype, device) -> BlockTensors:
    """Move the arrays to ``device`` in ``dtype`` (one copy each) with the
    inverse maps the operators gather through: the whole layout as one
    member (:func:`place_member`). Every interior row is a block row or a
    linking row, and every column a block column or a border column, so
    no map may point at the zero slot."""
    K, mb, nb, link, n0, n, m = lay
    t = place_member(arrays, lay, 0, 1, dtype, device)
    if bool((t.row_pos == K * mb + link).any()) or bool((t.col_pos == K * nb + n0).any()):
        raise ValueError("block layout leaves an interior row or column unmapped")
    return t


def build_tensors(inf: InteriorForm, dtype, device) -> Tuple[BlockTensors, BlockLayout]:
    arrays, lay = build_arrays(inf)
    return place_tensors(arrays, lay, dtype, device), lay


def place_member(arrays: BlockArrays, lay: BlockLayout, r: int, R: int, dtype,
                 device) -> BlockTensors:
    """Member ``r`` of ``R``'s share of the arrays on ``device``: blocks
    ``[r·K/R, (r+1)·K/R)`` (K a multiple of R: :func:`build_arrays` pads
    it), their columns of ``L_cat``, and the border on member 0 only.
    ``row_pos``/``col_pos`` map every interior row/column to its slot in
    the member's flattened (blocks, then linking/border) outputs, or to
    the zero slot past them when another member owns it."""
    K, mb, nb, link, n0, n, m = lay
    Kr = K // R
    ks = slice(r * Kr, (r + 1) * Kr)
    border = np.asarray(arrays.border_idx, dtype=np.int64) if r == 0 else np.zeros(0, np.int64)
    lo, hi = r * Kr * nb, (r + 1) * Kr * nb
    if R == 1:
        L_cat = arrays.L_cat
    elif r == 0:
        L_cat = np.concatenate([arrays.L_cat[:, lo:hi], arrays.L_cat[:, K * nb :]], axis=1)
    else:
        L_cat = arrays.L_cat[:, lo:hi]
    col_idx = np.asarray(arrays.col_idx[ks], dtype=np.int64)
    row_idx = np.asarray(arrays.row_idx[ks], dtype=np.int64)
    link_idx = np.asarray(arrays.link_idx, dtype=np.int64)
    row_pos = np.full(m, Kr * mb + link, dtype=np.int64)
    real = row_idx < m
    row_pos[row_idx[real]] = np.flatnonzero(real.ravel())
    row_pos[link_idx] = Kr * mb + np.arange(link)
    col_pos = np.full(n, Kr * nb + len(border), dtype=np.int64)
    real = col_idx < n
    col_pos[col_idx[real]] = np.flatnonzero(real.ravel())
    col_pos[border] = Kr * nb + np.arange(len(border))

    def put(a, dt=None):
        return torch.tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    return BlockTensors(
        B_all=put(arrays.B_all[ks], dtype), L_cat=put(L_cat, dtype), col_idx=put(col_idx),
        border_idx=put(border), row_idx=put(row_idx), link_idx=put(link_idx),
        cat_idx=put(np.concatenate([col_idx.ravel(), border])), row_pos=put(row_pos),
        col_pos=put(col_pos), pad_diag=put(row_idx == m, dtype),
    )


def _pad(v):
    return torch.cat([v, v.new_zeros(1)])


def _rel_diag_reg_(M, reg):
    """Per-row relative diagonal perturbation, in place on ``M``'s
    diagonal (one matrix or a batch)."""
    diag = M.diagonal(dim1=-2, dim2=-1)
    diag.add_(diag * reg)
    return M


def _cholesky(M):
    """Cholesky factor(s) of ``M``; a failed factorization becomes a NaN
    factor on the device, as the reference's Cholesky reports it (no host
    sync)."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info == 0)[..., None, None], L, float("nan"))


def _cho_solve(L, rhs):
    """``(L·Lᵀ)⁻¹·rhs`` by two triangular solves on ``L`` in place."""
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def _block_ops(t: BlockTensors, lay: BlockLayout, reg) -> core.LinOps:
    """LinOps over the arrow structure (the reference's ``_block_ops`` on
    its direct path) at regularization ``reg``: a host float (the host
    loop) or a device scalar (the fused loop)."""
    K, mb, nb, link, n0, n, m = lay
    Kn = K * nb
    # L_k as a (K, nb, link) view of L_cat's block columns (no copy:
    # the batched GEMM reads it transposed in place).
    L_view = t.L_cat[:, :Kn].view(link, K, nb).permute(1, 2, 0)

    def matvec(x):
        xc = _pad(x)[t.cat_idx]
        y_blocks = torch.bmm(t.B_all, xc[:Kn].view(K, nb, 1)).view(K * mb)
        y_link = t.L_cat @ xc
        return torch.cat([y_blocks, y_link])[t.row_pos]

    def rmatvec(y):
        yb = _pad(y)[t.row_idx]
        g = t.L_cat.T @ y[t.link_idx]
        g_blocks = torch.bmm(t.B_all.mT, yb.view(K, mb, 1)).view(Kn) + g[:Kn]
        return torch.cat([g_blocks, g[Kn:]])[t.col_pos]

    def factorize(d):
        dc = _pad(d)[t.cat_idx]
        dB = dc[:Kn].view(K, nb)
        # Padding rows are all-zero in B_all, so zero rows and columns of
        # M_kk that would sink the Cholesky. A unit diagonal decouples
        # them: their right-hand sides are zero, so are their solutions.
        Mkk = normal_eq(t.B_all, dB)
        Mkk.diagonal(dim1=-2, dim2=-1).add_(t.pad_diag)
        Lk = _cholesky(_rel_diag_reg_(Mkk, reg))
        GT = torch.bmm(t.B_all * dB[:, None, :], L_view)  # (K, mb, link) = G_kᵀ
        H = _cho_solve(Lk, GT)  # M_kk⁻¹·G_kᵀ
        # S = M_LL − Σ_k G_k·H_k: the K sum contracted inside one GEMM.
        S = normal_eq(t.L_cat, dc)
        S.addmm_(GT.reshape(K * mb, link).mT, H.reshape(K * mb, link), alpha=-1.0)
        return Lk, _cholesky(_rel_diag_reg_(S, reg)), GT

    def solve(factors, r):
        Lk, Ls, GT = factors
        G2 = GT.reshape(K * mb, link)
        rb = _pad(r)[t.row_idx]
        tmp = _cho_solve(Lk, rb[:, :, None]).view(K * mb)
        rS = r[t.link_idx] - G2.mT @ tmp
        yL = _cho_solve(Ls, rS[:, None])[:, 0]
        yb = _cho_solve(Lk, (rb - (G2 @ yL).view(K, mb))[:, :, None]).view(K * mb)
        return torch.cat([yb, yL])[t.row_pos]

    return core.LinOps(
        matvec=matvec, rmatvec=rmatvec, factorize=factorize, solve=solve,
    )


def _mesh_block_ops(parts, lay: BlockLayout, mesh, reg, panel: int = 256) -> core.LinOps:
    """LinOps over the arrow structure split over ``mesh`` (the module
    note): ``parts`` are the members' :func:`place_member` tensors this
    process holds (every member of the first axis on a local mesh, this
    rank's on a process-group mesh); ``lay`` is the whole (padded) layout.
    A factorization makes one sum of S over the first axis and the ``2·P``
    panel sums of ``chol_tri_inv_mesh`` over the last; a Newton solve
    four sums (Σ G·tmp, ``Ls·v``, ``Lsᵀ·u``, the block rows of y); a
    product one."""
    K, mb, nb, link, n0, n, m = lay
    baxis = mesh.axis_names[0]
    laxis = mesh.axis_names[-1]
    link_idx = parts[0].link_idx

    def shape(t):
        Kr = t.B_all.shape[0]
        return Kr, Kr * nb

    def on(v, t):
        return v.to(t.B_all.device)

    def matvec(x):
        outs = []
        for t in parts:
            Kr, Kn = shape(t)
            xc = _pad(on(x, t))[t.cat_idx]
            y_blocks = torch.bmm(t.B_all, xc[:Kn].view(Kr, nb, 1)).view(Kr * mb)
            y_link = t.L_cat @ xc
            outs.append(torch.cat([y_blocks, y_link, y_link.new_zeros(1)])[t.row_pos])
        return mesh.sum_parts(outs, baxis)

    def rmatvec(y):
        outs = []
        for t in parts:
            Kr, Kn = shape(t)
            yt = on(y, t)
            yb = _pad(yt)[t.row_idx]
            g = t.L_cat.T @ yt[t.link_idx]
            g_blocks = torch.bmm(t.B_all.mT, yb.view(Kr, mb, 1)).view(Kn) + g[:Kn]
            outs.append(torch.cat([g_blocks, g[Kn:], g.new_zeros(1)])[t.col_pos])
        return mesh.sum_parts(outs, baxis)

    def factorize(d):
        blocks, S_parts = [], []
        for t in parts:
            Kr, Kn = shape(t)
            dc = _pad(on(d, t))[t.cat_idx]
            dB = dc[:Kn].view(Kr, nb)
            Mkk = normal_eq(t.B_all, dB)
            Mkk.diagonal(dim1=-2, dim2=-1).add_(t.pad_diag)
            Lk = _cholesky(_rel_diag_reg_(Mkk, reg))
            L_view = t.L_cat[:, :Kn].view(link, Kr, nb).permute(1, 2, 0)
            GT = torch.bmm(t.B_all * dB[:, None, :], L_view)
            blocks.append((Lk, GT))
            if link:
                H = _cho_solve(Lk, GT)
                S = normal_eq(t.L_cat, dc)
                S.addmm_(GT.reshape(Kr * mb, link).mT, H.reshape(Kr * mb, link), alpha=-1.0)
                S_parts.append(S)
        if not link:
            return blocks, None
        S = mesh.sum_parts(S_parts, baxis)
        return blocks, dist_chol.chol_tri_inv_mesh(_rel_diag_reg_(S, reg), mesh, laxis, panel)

    def solve(factors, r):
        blocks, Ls = factors
        rbs, tmps = [], []
        for t, (Lk, GT) in zip(parts, blocks):
            Kr, _ = shape(t)
            rb = _pad(on(r, t))[t.row_idx]
            rbs.append(rb)
            tmp = _cho_solve(Lk, rb[:, :, None]).view(Kr * mb)
            tmps.append(GT.reshape(Kr * mb, link).mT @ tmp)
        if link:
            rS = r[link_idx] - mesh.sum_parts(tmps, baxis)
            yL = dist_chol.apply_t(Ls, dist_chol.apply(Ls, rS, mesh), mesh)
        else:
            yL = r.new_zeros(0)
        outs = []
        for t, (Lk, GT), rb in zip(parts, blocks, rbs):
            Kr, _ = shape(t)
            G2 = GT.reshape(Kr * mb, link)
            yb = _cho_solve(Lk, (rb - (G2 @ on(yL, t)).view(Kr, mb))[:, :, None]).view(Kr * mb)
            outs.append(torch.cat([yb, yb.new_zeros(link + 1)])[t.row_pos])
        out = mesh.sum_parts(outs, baxis)
        out[link_idx] = yL
        return out

    return core.LinOps(matvec=matvec, rmatvec=rmatvec, factorize=factorize, solve=solve)


def _step_fn(make_ops, data, params):
    """``(state, reg) -> (state', stats)``: one Mehrotra step over the
    arrow structure with ``make_ops(reg)``'s LinOps, the fused loop's
    ``step_fn``."""
    def step(state, reg):
        return core.mehrotra_step(make_ops(reg), data, params, state)

    return step


def _block_solve_full(make_ops, data, state0, reg0, params, max_iter, max_refactor, reg_grow,
                      buf_cap, stall_window=0, report=None, capture=True):
    """The whole solve as one fused loop (the reference's
    ``_block_solve_full``, single phase): ``(state, it, status, buf)`` on
    the device; ``report`` gets the loop's body counts."""
    return core.fused_solve(
        _step_fn(make_ops, data, params), state0, reg0, params, max_iter, max_refactor,
        reg_grow, buf_cap, stall_window=stall_window,
        stall_patience_floor=1e3 * params.tol, report=report, capture=capture,
    )


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the torch package yet (ROADMAP Queue 1 item {item})"
    )


@register_backend("block", "schur", "block-angular")
class BlockAngularBackend(SolverBackend):
    """Schur-complement execution over the arrow structure on one CUDA
    card (or the CPU when asked for with ``device="cpu"``), or with
    ``mesh`` over its members (the module note). With a mesh the device
    defaults to the mesh's."""

    # The panel width ``chol_tri_inv_mesh`` aims at (the reference's
    # default): the link factor's sums a factorization are 2·⌈mp/pb⌉.
    link_panel = 256

    def __init__(self, device=None, mesh=None):
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"mesh device {mesh.device} != backend device {device}")
            device = mesh.device
        self.device = resolve_device(device)
        self._mesh = mesh
        self._reg: float = 0.0
        self._cfg: Optional[SolverConfig] = None
        self._decide_capture()

    def _decide_capture(self) -> None:
        """Whether the fused loop may capture its body into a CUDA graph
        (``parallel.mesh.capture_off_reason``)."""
        reason = mesh_lib.capture_off_reason(self._mesh, self.device)
        self.capture = reason is None
        self.capture_off_reason = reason

    def setup(self, inf: InteriorForm, config: SolverConfig) -> None:
        if config.solve_mode == "pcg":
            raise _unported("the block tier's pcg mode", "5b")
        self._cfg = config
        self._reg = config.reg_dual
        self._params = config.step_params()
        self._dtype = _torch_dtype(config.dtype)
        if self.device.type == "cuda":
            # Library matmuls in true fp32, never TF32, for float32 runs.
            torch.backends.cuda.matmul.allow_tf32 = False
        mesh = self._mesh
        t0 = time.perf_counter()
        pad = 0
        if mesh is not None:
            # Blocks ride the first (outer) mesh axis; a K it does not
            # divide gets dead blocks (the reference's ragged tail).
            R = int(mesh.shape[mesh.axis_names[0]])
            pad = (-int((inf.block_structure or {}).get("num_blocks", 0))) % R
        arrays, self._lay = build_arrays(inf, pad_blocks=pad)
        t1 = time.perf_counter()
        if mesh is None:
            self._tensors = place_tensors(arrays, self._lay, self._dtype, self.device)
        else:
            self._parts = [place_member(arrays, self._lay, r, R, self._dtype, dev)
                           for r, dev in mesh.axis_members(mesh.axis_names[0])]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        self.setup_report = {"build_arrays_s": t1 - t0, "transfer_s": t2 - t1}
        self._data = core.make_problem_data(
            np.asarray(inf.c, dtype=np.float64), np.asarray(inf.b, dtype=np.float64),
            np.asarray(inf.u, dtype=np.float64), self._dtype, self.device,
        )
        # Per-iteration FLOP estimate (the reference's): per-block normal
        # equations and Cholesky plus the linking system's dense work.
        K, mb, nb, link, n0, n, m = self._lay
        self._f64_flops = K * (2.0 * mb * mb * nb + mb**3 / 3.0) + (
            2.0 * link * link * (K * nb + n0) + link**3 / 3.0
        )

    @property
    def mesh(self):
        """The mesh the K axis is split over, or None (one device)."""
        return self._mesh

    @property
    def layout(self) -> BlockLayout:
        return self._lay

    def _make_ops(self, reg) -> core.LinOps:
        """The step's LinOps at regularization ``reg``."""
        if self._mesh is None:
            return _block_ops(self._tensors, self._lay, reg)
        return _mesh_block_ops(self._parts, self._lay, self._mesh, reg, self.link_panel)

    def _ops(self) -> core.LinOps:
        return self._make_ops(self._reg)

    def _reg0(self) -> torch.Tensor:
        return torch.full((), self._reg, dtype=self._dtype, device=self.device)

    def starting_point(self) -> IPMState:
        return core.starting_point(self._ops(), self._data, self._params)

    def _solve_segmented(self, state: IPMState):
        """Host-driven segmented fused solve, one full-precision phase
        (the reference's ``_solve_segmented`` "f64" plan), through the
        shared driver. The phase captures its loop once; every segment
        replays it."""
        cfg = self._cfg
        buf_cap = core.buffer_cap(cfg.max_iter)
        w = cfg.stall_window
        window, patience = (2 * w if w else 0), 1e3 * cfg.tol
        loops = []

        def make_run_seg(bound):
            loop = core.fused_loop(
                _step_fn(self._make_ops, self._data, self._params), self._params,
                buf_cap, self.device, self._dtype, stall_window=window,
                stall_patience_floor=patience, capture=self.capture,
            )
            loops.append(loop)

            def run_seg(c, stop):
                return loop.run(c, max_iter=bound, it_stop=stop,
                                max_refactor=cfg.max_refactor, reg_grow=cfg.reg_grow)

            return run_seg

        seg0 = core.seg_open(cfg.segment_iters, self._f64_flops / core.SEG_RATE_F64)
        self.phase_report = []
        try:
            st, it, status, buf, _ = core.drive_phase_plan(
                [(make_run_seg, window, patience, seg0)], state, self._reg0(),
                cfg.max_iter, buf_cap, self._dtype, report=self.phase_report,
            )
            for row, loop in zip(self.phase_report, loops):
                row.update(mode=_mode(self._dtype), flops_per_iter=self._f64_flops,
                           captured=self.capture, capture_off_reason=self.capture_off_reason,
                           **loop.report())
        finally:
            for loop in loops:
                loop.close()
        return st, it, status, buf

    def solve_full(self, state: IPMState):
        """The fused loop from ``state``: host-segmented when
        ``segment_iters > 0``, else one run. Returns ``(state, it,
        status, buf)``, the last three on the host; ``self.phase_report``
        gets one row (the dense backend's keys plus ``flops_per_iter``).
        Each body launches K1 twice on each member this process holds (its
        K lanes and its linking columns), so K1 runs ``2·(1 + bodies)``
        times a solve on one device or one rank, the start included."""
        cfg = self._cfg
        if core.use_segments(cfg.segment_iters, self.device.type):
            st, it, status, buf = self._solve_segmented(state)
        else:
            w = cfg.stall_window
            loop = {}
            t0 = time.perf_counter()
            st, it, status, buf = _block_solve_full(
                self._make_ops, self._data, state, self._reg0(), self._params,
                cfg.max_iter, cfg.max_refactor, cfg.reg_grow, core.buffer_cap(cfg.max_iter),
                2 * w if w else 0, report=loop, capture=self.capture,
            )
            it = int(it)
            self.phase_report = [{
                "phase": 0, "iters": it, "wall_s": round(time.perf_counter() - t0, 3),
                "mode": _mode(self._dtype), "flops_per_iter": self._f64_flops,
                "captured": self.capture, "capture_off_reason": self.capture_off_reason, **loop,
            }]
        return st, torch.tensor(int(it)), status.cpu(), buf.cpu()

    def iterate(self, state: IPMState) -> Tuple[IPMState, StepStats]:
        new_state, stats = core.mehrotra_step(self._ops(), self._data, self._params, state)
        # One device→host copy of every scalar an iteration.
        host = torch.stack([v.to(self._dtype) for v in stats]).cpu().tolist()
        return new_state, StepStats(*host[:-1], bad=bool(host[-1]))

    def bump_regularization(self) -> bool:
        if self._reg * self._cfg.reg_grow > 1e-2:
            return False
        self._reg = max(self._reg, 1e-12) * self._cfg.reg_grow
        return True

    def reshard(self, mesh) -> "BlockAngularBackend":
        """A fresh instance on ``mesh`` — the SHRINK rung's seam (the
        reference's): its setup pads K to the new mesh's first axis with
        dead blocks, so any survivor count re-shards; the supervisor
        resumes from the host-canonical checkpoint."""
        return type(self)(mesh=mesh)

    def to_host(self, state: IPMState) -> IPMState:
        return IPMState(*(v.detach().cpu().numpy() for v in state))

    def from_host(self, state: IPMState) -> IPMState:
        return IPMState(
            *(torch.tensor(np.asarray(v, dtype=np.float64), dtype=self._dtype,
                           device=self.device) for v in state)
        )

    def block_until_ready(self, obj) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
