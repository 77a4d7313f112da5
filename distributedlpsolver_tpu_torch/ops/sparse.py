"""Padded fixed-shape sparse operator for the matrix-free solve tier.

The single-device half of the JAX package's ``ops/sparse.py``: a hybrid
row-ELL representation of the constraint matrix — ``vals``/``cols``
padded to one nonzeros-per-row width, plus a COO spill ``tail`` for the
few rows heavier than that width — and the same hybrid for Aᵀ, whose
``matvec``/``rmatvec``/``normal_diag`` never form the m×m normal matrix
``A·diag(d)·Aᵀ`` in any format.

Why hybrid: a plain ELL pads every row to the widest row's count, and the
storm-class bordered pattern turns each first-stage column into a
transpose row with K·t entries. The width stays at a quantile of the
row-count distribution and the heavy rows spill into the tail. The
quantization constants, the width quantile and the dense fallback below
are the JAX package's: they decide the shapes, and so the results.

In this package the operator is a frozen dataclass of tensors on one
device (no pytree). Beside the hybrid it holds the kernel's own layout of
each direction, a sliced ELL (``ops/ell_spmv.py::SellLayout``: slices of
32 rows sorted by live count, heavy rows in chunks), built once here from
the CSR. Its products go through ``ops/ell_spmv.py``: the hand-written
CUDA kernel on that layout on a card (every output summed in one fixed
order, no atomics), the JAX package's eager formula over the hybrid on the
CPU. The dense fallback stores A itself and its products are library
GEMVs, as they are XLA's in the JAX package.

The row-distributed tier, :class:`RowShardedOperator` (built by
:func:`shard_rows`), splits A into contiguous row blocks over a mesh
(``parallel/mesh.py``), each block a :class:`SparseOperator` of its own
(global columns, so its kernel layouts are A_r's and A_rᵀ's) on its
member's device. Where the JAX package keeps m-vectors flat and sharded
and lets XLA insert the psum, the vectors here stay replicated (as in
``backends/sharded.py``) and the operator calls the collectives itself:

* ``rmatvec(y)`` = ``all_reduce(A_rᵀ·y[lo:hi])`` — the reference's one
  n-vector psum;
* ``matvec(v)``, ``normal_diag`` and ``normal_matvec``: each member writes
  its rows into a zeroed m-vector, then ``all_reduce`` (a sum with zeros
  is exact, so every row keeps its bits);
* ``normal_matvec(d, reg, v)`` = that gather of ``A_r·(d ∘ rmatvec(v)) +
  reg·v[lo:hi]``: two collectives a CG iteration, an n-vector sum and an
  m-vector gather.

Every member then holds the same bits of every vector, so CG and the step
take the same branches everywhere with no collective of their own. A
local mesh (several devices of one process) sums its members' partials in
member order on the first member's device, and concatenates the rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from distributedlpsolver_tpu_torch.ops.ell_spmv import (
    EllTail,
    SellLayout,
    ell_normal_diag,
    ell_spmv,
    sell_entry_rows,
    sell_layout,
)

# Quantize the ELL pad width so instances with nearly-equal row-count
# quantiles share one (m, k) shape: width rounds up to the next multiple.
_PAD_QUANTUM = 8

# Quantize the COO spill-tail length the same way (pad entries point at a
# synthetic row with value 0, so they add nothing).
_TAIL_QUANTUM = 256

# ELL width = this quantile of the per-row nonzero counts; rows heavier
# than the (quantized) quantile spill their excess into the tail.
_WIDTH_QUANTILE = 0.98

# Above this density the ELL gathers cost more than a dense GEMV and the
# padded arrays approach the dense footprint — store dense instead.
DENSE_FALLBACK_DENSITY = 0.25

# Below this many entries a dense operator is unconditionally cheaper.
_DENSE_FALLBACK_ENTRIES = 16_384

_FIELDS = (
    "vals", "cols", "tail_vals", "tail_rows", "tail_cols",
    "tvals", "tcols", "ttail_vals", "ttail_rows", "ttail_cols",
    "dense",
)
_LAYOUTS = ("sell", "tsell")


@dataclasses.dataclass(frozen=True)
class SparseOperator:
    """Fixed-shape sparse (or dense-fallback) linear operator on one device.

    ``fmt == "ell"``: ``vals``/``cols`` are (m, k) row-ELL arrays of A (pad
    entries carry col 0 / val 0) and ``tail_vals``/``tail_rows``/
    ``tail_cols`` the fixed-length COO spill of rows wider than k (pad
    entries carry row m / val 0), ``t*`` the same hybrid for Aᵀ: the JAX
    package's layout, which the plain version reads. ``sell``/``tsell``
    are the kernel's sliced-ELL layouts of A and Aᵀ. ``fmt == "dense"``:
    ``dense`` holds A and the other fields are None.
    """

    shape: Tuple[int, int]
    nnz: int
    fmt: str  # "ell" | "dense"
    vals: Optional[torch.Tensor] = None  # (m, k)
    cols: Optional[torch.Tensor] = None  # (m, k) int32
    tail_vals: Optional[torch.Tensor] = None  # (t,)
    tail_rows: Optional[torch.Tensor] = None  # (t,) int32, pad → m
    tail_cols: Optional[torch.Tensor] = None  # (t,) int32
    tvals: Optional[torch.Tensor] = None  # (n, kt)
    tcols: Optional[torch.Tensor] = None  # (n, kt) int32
    ttail_vals: Optional[torch.Tensor] = None  # (tt,)
    ttail_rows: Optional[torch.Tensor] = None  # (tt,) int32, pad → n
    ttail_cols: Optional[torch.Tensor] = None  # (tt,) int32
    sell: Optional[SellLayout] = None  # the kernel's layout of A
    tsell: Optional[SellLayout] = None  # ... and of Aᵀ
    dense: Optional[torch.Tensor] = None  # (m, n) fallback

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def density(self) -> float:
        return self.nnz / max(self.m * self.n, 1)

    @property
    def dtype(self):
        return self.dense.dtype if self.fmt == "dense" else self.vals.dtype

    @property
    def device(self):
        return self.dense.device if self.fmt == "dense" else self.vals.device

    def tail(self) -> Optional[EllTail]:
        if self.tail_vals is None:
            return None
        return EllTail(self.tail_vals, self.tail_rows, self.tail_cols)

    def ttail(self) -> Optional[EllTail]:
        if self.ttail_vals is None:
            return None
        return EllTail(self.ttail_vals, self.ttail_rows, self.ttail_cols)

    # -- linear maps ------------------------------------------------------

    def matvec(self, v):
        """A @ v, (n,) → (m,)."""
        if self.fmt == "dense":
            return self.dense @ v
        return ell_spmv(self.vals, self.cols, v, self.tail(), layout=self.sell)

    def rmatvec(self, v):
        """Aᵀ @ v, (m,) → (n,), through the transpose hybrid."""
        if self.fmt == "dense":
            return self.dense.T @ v
        return ell_spmv(self.tvals, self.tcols, v, self.ttail(), layout=self.tsell,
                        transpose=True)

    def normal_matvec(self, d, reg, v):
        """``v ↦ A·(d ∘ Aᵀv) + reg·v``, CG's operator on the normal
        equations, never forming A·diag(d)·Aᵀ."""
        return self.matvec(d * self.rmatvec(v)) + reg * v

    def normal_diag(self, d, reg=0.0):
        """diag(A·diag(d)·Aᵀ) + reg without forming the normal matrix:
        entry i is Σ_j A_ij²·d_j."""
        if self.fmt == "dense":
            return torch.sum(self.dense * self.dense * d[None, :], dim=1) + reg
        return ell_normal_diag(self.vals, self.cols, d, self.tail(), reg, layout=self.sell)

    def row_norms(self):
        """Per-row 2-norms of A."""
        if self.fmt == "dense":
            return torch.sqrt(torch.sum(self.dense * self.dense, dim=1))
        ones = torch.ones(self.n, dtype=self.dtype, device=self.device)
        return torch.sqrt(ell_normal_diag(self.vals, self.cols, ones, self.tail(),
                                          layout=self.sell))

    def col_norms(self):
        if self.fmt == "dense":
            return torch.sqrt(torch.sum(self.dense * self.dense, dim=0))
        ones = torch.ones(self.m, dtype=self.dtype, device=self.device)
        return torch.sqrt(ell_normal_diag(self.tvals, self.tcols, ones, self.ttail(),
                                          layout=self.tsell))

    def scaled(self, dr, dc) -> "SparseOperator":
        """Dr·A·Dc as a new operator: only the value arrays (the hybrid's
        and the kernel layouts') are rescaled, the pattern (and the shapes)
        are untouched. The layouts' products are the hybrid's bit for bit."""
        dr = torch.as_tensor(np.asarray(dr), dtype=self.dtype, device=self.device)
        dc = torch.as_tensor(np.asarray(dc), dtype=self.dtype, device=self.device)
        if self.fmt == "dense":
            return dataclasses.replace(self, dense=self.dense * dr[:, None] * dc[None, :])
        # Pad entries index synthetic row m (col n); a 1 there keeps the
        # gather a no-op for them (their value is 0 anyway).
        one = torch.ones(1, dtype=self.dtype, device=self.device)
        dr1 = torch.cat([dr, one])
        dc1 = torch.cat([dc, one])
        rep = {
            "vals": self.vals * dr[:, None] * dc[self.cols],
            "tvals": self.tvals * dc[:, None] * dr[self.tcols],
        }
        if self.tail_vals is not None:
            rep["tail_vals"] = self.tail_vals * dr1[self.tail_rows] * dc[self.tail_cols]
        if self.ttail_vals is not None:
            rep["ttail_vals"] = self.ttail_vals * dc1[self.ttail_rows] * dr[self.ttail_cols]
        for name, lay, r_of, c_of in (("sell", self.sell, dr1, dc), ("tsell", self.tsell, dc1, dr)):
            if lay is not None:
                # A pad lane's slots (row -1) take r_of's trailing 1. The
                # copy gets scratch of its own, so its launches need no
                # order with the original's.
                vals = lay.vals * r_of[sell_entry_rows(lay)] * c_of[lay.cols]
                rep[name] = lay._replace(vals=vals, partials=torch.zeros_like(lay.partials),
                                         counters=torch.zeros_like(lay.counters))
        return dataclasses.replace(self, **rep)

    # -- host-side helpers ------------------------------------------------

    def to_scipy(self) -> sp.csr_matrix:
        """Exact CSR reconstruction (tests / oracles)."""
        if self.fmt == "dense":
            return sp.csr_matrix(self.dense.double().cpu().numpy())
        m, k = self.vals.shape
        rows = np.repeat(np.arange(m), k)
        vals = self.vals.double().cpu().numpy().ravel()
        cols = self.cols.cpu().numpy().ravel()
        if self.tail_vals is not None:
            rows = np.concatenate([rows, self.tail_rows.cpu().numpy()])
            vals = np.concatenate([vals, self.tail_vals.double().cpu().numpy()])
            cols = np.concatenate([cols, self.tail_cols.cpu().numpy()])
        live = (vals != 0.0) & (rows < m)
        return sp.csr_matrix((vals[live], (rows[live], cols[live])), shape=self.shape)

    def nbytes(self) -> int:
        return sum(int(a.numel()) * a.element_size() for a in self._arrays())

    def memory_report(self) -> dict:
        """name → {shape, nbytes} of every device tensor held — the
        no-dense-normal-matrix guard: no entry may approach (m, m)."""
        return {
            name: {"shape": tuple(int(s) for s in a.shape), "nbytes": int(a.numel()) * a.element_size()}
            for name, a in self._named_arrays()
        }

    def _named_arrays(self):
        for name in _FIELDS:
            if getattr(self, name) is not None:
                yield name, getattr(self, name)
        for lay_name in _LAYOUTS:
            lay = getattr(self, lay_name)
            if lay is not None:
                for name, a in lay.tensors().items():
                    yield f"{lay_name}.{name}", a

    def _arrays(self):
        return [a for _, a in self._named_arrays()]


def _quantize(k: int, q: int) -> int:
    return max(q, -(-k // q) * q)


def _hybrid_width(A: sp.csr_matrix) -> int:
    """Quantized ``_WIDTH_QUANTILE`` ELL width for CSR ``A``."""
    m = A.shape[0]
    counts = np.diff(A.indptr)
    kmax = int(counts.max(initial=0))
    kq = int(np.quantile(counts, _WIDTH_QUANTILE)) if m else 0
    k = _quantize(max(kq, 1), _PAD_QUANTUM)
    if k >= kmax:
        k = _quantize(max(kmax, 1), _PAD_QUANTUM)
    return k


def _hybrid_fill(A: sp.csr_matrix, dtype, k, t, rows_out, pad_row):
    """Hybrid row-ELL of CSR ``A`` at forced shapes: an (rows_out, k) ELL
    block (rows beyond A's are all-pad) plus a COO tail of exactly ``t``
    entries (``t == 0`` → no tail; pad tail entries point at ``pad_row``
    with value 0)."""
    m = A.shape[0]
    counts = np.diff(A.indptr)
    # Position of each nonzero within its row, vectorized.
    offs = np.arange(A.nnz, dtype=np.int64) - np.repeat(A.indptr[:-1].astype(np.int64), counts)
    rowidx = np.repeat(np.arange(m, dtype=np.int64), counts)
    main = offs < k

    vals = np.zeros((rows_out, k), dtype=dtype)
    cols = np.zeros((rows_out, k), dtype=np.int32)
    vals[rowidx[main], offs[main]] = A.data[main]
    cols[rowidx[main], offs[main]] = A.indices[main]

    if t == 0:
        return vals, cols, None, None, None
    spill = ~main
    t_live = int(spill.sum())
    tail_vals = np.zeros((t,), dtype=dtype)
    tail_rows = np.full((t,), pad_row, dtype=np.int32)
    tail_cols = np.zeros((t,), dtype=np.int32)
    tail_vals[:t_live] = A.data[spill]
    tail_rows[:t_live] = rowidx[spill]
    tail_cols[:t_live] = A.indices[spill]
    return vals, cols, tail_vals, tail_rows, tail_cols


def _tail_len(A: sp.csr_matrix, k: int) -> int:
    """Live spill-tail length of CSR ``A`` at ELL width ``k``."""
    counts = np.diff(A.indptr)
    return int(np.maximum(counts - k, 0).sum())


def _hybrid_from_csr(A: sp.csr_matrix, dtype):
    """(vals, cols, tail_vals, tail_rows, tail_cols) hybrid row-ELL of a
    CSR matrix, at the quantized quantile width and tail length."""
    m = A.shape[0]
    k = _hybrid_width(A)
    t_live = _tail_len(A, k)
    t = _quantize(t_live, _TAIL_QUANTUM) if t_live else 0
    return _hybrid_fill(A, dtype, k, t, m, m)


def _np_dtype(dtype):
    return {torch.float64: np.float64, torch.float32: np.float32}.get(dtype, dtype)


def _hybrid_tensors(A: sp.csr_matrix, dtype, device) -> dict:
    """The hybrid of ``A`` as tensors on ``device``, and the kernel's
    sliced-ELL layout of ``A`` (``sell``), built there from the CSR."""
    vals, cols, tv, tr, tc = _hybrid_from_csr(A, dtype)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    out = {"vals": put(vals), "cols": put(cols)}
    if tv is not None:
        out.update(tail_vals=put(tv), tail_rows=put(tr), tail_cols=put(tc))
    out["sell"] = sell_layout(A.indptr, A.indices, A.data, dtype=out["vals"].dtype, device=device)
    return out


def _sparse_fmt(m: int, n: int, nnz: int, density_threshold: float) -> str:
    """The storage a sparse m×n matrix with ``nnz`` entries gets: ELL
    unless dense-ish or tiny."""
    dens = nnz / max(m * n, 1)
    return "ell" if dens <= density_threshold and m * n > _DENSE_FALLBACK_ENTRIES else "dense"


def from_scipy(
    A,
    dtype=np.float64,
    density_threshold: float = DENSE_FALLBACK_DENSITY,
    device="cpu",
    fmt: Optional[str] = None,
) -> SparseOperator:
    """Build a :class:`SparseOperator` on ``device`` from scipy-sparse or
    dense input WITHOUT densifying sparse inputs; dense-ish or tiny inputs
    take the dense fallback. ``fmt`` ("ell" or "dense") forces the storage
    of a sparse input (a row block keeps its whole matrix's)."""
    dtype = _np_dtype(dtype)
    device = torch.device(device)
    if sp.issparse(A):
        A = A.tocsr()
        m, n = A.shape
        nnz = int(A.nnz)
        if (fmt or _sparse_fmt(m, n, nnz, density_threshold)) == "ell":
            fwd = _hybrid_tensors(A, dtype, device)
            rev = _hybrid_tensors(A.T.tocsr(), dtype, device)
            return SparseOperator(
                shape=(m, n), nnz=nnz, fmt="ell", **fwd,
                **{"t" + k: v for k, v in rev.items()},
            )
        Ad = np.asarray(A.todense(), dtype=dtype)
    else:
        Ad = np.asarray(A, dtype=dtype)
        nnz = int(np.count_nonzero(Ad))
    m, n = Ad.shape
    return SparseOperator(shape=(m, n), nnz=nnz, fmt="dense", dense=torch.from_numpy(Ad).to(device))


def from_problem(inf, dtype=np.float64, **kw) -> SparseOperator:
    """Operator over an LPProblem/InteriorForm's constraint matrix."""
    return from_scipy(inf.A, dtype=dtype, **kw)


# -- the row-distributed tier ------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RowShardedOperator:
    """Row-distributed operator over a mesh (see the module note).

    ``blocks[i]`` holds the global rows ``ranges[i]`` of A, with global
    columns, on its member's device: one block on a process-group mesh
    (this rank's), every member's on a local mesh. Vectors in and out are
    replicated on :attr:`device`."""

    shape: Tuple[int, int]
    nnz: int
    fmt: str  # "ell" | "dense", the whole matrix's (every block keeps it)
    mesh: object  # parallel.mesh.Mesh
    axis: str
    rows_per: int  # ⌈m/R⌉; the last block may hold fewer
    blocks: Tuple[SparseOperator, ...]
    ranges: Tuple[Tuple[int, int], ...]

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def num_shards(self) -> int:
        return int(self.mesh.shape[self.axis])

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def _group(self) -> bool:
        return not self.mesh.is_local

    def _sum(self, parts):
        """Σ over the members of their n-vector partials: one all-reduce
        over the axis, or on a local mesh the sum in member order."""
        return self.mesh.sum_parts(parts, self.axis)

    def _rows(self, parts):
        """The m-vector of the members' row blocks: this rank's rows in a
        zeroed vector summed over the axis, or on a local mesh the blocks
        concatenated."""
        if self._group:
            (lo, hi), = self.ranges
            out = torch.zeros(self.m, dtype=parts[0].dtype, device=self.device)
            out[lo:hi] = parts[0]
            return self.mesh.all_reduce(out, self.axis)
        return torch.cat([p.to(self.device) for p in parts])

    def _each(self, fn):
        return [fn(b, lo, hi) for b, (lo, hi) in zip(self.blocks, self.ranges)]

    # -- linear maps (every vector replicated) -----------------------------

    def matvec(self, v):
        """A @ v, (n,) → (m,): each block's rows, gathered."""
        return self._rows(self._each(lambda b, lo, hi: b.matvec(v.to(b.device))))

    def rmatvec(self, y):
        """Aᵀ @ y, (m,) → (n,): the blocks' partials A_rᵀ·y[lo:hi], summed
        (the one n-vector all-reduce)."""
        return self._sum(self._each(lambda b, lo, hi: b.rmatvec(y[lo:hi].to(b.device))))

    def normal_matvec(self, d, reg, v):
        """``v ↦ A·(d ∘ Aᵀv) + reg·v`` in :meth:`SparseOperator.
        normal_matvec`'s order (``rmatvec``, then ``matvec(d * ·) + reg *
        v``), so a mesh of one gives its bits."""
        w = d * self.rmatvec(v)
        return self._rows(self._each(
            lambda b, lo, hi: b.matvec(w.to(b.device)) + reg * v[lo:hi].to(b.device)))

    def normal_diag(self, d, reg=0.0):
        """diag(A·diag(d)·Aᵀ) + reg, each block's rows computed where they
        live, gathered."""
        return self._rows(self._each(lambda b, lo, hi: b.normal_diag(d.to(b.device), reg)))

    # -- host-side helpers -------------------------------------------------

    def to_scipy(self) -> sp.csr_matrix:
        """Exact CSR of A in global row order (tests). A rank of a
        process-group mesh holds only its block and raises."""
        if self._group and self.num_shards > 1:
            raise ValueError("a rank of a process-group mesh holds only its row block")
        return sp.vstack([b.to_scipy() for b in self.blocks]).tocsr()

    def memory_report(self) -> dict:
        """name → {shape, nbytes, nbytes_per_device} over the blocks this
        process holds (every member's on a local mesh, this rank's on a
        process-group mesh): ``nbytes`` their sum, ``nbytes_per_device``
        and ``shape`` the largest one's."""
        out = {}
        for rep in (b.memory_report() for b in self.blocks):
            for name, h in rep.items():
                e = out.setdefault(name, {"shape": h["shape"], "nbytes": 0, "nbytes_per_device": 0})
                e["nbytes"] += h["nbytes"]
                if h["nbytes"] > e["nbytes_per_device"]:
                    e["shape"], e["nbytes_per_device"] = h["shape"], h["nbytes"]
        return out

    def nbytes(self) -> int:
        """Operand bytes of the blocks this process holds."""
        return sum(b.nbytes() for b in self.blocks)

    def nbytes_per_device(self) -> int:
        """The most operand bytes one member holds."""
        return max(b.nbytes() for b in self.blocks)


def _shard_axis(mesh, axis: Optional[str] = None) -> str:
    if axis is not None:
        return axis
    return "batch" if "batch" in mesh.axis_names else mesh.axis_names[-1]


def shard_rows(op, mesh, dtype=None, axis: Optional[str] = None,
               density_threshold: float = DENSE_FALLBACK_DENSITY) -> RowShardedOperator:
    """Partition a :class:`SparseOperator` (or a scipy or dense matrix)
    row-wise over ``mesh``'s ``axis`` (default "batch" when the mesh has
    it, else its innermost) into a :class:`RowShardedOperator`.

    Member r owns the contiguous rows ``[r·⌈m/R⌉, min((r+1)·⌈m/R⌉, m))``
    (``Mesh.row_blocks``; fewer rows than members raises ``ValueError``).
    Each block is built by :func:`from_scipy` on its member's device in
    the storage :func:`from_scipy` gives the whole matrix, so a mesh of one
    holds the single-device operator."""
    if isinstance(op, SparseOperator):
        A, fmt = op.to_scipy(), op.fmt
        dtype = op.dtype if dtype is None else dtype
    elif sp.issparse(op):
        A = op.tocsr()
        fmt = _sparse_fmt(A.shape[0], A.shape[1], int(A.nnz), density_threshold)
    else:
        A, fmt = sp.csr_matrix(np.asarray(op)), "dense"
    dtype = np.float64 if dtype is None else dtype
    m, n = A.shape
    ax = _shard_axis(mesh, axis)
    spans = mesh.row_blocks(m, ax)
    blocks = tuple(from_scipy(A[lo:hi], dtype=dtype, device=dev, fmt=fmt) for dev, lo, hi in spans)
    R = int(mesh.shape[ax])
    return RowShardedOperator(
        shape=(m, n), nnz=int(A.nnz), fmt=fmt, mesh=mesh, axis=ax, rows_per=-(-m // R),
        blocks=blocks, ranges=tuple((lo, hi) for _, lo, hi in spans),
    )


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def ruiz_equilibrate(op: SparseOperator, iterations: int = 10, tol: float = 1e-2):
    """Sparse-aware Ruiz scaling on the operator itself: ∞-norm row/col
    equilibration computed on the host from the hybrid value arrays
    (O(nnz) a sweep), returning ``(scaled_op, dr, dc)`` with the
    convention of models/scaling.equilibrate (A' = Dr·A·Dc)."""
    if op.fmt == "dense":
        absA = np.abs(_host(op.dense).astype(np.float64))
        m, n = absA.shape
        dr = np.ones(m)
        dc = np.ones(n)
        for _ in range(iterations):
            row = absA.max(axis=1, initial=0.0)
            col = absA.max(axis=0, initial=0.0)
            if (np.abs(row[row > 0] - 1.0) < tol).all() and (np.abs(col[col > 0] - 1.0) < tol).all():
                break
            r = np.where(row > 0, 1.0 / np.sqrt(row), 1.0)
            c = np.where(col > 0, 1.0 / np.sqrt(col), 1.0)
            absA *= r[:, None]
            absA *= c
            dr *= r
            dc *= c
        return op.scaled(dr, dc), dr, dc
    vals = np.abs(_host(op.vals).astype(np.float64))
    tvals = np.abs(_host(op.tvals).astype(np.float64))
    cols = _host(op.cols)
    tcols = _host(op.tcols)
    has_tail = op.tail_vals is not None
    has_ttail = op.ttail_vals is not None
    if has_tail:
        a_tv = np.abs(_host(op.tail_vals).astype(np.float64))
        a_tr = _host(op.tail_rows)
        a_tc = _host(op.tail_cols)
    if has_ttail:
        t_tv = np.abs(_host(op.ttail_vals).astype(np.float64))
        t_tr = _host(op.ttail_rows)
        t_tc = _host(op.ttail_cols)
    dr = np.ones(op.m)
    dc = np.ones(op.n)
    for _ in range(iterations):
        row = np.zeros(op.m + 1)
        row[: op.m] = vals.max(axis=1, initial=0.0)
        if has_tail:
            np.maximum.at(row, a_tr, a_tv)
        row = row[: op.m]
        col = np.zeros(op.n + 1)
        col[: op.n] = tvals.max(axis=1, initial=0.0)
        if has_ttail:
            np.maximum.at(col, t_tr, t_tv)
        col = col[: op.n]
        if (np.abs(row[row > 0] - 1.0) < tol).all() and (np.abs(col[col > 0] - 1.0) < tol).all():
            break
        r = 1.0 / np.sqrt(np.where(row > 0, row, 1.0))
        c = 1.0 / np.sqrt(np.where(col > 0, col, 1.0))
        vals *= r[:, None]
        vals *= c[cols]
        tvals *= c[:, None]
        tvals *= r[tcols]
        if has_tail:
            r1 = np.concatenate([r, [1.0]])
            a_tv *= r1[a_tr] * c[a_tc]
        if has_ttail:
            c1 = np.concatenate([c, [1.0]])
            t_tv *= c1[t_tr] * r[t_tc]
        dr *= r
        dc *= c
    return op.scaled(dr, dc), dr, dc
