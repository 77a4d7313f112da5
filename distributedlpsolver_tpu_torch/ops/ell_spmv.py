"""Sparse products over a sliced ELL layout — the hand-written CUDA kernel
for the H100 and its plain PyTorch version.

The kernel (``csrc/ell_spmv.cu``) replaces the device routines the JAX
package's ``ops/sparse.py::SparseOperator`` leaves to XLA: ``matvec`` and
``rmatvec`` (a row-ELL gather-reduce plus a COO-tail scatter-add) and
``normal_diag`` (``diag(A·diag(d)·Aᵀ)`` without the matrix). Two
functions of a sparse matrix:

* :func:`ell_spmv` — ``out[i] = Σ_e val[e]·v[col[e]]`` over row i's entries;
* :func:`ell_normal_diag` — ``out[i] = Σ_e val[e]²·d[col[e]] + reg``.

Each uses its plain version for CPU tensors: the JAX package's eager
formula over its hybrid row-ELL arrays (``vals``/``cols`` (m, k) and the
COO tail of rows wider than k, :class:`EllTail`), ELL sum then an
``index_add_`` of the tail — which on a card adds with atomics, so the
card path never takes it. For CUDA tensors each launches the kernel (or
raises) on the operator's own layout, :class:`SellLayout`, built once at
setup by :func:`sell_layout` from the CSR: light rows in slices of 32
sorted by their live count within windows of :data:`WINDOW` rows and
padded to each slice's widest row; rows with more than :data:`HEAVY_MIN`
entries cut into chunks of :data:`CHUNK` entries whose partials are summed
in chunk order. Every output is summed in one fixed order: two launches
give the same bits.

The kernel is compiled by ``ops/kernel_build.py`` (``nvcc``, ``sm_90a``)
at first use into ``build/dlps_torch/``; a build, load or launch failure
raises :class:`~distributedlpsolver_tpu_torch.ops.kernel_build.KernelError`.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import NamedTuple, Optional

import torch

from distributedlpsolver_tpu_torch.ops import kernel_build
from distributedlpsolver_tpu_torch.ops.kernel_build import BUILD_DIR, KernelError

_SOURCE = os.path.join(kernel_build.CSRC, "ell_spmv.cu")
_STEM = "libdlps_ell_spmv"
_ENTRY = {torch.float64: "dlps_ell_spmv_f64", torch.float32: "dlps_ell_spmv_f32"}

# The layout's choices (the kernel reads every offset from the index, so
# these are the builder's alone). A slice is one warp's 32 rows, one
# thread a row; a row with more live entries than HEAVY_MIN is heavy, and
# a warp sums CHUNK of its entries (32 a lane). Rows are sorted by their
# live count within windows of WINDOW rows (σ), which keeps the slices'
# pads to ~1–2% of the entries at stormG2_1000's and netlib's profiles
# while every write stays within a 32 KB window of the output.
SLICE = 32
HEAVY_MIN = 32
CHUNK = 1024
WINDOW = 4096

_lib = None
_lib_lock = threading.Lock()
build_info: dict = {}
_nvcc = kernel_build.find_nvcc


class EllTail(NamedTuple):
    """The COO spill of the rows wider than the ELL width, in CSR row
    order: ``vals``/``rows``/``cols`` (t,) with pad entries at row m and
    value 0 (the JAX package's layout, read by the plain version)."""

    vals: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor


class SellLayout(NamedTuple):
    """The kernel's layout of one matrix (or its transpose), from
    :func:`sell_layout`.

    ``vals``/``cols`` (E,): the slices, each stored slot-major (slot j of
    lane r at ``slice_ptr[s] + 32·j + r``; pads value 0, column 0), then the
    heavy rows' entries in CSR order. ``index`` (int32) packs
    ``slice_ptr`` (n_slices + 1), ``perm`` (32·n_slices: each lane's output
    row, -1 for a pad lane), ``chunk_ptr`` (n_chunks + 1 entry offsets),
    ``chunk_row`` (n_chunks: the heavy row of each chunk), ``heavy_rows``
    (n_heavy: their output rows) and ``heavy_first`` (n_heavy + 1: each
    heavy row's first chunk). ``partials`` (n_chunks) and ``counters``
    (n_heavy, zero between launches) are the kernel's scratch, so the
    launches on one layout must run in stream order. Every tensor lies
    contiguous on one device (the wrapper checks ``vals``' device)."""

    vals: torch.Tensor
    cols: torch.Tensor
    index: torch.Tensor
    partials: torch.Tensor
    counters: torch.Tensor
    rows: int
    n_slices: int
    n_chunks: int
    n_heavy: int

    def _part(self, start, length):
        return self.index[start:start + length]

    @property
    def slice_ptr(self):
        return self._part(0, self.n_slices + 1)

    @property
    def perm(self):
        return self._part(self.n_slices + 1, SLICE * self.n_slices)

    @property
    def chunk_ptr(self):
        return self._part((SLICE + 1) * self.n_slices + 1, self.n_chunks + 1)

    @property
    def chunk_row(self):
        return self._part((SLICE + 1) * self.n_slices + self.n_chunks + 2, self.n_chunks)

    @property
    def heavy_rows(self):
        return self._part((SLICE + 1) * self.n_slices + 2 * self.n_chunks + 2, self.n_heavy)

    @property
    def heavy_first(self):
        return self._part((SLICE + 1) * self.n_slices + 2 * self.n_chunks + self.n_heavy + 2,
                          self.n_heavy + 1)

    def tensors(self) -> dict:
        return {f: getattr(self, f) for f in ("vals", "cols", "index", "partials", "counters")}


def sell_layout(indptr, indices, data, *, dtype, device) -> SellLayout:
    """The kernel's layout of the CSR matrix (``indptr``, ``indices``,
    ``data``; numpy arrays or tensors), built with torch on ``device``.
    Entries keep their CSR order within a row."""
    dev = torch.device(device)
    as_t = lambda a, dt: torch.as_tensor(a).to(device=dev, dtype=dt)  # noqa: E731
    indptr = as_t(indptr, torch.int64)
    indices = as_t(indices, torch.int32)
    data = as_t(data, dtype)
    m = indptr.numel() - 1
    counts = indptr[1:] - indptr[:-1]
    heavy = torch.nonzero(counts > HEAVY_MIN).flatten()
    light = torch.nonzero(counts <= HEAVY_MIN).flatten()

    # Light rows: by live count, widest first, within windows of WINDOW
    # rows (a stable sort keeps equal counts in row order).
    n_light = light.numel()
    cl = counts[light]
    key = (torch.arange(n_light, device=dev) // WINDOW) * (HEAVY_MIN + 1) + (HEAVY_MIN - cl)
    order = light[torch.sort(key, stable=True).indices]
    n_slices = -(-n_light // SLICE)
    lens = torch.zeros(n_slices * SLICE, dtype=torch.int64, device=dev)
    lens[:n_light] = counts[order]
    width = lens.view(n_slices, SLICE).amax(dim=1)
    slice_ptr = torch.zeros(n_slices + 1, dtype=torch.int64, device=dev)
    slice_ptr[1:] = torch.cumsum(width * SLICE, 0)
    perm = torch.full((n_slices * SLICE,), -1, dtype=torch.int64, device=dev)
    perm[:n_light] = order

    # Heavy rows, in row order, then cut into chunks.
    hl = counts[heavy]
    n_heavy = heavy.numel()
    n_ch = -(-hl // CHUNK)
    heavy_first = torch.zeros(n_heavy + 1, dtype=torch.int64, device=dev)
    heavy_first[1:] = torch.cumsum(n_ch, 0)
    n_chunks = int(heavy_first[-1])
    e_light = int(slice_ptr[-1])
    hbase = torch.zeros(n_heavy + 1, dtype=torch.int64, device=dev)
    hbase[1:] = torch.cumsum(hl, 0)
    hbase += e_light
    chunk_row = torch.repeat_interleave(torch.arange(n_heavy, device=dev), n_ch)
    chunk_ptr = torch.empty(n_chunks + 1, dtype=torch.int64, device=dev)
    chunk_ptr[:-1] = hbase[chunk_row] + (
        torch.arange(n_chunks, device=dev) - heavy_first[chunk_row]) * CHUNK
    chunk_ptr[-1] = hbase[-1]
    total = int(hbase[-1])
    if total >= 2**31 or m >= 2**31:
        raise ValueError(f"sell_layout: {total} entries / {m} rows exceed the kernel's int32 offsets")

    vals = torch.zeros(total, dtype=dtype, device=dev)
    cols = torch.zeros(total, dtype=torch.int32, device=dev)
    # Light entries: entry j of the row at sorted position q goes to slot j
    # of lane q % 32 of slice q // 32.
    q, j = _entries(lens[:n_light])
    src = indptr[order][q] + j
    dst = slice_ptr[q // SLICE] + j * SLICE + q % SLICE
    vals[dst] = data[src]
    cols[dst] = indices[src]
    # Heavy entries, row after row in CSR order.
    h, j = _entries(hl)
    src = indptr[heavy][h] + j
    vals[hbase[h] + j] = data[src]
    cols[hbase[h] + j] = indices[src]

    index = torch.cat([slice_ptr, perm, chunk_ptr, chunk_row, heavy, heavy_first]).to(torch.int32)
    return SellLayout(vals, cols, index, torch.zeros(n_chunks, dtype=dtype, device=dev),
                      torch.zeros(n_heavy, dtype=torch.int32, device=dev), m, n_slices,
                      n_chunks, n_heavy)


def _entries(lens):
    """(owner, position) of every entry of consecutive runs of ``lens``."""
    owner = torch.repeat_interleave(torch.arange(lens.numel(), device=lens.device), lens)
    starts = torch.cumsum(lens, 0) - lens
    return owner, torch.arange(owner.numel(), device=lens.device) - starts[owner]


def sell_entry_rows(layout: SellLayout) -> torch.Tensor:
    """The row of every entry of ``layout`` (int64 (E,); -1 for the slots of
    a pad lane)."""
    dev = layout.vals.device
    width = (layout.slice_ptr[1:] - layout.slice_ptr[:-1]).long() // SLICE
    s, j = _entries(width * SLICE)
    lane_row = layout.perm.long()[s * SLICE + j % SLICE]
    c = torch.repeat_interleave(torch.arange(layout.n_chunks, device=dev),
                                (layout.chunk_ptr[1:] - layout.chunk_ptr[:-1]).long())
    heavy_row = layout.heavy_rows.long()[layout.chunk_row.long()[c]]
    return torch.cat([lane_row, heavy_row])


def build_job():
    """This kernel's entry for :func:`kernel_build.build`."""
    return (_SOURCE, _STEM, BUILD_DIR, _nvcc, build_info)


def load_library():
    """Build (once per source version) and load the kernel library; a
    failure raises :class:`KernelError`."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = kernel_build.open_library(kernel_build.build(build_job())[0])
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            # (vals, cols, index, n_slices, n_chunks, n_heavy, partials,
            #  counters, v, reg, square, out, stream)
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def ell_spmv_reference(vals, cols, v, tail: Optional[EllTail] = None, *, square=False, reg=0.0):
    """The plain version: the JAX package's eager formula — the ELL
    gather-reduce, then the tail scattered in through a synthetic pad
    slot (``index_add_``). ``square`` squares the stored values (the
    normal diagonal) and adds ``reg``."""
    a = vals * vals if square else vals
    out = (a * v[cols]).sum(dim=1)
    if tail is not None:
        t = tail.vals * tail.vals if square else tail.vals
        acc = torch.cat([out, out.new_zeros(1)])
        acc.index_add_(0, tail.rows, t * v[tail.cols])
        out = acc[:-1]
    return out + reg if square else out


def _launch(layout: SellLayout, v, square, reg, transpose):
    vals = layout.vals
    if vals.dtype not in _ENTRY:
        raise TypeError(f"ell_spmv: no kernel for {vals.dtype}")
    if v.dtype != vals.dtype or v.dim() != 1:
        raise TypeError(f"ell_spmv: v must be 1-D {vals.dtype}")
    if vals.device != v.device or not v.is_contiguous():
        raise ValueError(f"ell_spmv: v must be contiguous on the layout's {vals.device}")
    out = torch.empty(layout.rows, dtype=vals.dtype, device=v.device)
    if layout.rows == 0:
        return out
    fn = getattr(load_library(), _ENTRY[vals.dtype])
    with torch.cuda.device(v.device):
        rc = fn(vals.data_ptr(), layout.cols.data_ptr(), layout.index.data_ptr(),
                layout.n_slices, layout.n_chunks, layout.n_heavy, layout.partials.data_ptr(),
                layout.counters.data_ptr(), v.data_ptr(), float(reg), int(square),
                out.data_ptr(), torch.cuda.current_stream(v.device).cuda_stream)
    if rc != 0:
        raise KernelError(f"ell_spmv kernel launch failed: CUDA error {rc} (rows={layout.rows}, "
                          f"slices={layout.n_slices}, chunks={layout.n_chunks})")
    if square:
        kernel_build.count_launch(ell_normal_diag)
    else:
        kernel_build.count_launch(ell_spmv, attr="launches_t" if transpose else "launches")
    return out


def _call(vals, cols, v, tail, layout, square, reg, transpose=False):
    if vals.device != v.device:
        raise ValueError(f"ell_spmv: vals on {vals.device}, v on {v.device}")
    if v.device.type == "cpu":
        return ell_spmv_reference(vals, cols, v, tail, square=square, reg=reg)
    if v.device.type != "cuda":
        raise ValueError(f"ell_spmv: no kernel for device {v.device}")
    if layout is None:
        raise ValueError("ell_spmv: the kernel needs the matrix's SellLayout (sell_layout)")
    return _launch(layout, v, square, reg, transpose)


def ell_spmv(vals, cols, v, tail: Optional[EllTail] = None, *, layout: Optional[SellLayout] = None,
             transpose: bool = False):
    """``Σ_e val[e]·v[col[e]]`` over row i's entries, for every row i: the
    CUDA kernel on ``layout`` for CUDA tensors, the plain version on the
    hybrid (``vals``, ``cols``, ``tail``) for CPU tensors. ``transpose``
    marks a call on an operator's transpose (Aᵀ·v): it changes nothing but
    the counter a launch adds to."""
    return _call(vals, cols, v, tail, layout, False, 0.0, transpose)


def ell_normal_diag(vals, cols, d, tail: Optional[EllTail] = None, reg=0.0, *,
                    layout: Optional[SellLayout] = None):
    """``Σ_e val[e]²·d[col[e]]`` over row i's entries + ``reg``: the
    diagonal of A·diag(d)·Aᵀ for the rows of A (kernel on ``layout`` on a
    card, plain version on the CPU)."""
    return _call(vals, cols, d, tail, layout, True, reg)


# Launches of the CUDA kernel since the last reset, per function and
# direction (``launches_t``: Aᵀ·v; the CPU path never counts): a run sets
# them to 0 and reads them to show the kernel ran.
ell_spmv.launches = 0
ell_spmv.launches_t = 0
ell_normal_diag.launches = 0
