"""Hybrid-ELL sparse products — the hand-written CUDA kernel for the H100
and its plain PyTorch version.

The kernel (``csrc/ell_spmv.cu``) replaces the device routines the JAX
package's ``ops/sparse.py::SparseOperator`` leaves to XLA: ``matvec`` and
``rmatvec`` (a row-ELL gather-reduce plus a COO-tail scatter-add) and
``normal_diag`` (``diag(A·diag(d)·Aᵀ)`` without the matrix). Two
functions over one hybrid row-ELL matrix (``vals``/``cols`` (m, k) and
the tail of rows wider than k, :class:`EllTail`):

* :func:`ell_spmv` — ``out[i] = Σ_k vals[i,k]·v[cols[i,k]]`` + the tail
  of row i;
* :func:`ell_normal_diag` — ``out[i] = Σ_k vals[i,k]²·d[cols[i,k]]`` + the
  tail's squares times d, + ``reg``.

Each launches the kernel for CUDA tensors (or raises) and uses its plain
version for CPU tensors: the JAX package's eager formula, ELL sum then an
``index_add_`` of the tail — which on a card adds with atomics, so the
card path never takes it. The kernel instead sums each row's tail in a
fixed order from the row pointers :func:`tail_index` builds at setup
(heavy rows, whose tail is longer than :data:`HEAVY_TAIL`, get a thread
block each): two launches give the same bits. Both run through the
operators ``dlps::ell_spmv`` (``torch.library``; CPU and CUDA).

The kernel is compiled by ``ops/kernel_build.py`` (``nvcc``, ``sm_90a``)
at first use into ``build/dlps_torch/``; a build, load or launch failure
raises :class:`~distributedlpsolver_tpu_torch.ops.kernel_build.KernelError`.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from distributedlpsolver_tpu_torch.ops import kernel_build
from distributedlpsolver_tpu_torch.ops.kernel_build import BUILD_DIR, KernelError

_SOURCE = os.path.join(kernel_build.CSRC, "ell_spmv.cu")
_STEM = "libdlps_ell_spmv"
_ENTRY = {torch.float64: "dlps_ell_spmv_f64", torch.float32: "dlps_ell_spmv_f32"}

# A row whose tail holds more entries than this gets a thread block of its
# own; lighter rows are summed by a group of lanes with their ELL slots.
HEAVY_TAIL = 256

_lib = None
_lib_lock = threading.Lock()
build_info: dict = {}
_nvcc = kernel_build.find_nvcc


class EllTail(NamedTuple):
    """The COO spill of the rows wider than the ELL width, in CSR row
    order: ``vals``/``rows``/``cols`` (t,) with pad entries at row m and
    value 0 (the JAX package's layout, read by the plain version), and the
    kernel's index over it, ``ptr`` (m + 1,) row pointers of the live
    entries and ``heavy`` the rows with more than :data:`HEAVY_TAIL` of
    them (both int32, from :func:`tail_index`)."""

    vals: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    ptr: torch.Tensor
    heavy: torch.Tensor


def tail_index(tail_rows: np.ndarray, m: int):
    """Row pointers ``(m + 1,)`` and heavy rows of a tail whose live
    entries are sorted by row (pad entries at row m, at the end)."""
    ptr = np.searchsorted(tail_rows, np.arange(m + 1), side="left").astype(np.int32)
    heavy = np.flatnonzero(np.diff(ptr) > HEAVY_TAIL).astype(np.int32)
    return ptr, heavy


def build_job():
    """This kernel's entry for :func:`kernel_build.build`."""
    return (_SOURCE, _STEM, BUILD_DIR, _nvcc, build_info)


def load_library():
    """Build (once per source version) and load the kernel library; a
    failure raises :class:`KernelError`."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = kernel_build.open_library(kernel_build.build(build_job())[0])
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            # (vals, cols, m, k, tail_ptr, tail_vals, tail_cols, heavy,
            #  n_heavy, heavy_min, v, reg, square, group, out, stream)
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_double,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
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


def _group(k: int) -> int:
    """Lanes a light row gets: the ELL width rounded up to a power of two,
    at most a warp."""
    g = 1
    while g < min(k, 32):
        g *= 2
    return g


def _launch(vals, cols, v, tail, square, reg, transpose):
    if vals.dtype not in _ENTRY:
        raise TypeError(f"ell_spmv: no kernel for {vals.dtype}")
    m, k = vals.shape
    for name, t in (("vals", vals), ("cols", cols), ("v", v)):
        if t.device != vals.device or not t.is_contiguous():
            raise ValueError(f"ell_spmv: {name} must be contiguous on {vals.device}")
    if cols.dtype != torch.int32 or cols.shape != vals.shape or v.dtype != vals.dtype:
        raise TypeError("ell_spmv: cols must be int32 (m, k) and v of vals' dtype")
    out = torch.empty(m, dtype=vals.dtype, device=vals.device)
    if m == 0:
        return out
    ptrs = (0, 0, 0, 0)
    n_heavy = 0
    if tail is not None:
        for name in ("vals", "cols", "ptr", "heavy"):
            t = getattr(tail, name)
            if t.device != vals.device or not t.is_contiguous():
                raise ValueError(f"ell_spmv: tail.{name} must be contiguous on {vals.device}")
        if tail.ptr.shape != (m + 1,) or tail.ptr.dtype != torch.int32:
            raise ValueError("ell_spmv: tail.ptr must be int32 (m + 1,)")
        ptrs = (tail.ptr.data_ptr(), tail.vals.data_ptr(), tail.cols.data_ptr(),
                tail.heavy.data_ptr())
        n_heavy = int(tail.heavy.numel())
    fn = getattr(load_library(), _ENTRY[vals.dtype])
    with torch.cuda.device(vals.device):
        rc = fn(vals.data_ptr(), cols.data_ptr(), m, k, *ptrs, n_heavy, HEAVY_TAIL,
                v.data_ptr(), float(reg), int(square), _group(k), out.data_ptr(),
                torch.cuda.current_stream(vals.device).cuda_stream)
    if rc != 0:
        raise KernelError(f"ell_spmv kernel launch failed: CUDA error {rc} (m={m}, k={k})")
    if square:
        ell_normal_diag.launches += 1
    elif transpose:
        ell_spmv.launches_t += 1
    else:
        ell_spmv.launches += 1
    return out


# The operator ``dlps::ell_spmv`` behind both functions (a plain
# ``torch.library.Library`` fragment of the namespace ``ops/normal_eq.py``
# defines; see the note there on ``custom_op``'s import cost).
_LIB = torch.library.Library("dlps", "FRAGMENT")
_LIB.define(
    "ell_spmv(Tensor vals, Tensor cols, Tensor v, Tensor? tail_vals, Tensor? tail_rows, "
    "Tensor? tail_cols, Tensor? tail_ptr, Tensor? heavy, bool square, float reg, bool transpose) -> Tensor"
)


def _ell_impl(vals, cols, v, tail_vals, tail_rows, tail_cols, tail_ptr, heavy, square, reg,
              transpose):
    tail = None if tail_vals is None else EllTail(tail_vals, tail_rows, tail_cols, tail_ptr, heavy)
    if vals.device.type == "cpu":
        return ell_spmv_reference(vals, cols, v, tail, square=square, reg=reg)
    return _launch(vals, cols, v, tail, square, reg, transpose)


_LIB.impl("ell_spmv", _ell_impl, "CPU")
_LIB.impl("ell_spmv", _ell_impl, "CUDA")
_ell_op = torch.ops.dlps.ell_spmv


@torch.library.register_fake("dlps::ell_spmv", lib=_LIB)
def _(vals, cols, v, tail_vals, tail_rows, tail_cols, tail_ptr, heavy, square, reg, transpose):
    return vals.new_empty(vals.shape[:1])


def _call(vals, cols, v, tail, square, reg, transpose=False):
    if vals.device != v.device:
        raise ValueError(f"ell_spmv: vals on {vals.device}, v on {v.device}")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ell_spmv: no kernel for device {vals.device}")
    t = (None,) * 5 if tail is None else tuple(tail)
    return _ell_op(vals, cols, v, *t, square, float(reg), transpose)


def ell_spmv(vals, cols, v, tail: Optional[EllTail] = None, *, transpose: bool = False):
    """``Σ_k vals[i,k]·v[cols[i,k]]`` + row i's tail, for every row i: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    ``transpose`` marks a call on an operator's transpose arrays (Aᵀ·v):
    it changes nothing but the counter a launch adds to."""
    return _call(vals, cols, v, tail, False, 0.0, transpose)


def ell_normal_diag(vals, cols, d, tail: Optional[EllTail] = None, reg=0.0):
    """``Σ_k vals[i,k]²·d[cols[i,k]]`` + row i's tail squares times d +
    ``reg``: the diagonal of A·diag(d)·Aᵀ for the rows of A (kernel on a
    card, plain version on the CPU)."""
    return _call(vals, cols, d, tail, True, reg)


# Launches of the CUDA kernel since the last reset, per function and
# direction (``launches_t``: Aᵀ·v; the CPU path never counts): a run sets
# them to 0 and reads them to show the kernel ran.
ell_spmv.launches = 0
ell_spmv.launches_t = 0
ell_normal_diag.launches = 0
