"""Normal-equations assembly ``M = A·diag(d)·Aᵀ`` — the hand-written CUDA
kernel for the H100 and its plain PyTorch version.

The kernel (``csrc/normal_eq.cu``) replaces the JAX package's Pallas TPU
kernel ``ops/normal_eq.py::_ne_kernel``: it never materializes the scaled
m×n matrix ``A·diag(d)`` and accumulates each output tile over an
in-block k loop. It takes unpadded ``A`` (m, n) and ``d`` (n,) and
returns the full (m, m) ``M``; the TPU tiling artefacts
(``pad_for_pallas``, ``out_m``) have no counterpart here.

What bounds it and what the design does about it (the source note in
``normal_eq.cu`` has the details):

* M is symmetric, so only the tiles of its lower triangle are computed,
  each stored with its mirror image; ``M`` equals ``M.T`` bit for bit,
  and two launches on the same inputs give the same bits.
* f64, the main path's type, runs on the FP64 tensor cores (``mma.sync``
  m16n8k8 f64), fed by a ``cp.async`` ring of k-chunks in shared memory;
  A·d is rounded in f64 and scaled on the chip as fragments are loaded.
* f32 (true fp32, never TF32) and bf16→f32 use CUDA-core FMAs on the
  same lower-triangle grid.

* A leading batch axis (the batched solver's lanes): one launch computes
  every lane, and lane i gives the bits an unbatched launch on lane i's
  inputs gives.

:func:`normal_eq` launches the kernel for a CUDA tensor (or raises), and
uses :func:`normal_eq_reference` for a CPU tensor. There is no fallback
from one to the other. It runs through the operator
``dlps::normal_eq`` (``torch.library``, with a fake implementation),
whose vmap rule turns a ``torch.func.vmap`` over lanes into one batched
launch.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at its first use, from the sources in this
checkout, into ``build/dlps_torch/`` at the root of the checkout, and
loaded with ``ctypes`` (``ops/kernel_build.py``); a build, load or launch
failure raises :class:`~distributedlpsolver_tpu_torch.ops.kernel_build.KernelError`.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from distributedlpsolver_tpu_torch.ops import kernel_build
from distributedlpsolver_tpu_torch.ops.kernel_build import BUILD_DIR, KernelError

_SOURCE = os.path.join(kernel_build.CSRC, "normal_eq.cu")
_STEM = "libdlps_normal_eq"

# (input dtype, output dtype) -> C entry point of csrc/normal_eq.cu
_ENTRY = {
    (torch.float64, torch.float64): "dlps_normal_eq_f64",
    (torch.float32, torch.float32): "dlps_normal_eq_f32",
    (torch.bfloat16, torch.float32): "dlps_normal_eq_bf16_f32",
}

# Lanes one launch takes: they lie on the grid's y axis.
MAX_LANES = 65535

_lib = None
_lib_lock = threading.Lock()
# What the build reported: seconds, and nvcc's -Xptxas -v register and
# shared-memory lines (read by chip_smoke.py).
build_info: dict = {}
_nvcc = kernel_build.find_nvcc


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
            # (A, d, M, lanes, m, n, A's lane stride, d's lane stride, stream)
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        lib.dlps_normal_eq_tile.argtypes = [ctypes.c_int]
        lib.dlps_normal_eq_tile.restype = ctypes.c_int
        _lib = lib
        return lib


def tile_edge(dtype) -> int:
    """Output tile edge of the kernel instance for input ``dtype``: a
    launch computes T·(T+1)/2 tiles of edge² entries, T = ceil(m/edge)."""
    order = [a for a, _ in _ENTRY]
    return int(load_library().dlps_normal_eq_tile(order.index(dtype)))


def normal_eq_reference(A: torch.Tensor, d: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """The plain PyTorch version ``(A * d[..., None, :]) @ Aᵀ``, for one
    (m, n) A with its (n,) d or a batch of B of each, (B, m, n) and (B, n).

    It rounds where the kernel rounds: the scaled product in A's dtype,
    then a product accumulated in A's dtype (f32 for bf16 inputs, which
    is also the default output type there). Its lower triangle is what
    the kernel computes; the kernel mirrors that into the upper half,
    which here rounds A·d on the other operand (in bf16 that moves the
    upper half by the size of the bf16 rounding itself)."""
    acc = torch.float32 if A.dtype == torch.bfloat16 else A.dtype
    M = (A * d[..., None, :]).to(acc) @ A.to(acc).transpose(-1, -2)
    return M.to(out_dtype or acc)


def normal_eq(A: torch.Tensor, d: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """``A·diag(d)·Aᵀ``: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor.

    ``A`` is (m, n) with ``d`` (n,), or a batch, (B, m, n) with (B, n),
    whose lanes (at most :data:`MAX_LANES` on a card) one launch computes
    into a (B, m, m) ``M``; ``d`` is of
    A's dtype; f64, f32 and bf16 are taken. ``M`` is f64 for f64, f32 for
    f32 and bf16; ``out_dtype`` may only name that type. Anything else
    raises. Under ``torch.func.vmap`` a lane's (m, n) call becomes one
    batched launch for all the lanes (the op's vmap rule), never one
    launch a lane."""
    if A.dim() not in (2, 3) or d.dim() != A.dim() - 1 or d.shape != A.shape[:-2] + A.shape[-1:]:
        raise ValueError(
            f"normal_eq: A {tuple(A.shape)} and d {tuple(d.shape)} fit neither (m, n) and (n,) "
            "nor (B, m, n) and (B, n)"
        )
    if d.dtype != A.dtype:
        raise TypeError(f"normal_eq: d is {d.dtype}, A is {A.dtype}; they must match")
    out_dtype = out_dtype or (torch.float32 if A.dtype == torch.bfloat16 else A.dtype)
    if (A.dtype, out_dtype) not in _ENTRY:
        raise TypeError(f"normal_eq: no kernel for {A.dtype} -> {out_dtype}")
    if A.device != d.device:
        raise ValueError(f"normal_eq: A on {A.device}, d on {d.device}")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"normal_eq: no kernel for device {A.device}")
    return _normal_eq_op(A, d, out_dtype)


# The operator ``dlps::normal_eq`` behind :func:`normal_eq`. It is
# defined through ``torch.library.Library`` rather than
# ``torch.library.custom_op``: the latter's first call imports some 800
# modules (torch.distributed.tensor, torch._dynamo, sympy), seconds of a
# cold solve's setup, and the plain library op imports none.
_LIB = torch.library.Library("dlps", "DEF")
_LIB.define("normal_eq(Tensor A, Tensor d, ScalarType out_dtype) -> Tensor")


def _normal_eq_impl(A, d, out_dtype):
    """The op's CPU and CUDA implementation (arguments checked in
    :func:`normal_eq`): the plain version on the CPU, one kernel launch
    on a card."""
    if A.device.type == "cpu":
        return normal_eq_reference(A, d, out_dtype=out_dtype)
    return _launch(A, d, out_dtype)


_LIB.impl("normal_eq", _normal_eq_impl, "CPU")
_LIB.impl("normal_eq", _normal_eq_impl, "CUDA")
_normal_eq_op = torch.ops.dlps.normal_eq


@torch.library.register_fake("dlps::normal_eq", lib=_LIB)
def _(A, d, out_dtype):
    return A.new_empty(A.shape[:-1] + (A.shape[-2],), dtype=out_dtype)


def _normal_eq_vmap(info, in_dims, A, d, out_dtype):
    """vmap rule: the lanes' (m, n) A and (n,) d, stacked on a leading
    axis, go to ONE batched call. An input that is the same for every
    lane is broadcast without a copy (lane stride 0)."""
    a_dim, d_dim = in_dims[0], in_dims[1]
    if A.dim() - (a_dim is not None) != 2 or d.dim() - (d_dim is not None) != 1:
        raise NotImplementedError(
            "normal_eq under vmap takes one (m, n) A and one (n,) d a lane"
        )
    B = info.batch_size
    A = A.movedim(a_dim, 0) if a_dim is not None else A.expand(B, *A.shape)
    d = d.movedim(d_dim, 0) if d_dim is not None else d.expand(B, *d.shape)
    return _normal_eq_op(A, d, out_dtype), 0


torch.library.register_vmap("dlps::normal_eq", _normal_eq_vmap, lib=_LIB)


def _launch(A, d, out_dtype):
    """One launch for every lane of A (m, n) or (B, m, n): each lane's
    rows and d must be dense; the lane strides may be anything, 0
    included."""
    if A.device.type != "cuda":
        raise ValueError(f"normal_eq: no kernel for device {A.device}")
    m, n = A.shape[-2:]
    if (A.stride(-1) != 1 and n > 1) or (A.stride(-2) != n and m > 1) or (d.stride(-1) != 1 and n > 1):
        raise ValueError("normal_eq: each lane of A and d must be contiguous")
    batched = A.dim() == 3
    B = A.shape[0] if batched else 1
    if B > MAX_LANES:
        raise ValueError(f"normal_eq: {B} lanes; one launch takes at most {MAX_LANES} (the grid's y-limit)")
    M = torch.empty(A.shape[:-1] + (m,), dtype=out_dtype, device=A.device)
    if m == 0 or B == 0:
        return M
    fn = getattr(load_library(), _ENTRY[(A.dtype, out_dtype)])
    with torch.cuda.device(A.device):
        rc = fn(
            A.data_ptr(), d.data_ptr(), M.data_ptr(), B, m, n,
            A.stride(0) if batched else 0, d.stride(0) if batched else 0,
            torch.cuda.current_stream(A.device).cuda_stream,
        )
    if rc != 0:
        raise KernelError(f"normal_eq kernel launch failed: CUDA error {rc} (B={B}, m={m}, n={n})")
    kernel_build.count_launch(normal_eq)
    if batched:
        kernel_build.count_launch(normal_eq, attr="launches_batched")
    if A.dtype == torch.float32:
        kernel_build.count_launch(normal_eq, attr="launches_f32")
    return M


# Launches of the CUDA kernel since the last reset (the CPU path never
# counts; a batched launch counts once), and of those the batched ones
# (a lane axis) and the ones on an f32 A: a run sets them to 0 and reads
# them to show the kernel ran.
normal_eq.launches = 0
normal_eq.launches_batched = 0
normal_eq.launches_f32 = 0
