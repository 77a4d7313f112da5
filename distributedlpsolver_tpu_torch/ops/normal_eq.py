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

:func:`normal_eq` launches the kernel for a CUDA tensor (or raises), and
uses :func:`normal_eq_reference` for a CPU tensor. There is no fallback
from one to the other.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at its first use, from the sources in this
checkout, into ``build/dlps_torch/`` at the root of the checkout, and
loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SOURCE = os.path.join(_CSRC, "normal_eq.cu")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "dlps_torch",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# (input dtype, output dtype) -> C entry point of csrc/normal_eq.cu
_ENTRY = {
    (torch.float64, torch.float64): "dlps_normal_eq_f64",
    (torch.float32, torch.float32): "dlps_normal_eq_f32",
    (torch.bfloat16, torch.float32): "dlps_normal_eq_bf16_f32",
}

_lib = None
_lib_lock = threading.Lock()
# What the build reported: seconds, and nvcc's -Xptxas -v register and
# shared-memory lines (read by chip_smoke.py).
build_info: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernel of ops/normal_eq.py cannot be built"
        )
    return found


def load_library():
    """Build (once per source version) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        with open(_SOURCE, "rb") as fh:
            tag = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"libdlps_normal_eq_{tag}.so")
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SOURCE],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {_SOURCE} (exit {proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, so)
            build_info["seconds"] = time.perf_counter() - t0
            build_info["ptxas"] = [
                ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
                if any(w in ln for w in ("Compiling entry", "registers", "spill"))
            ]
        build_info["path"] = so
        lib = ctypes.CDLL(so)
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
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
    """The plain PyTorch version ``(A * d[None, :]) @ A.T``.

    It rounds where the kernel rounds: the scaled product in A's dtype,
    then a product accumulated in A's dtype (f32 for bf16 inputs, which
    is also the default output type there). Its lower triangle is what
    the kernel computes; the kernel mirrors that into the upper half,
    which here rounds A·d on the other operand (in bf16 that moves the
    upper half by the size of the bf16 rounding itself)."""
    acc = torch.float32 if A.dtype == torch.bfloat16 else A.dtype
    M = (A * d[None, :]).to(acc) @ A.to(acc).T
    return M.to(out_dtype or acc)


def normal_eq(A: torch.Tensor, d: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """``A·diag(d)·Aᵀ``: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor.

    ``A`` is (m, n) and contiguous, ``d`` is (n,) of A's dtype; f64, f32
    and bf16 are taken. ``M`` is f64 for f64, f32 for f32 and bf16;
    ``out_dtype`` may only name that type. Anything else raises."""
    if A.dim() != 2 or d.dim() != 1 or d.shape[0] != A.shape[1]:
        raise ValueError(f"normal_eq: A {tuple(A.shape)} and d {tuple(d.shape)} do not fit (m, n) and (n,)")
    if d.dtype != A.dtype:
        raise TypeError(f"normal_eq: d is {d.dtype}, A is {A.dtype}; they must match")
    out_dtype = out_dtype or (torch.float32 if A.dtype == torch.bfloat16 else A.dtype)
    if (A.dtype, out_dtype) not in _ENTRY:
        raise TypeError(f"normal_eq: no kernel for {A.dtype} -> {out_dtype}")
    if A.device != d.device:
        raise ValueError(f"normal_eq: A on {A.device}, d on {d.device}")
    if A.device.type == "cpu":
        return normal_eq_reference(A, d, out_dtype=out_dtype)
    if A.device.type != "cuda":
        raise ValueError(f"normal_eq: no kernel for device {A.device}")
    if not (A.is_contiguous() and d.is_contiguous()):
        raise ValueError("normal_eq: A and d must be contiguous")
    m, n = A.shape
    M = torch.empty((m, m), dtype=out_dtype, device=A.device)
    if m == 0:
        return M
    fn = getattr(load_library(), _ENTRY[(A.dtype, out_dtype)])
    with torch.cuda.device(A.device):
        rc = fn(
            A.data_ptr(), d.data_ptr(), M.data_ptr(), m, n,
            torch.cuda.current_stream(A.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"normal_eq kernel launch failed: CUDA error {rc} (m={m}, n={n})")
    normal_eq.launches += 1
    return M


# Launches of the CUDA kernel since the last reset (the CPU path never
# counts): a run sets it to 0 and reads it to show the kernel ran.
normal_eq.launches = 0
