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
  Where the triangle's tiles cannot fill the card and the reduction is
  long (the block tier's linking rows), a launch splits the k range over
  :func:`split_count` blocks a tile into a workspace, and a second kernel
  adds the partials in split order: the same bits from run to run.
* f32 runs on the TF32 tensor cores with 3×TF32 products (each operand
  split into a TF32 head and tail; one TF32 pass would be ~1e-3 off) and
  a blocked sum (each 8-column k step summed in fresh fragments, then in
  f32 round to nearest, folded into f64 every 512 columns, rounded to f32
  once). bf16→f32 uses CUDA-core FMAs on the same lower-triangle grid.

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
import functools
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

# Blocks an SM holds of the f64 kernel (dmma::MIN_BLOCKS in normal_eq.cu)
# and its output tile edge (dmma::BM); load_library checks both against
# the built library.
F64_BLOCKS_PER_SM = 2
F64_TILE = 64
# Fewest columns a split takes: a shorter reduction is never split.
SPLIT_MIN_COLUMNS = 2048
# Of the split counts whose waves cost within this factor of the best,
# the smallest is taken (each split adds a partial tile to write and sum).
SPLIT_SLACK = 1.05

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
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            # (A, d, M, lanes, m, n, A's lane stride, d's lane stride,
            # [f64: splits, workspace,] stream)
            split_args = [i64, p] if name == "dlps_normal_eq_f64" else []
            fn.argtypes = [p, p, p, i64, i64, i64, i64, i64, *split_args, p]
            fn.restype = ctypes.c_int
        # (workspace, M, lanes, m, splits, stream)
        lib.dlps_normal_eq_f64_split_sum.argtypes = [p, p, i64, i64, i64, p]
        lib.dlps_normal_eq_f64_split_sum.restype = ctypes.c_int
        for name in ("dlps_normal_eq_tile", "dlps_normal_eq_min_blocks"):
            getattr(lib, name).argtypes = [ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_int
        # split_count plans with these two constants without the library.
        built = (lib.dlps_normal_eq_tile(0), lib.dlps_normal_eq_min_blocks(0))
        if built != (F64_TILE, F64_BLOCKS_PER_SM):
            raise KernelError(f"normal_eq: the f64 kernel's (tile, blocks an SM) {built} are not "
                              f"split_count's ({F64_TILE}, {F64_BLOCKS_PER_SM})")
        _lib = lib
        return lib


def tile_edge(dtype) -> int:
    """Output tile edge of the kernel instance for input ``dtype``: a
    launch computes T·(T+1)/2 tiles of edge² entries, T = ceil(m/edge)."""
    order = [a for a, _ in _ENTRY]
    return int(load_library().dlps_normal_eq_tile(order.index(dtype)))


def split_count(m: int, n: int, lanes: int, sms: int) -> int:
    """Splits of the reduction over k for an f64 launch of ``lanes`` lanes
    of an (m, n) A on a card of ``sms`` SMs (1: no split).

    A launch is B = lanes·T·(T+1)/2 blocks (T = ceil(m/64)) a split,
    on ``sms``·F64_BLOCKS_PER_SM block slots; with S splits it runs
    ceil(B·S/slots) waves of n/S columns each, so its time goes as
    ceil(B·S/slots)/S. Each split takes at least SPLIT_MIN_COLUMNS
    columns; of the S within SPLIT_SLACK of the least cost, the smallest."""
    tiles = -(-m // F64_TILE)
    blocks = lanes * tiles * (tiles + 1) // 2
    slots = sms * F64_BLOCKS_PER_SM
    most = max(1, n // SPLIT_MIN_COLUMNS)
    cost = [-(-blocks * s // slots) / s for s in range(1, most + 1)]
    best = min(cost)
    return next(s for s, c in enumerate(cost, 1) if c <= best * SPLIT_SLACK)


def workspace_numel(m: int, lanes: int, splits: int) -> int:
    """Doubles of an f64 launch's split workspace: a partial 64×64 tile
    for each lane, split and lower-triangle tile (0 for one split)."""
    if splits == 1:
        return 0
    tiles = -(-m // F64_TILE)
    return lanes * splits * tiles * (tiles + 1) // 2 * F64_TILE * F64_TILE


@functools.lru_cache(maxsize=None)
def _sm_count_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of the card ``device`` (read once)."""
    device = torch.device(device)
    return _sm_count_of(device.index if device.index is not None else torch.cuda.current_device())


def splits_on(A: torch.Tensor) -> int:
    """The split count an f64 launch on the card gives ``A`` ((m, n) or
    (B, m, n)); 1 for every other type."""
    if A.dtype != torch.float64:
        return 1
    lanes = A.shape[0] if A.dim() == 3 else 1
    return split_count(A.shape[-2], A.shape[-1], lanes, sm_count(A.device))


def _tile_index(tiles: int) -> tuple:
    """(bi, bj) of each block of the lower triangle of tiles×tiles, in the
    kernel's block order (normal_eq.cu::tile_of_block): groups of 8 block
    rows, column by column inside a group."""
    bi, bj = [], []
    for r0 in range(0, tiles, 8):
        h = min(tiles, r0 + 8) - r0
        for c in range(r0):
            bi += range(r0, r0 + h)
            bj += [c] * h
        for c in range(h):
            bi += range(r0 + c, r0 + h)
            bj += [r0 + c] * (h - c)
    return torch.tensor(bi), torch.tensor(bj)


def split_sum_reference(work: torch.Tensor, m: int, lanes: int, splits: int) -> torch.Tensor:
    """The plain version of the split's second kernel: the partial tiles of
    ``work`` (lanes, splits, tiles, 64, 64) added in split order, placed,
    and the lower triangle mirrored; (lanes, m, m)."""
    edge, tiles = F64_TILE, -(-m // F64_TILE)
    P = work.view(lanes, splits, -1, edge, edge)
    total = P[:, 0].clone()
    for s in range(1, splits):
        total = total + P[:, s]
    bi, bj = _tile_index(tiles)
    full = work.new_zeros(lanes, tiles, tiles, edge, edge)
    full[:, bi, bj] = total
    full = full.permute(0, 1, 3, 2, 4).reshape(lanes, tiles * edge, tiles * edge)[:, :m, :m]
    low = torch.tril(full)
    return low + torch.tril(low, -1).mT


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


def normal_eq_exact(A: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``A·diag(d)·Aᵀ`` of the same inputs taken in f64, (m, m) or
    (B, m, m): the products of f32 inputs are exact there and only the
    f64 sum rounds. The f32 kernel's accuracy is held against it; the
    plain version sums in f32 and can itself lie ~1e-5 from it (one
    cuBLAS f32 product at 4096×20480 with d spread over 8 orders)."""
    Ad = A.double()
    return (Ad * d.double()[..., None, :]) @ Ad.transpose(-1, -2)


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


def _launch(A, d, out_dtype, splits=None):
    """One launch for every lane of A (m, n) or (B, m, n): each lane's
    rows and d must be dense; the lane strides may be anything, 0
    included. In f64 the reduction is split :func:`splits_on` ways, or
    ``splits`` ways where given (a test's handle on the split)."""
    f64 = A.dtype == torch.float64
    if splits is not None and (not f64 or splits < 1):
        raise ValueError(f"normal_eq: {splits} splits; only an f64 launch splits, at least once")
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
    args = [A.data_ptr(), d.data_ptr(), M.data_ptr(), B, m, n,
            A.stride(0) if batched else 0, d.stride(0) if batched else 0]
    with torch.cuda.device(A.device):
        if f64:
            splits = splits or splits_on(A)
            # The workspace comes from torch's allocator on this stream (the
            # graph's pool inside a capture).
            work = (torch.empty(workspace_numel(m, B, splits), dtype=torch.float64,
                                device=A.device) if splits > 1 else None)
            args += [splits, None if work is None else work.data_ptr()]
        rc = fn(*args, torch.cuda.current_stream(A.device).cuda_stream)
    if rc != 0:
        raise KernelError(f"normal_eq kernel launch failed: CUDA error {rc} (B={B}, m={m}, n={n}"
                          + (f", splits={splits})" if f64 else ")"))
    kernel_build.count_launch(normal_eq)
    if batched:
        kernel_build.count_launch(normal_eq, attr="launches_batched")
    if A.dtype == torch.float32:
        kernel_build.count_launch(normal_eq, attr="launches_f32")
    if f64 and splits > 1:
        kernel_build.count_launch(normal_eq, attr="launches_split")
    return M


def split_sum(work: torch.Tensor, m: int, lanes: int, splits: int) -> torch.Tensor:
    """The split's second kernel alone (to time it and hold it against
    :func:`split_sum_reference`): the partial tiles in ``work``, an f64
    CUDA tensor of :func:`workspace_numel` doubles, summed into a new
    (lanes, m, m) M. Not counted: the launches of ``normal_eq`` count it."""
    if work.device.type != "cuda" or work.dtype != torch.float64 or not work.is_contiguous():
        raise ValueError("split_sum: the workspace is a contiguous f64 CUDA tensor")
    if splits < 2 or work.numel() != workspace_numel(m, lanes, splits):
        raise ValueError(f"split_sum: {work.numel()} doubles for {lanes} lanes, m={m}, {splits} splits")
    M = torch.empty(lanes, m, m, dtype=torch.float64, device=work.device)
    with torch.cuda.device(work.device):
        rc = load_library().dlps_normal_eq_f64_split_sum(
            work.data_ptr(), M.data_ptr(), lanes, m, splits,
            torch.cuda.current_stream(work.device).cuda_stream)
    if rc != 0:
        raise KernelError(f"normal_eq split sum launch failed: CUDA error {rc}")
    return M


# Launches of the CUDA kernel since the last reset (the CPU path never
# counts; a batched launch counts once, a split launch once), and of those
# the batched ones (a lane axis), the ones on an f32 A, and the split ones
# (each also launched the split's sum kernel): a run sets them to 0 and
# reads them to show the kernels ran.
normal_eq.launches = 0
normal_eq.launches_batched = 0
normal_eq.launches_f32 = 0
normal_eq.launches_split = 0
