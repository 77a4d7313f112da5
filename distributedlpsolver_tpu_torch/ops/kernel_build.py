"""Building and loading the hand-written CUDA kernels of ``csrc/``.

Each kernel source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at its first use, from the sources in
this checkout, into ``build/dlps_torch/`` at the root of the checkout
(the file name carries a hash of the source and the flags, so an edited
source builds anew), and loaded with ``ctypes``.

:func:`build` starts one ``nvcc`` per missing source, all at once, and
waits for them together (a run that needs every kernel pays the slowest
build, not the sum). :class:`KernelError` is the one exception type of a
kernel that cannot be built, loaded or launched; the supervisor lets it
propagate instead of degrading the solve onto another backend.

Launch counts: a kernel wrapper counts each launch with
:func:`count_launch`, into its process-wide ``launches`` attribute (what a
run resets and reads) and into the calling thread's own count
(:func:`thread_launches`), which attributes launches to the work of one
thread when several threads launch kernels at once (two services in one
process, a solo solve beside a bucket dispatch).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "dlps_torch",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


_COUNT_LOCK = threading.Lock()
_THREAD = threading.local()


def count_launch(fn, n: int = 1, attr: str = "launches") -> None:
    """Add ``n`` launches of the kernel wrapper ``fn`` to its process-wide
    count ``fn.<attr>`` and to this thread's count (a negative ``n`` takes
    back counts that launched nothing, as a CUDA-graph capture's)."""
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + n)
    counts = _THREAD.__dict__.setdefault("counts", {})
    counts[(fn, attr)] = counts.get((fn, attr), 0) + n


def thread_launches(fn, attr: str = "launches") -> int:
    """Launches of ``fn`` counted by this thread since it started."""
    return _THREAD.__dict__.get("counts", {}).get((fn, attr), 0)


def thread_counts() -> dict:
    """A copy of every count of this thread, keyed by ``(fn, attr)``."""
    return dict(_THREAD.__dict__.get("counts", {}))


class KernelError(RuntimeError):
    """A hand-written CUDA kernel could not be built, loaded or launched.

    Not a numerical fault of the solve: retrying on another backend would
    hide it, so the supervisor re-raises it."""


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise KernelError("nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
                          "kernels of distributedlpsolver_tpu_torch/csrc cannot be built")
    return found


def library_path(source: str, stem: str, build_dir: str) -> str:
    with open(source, "rb") as fh:
        tag = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(build_dir, f"{stem}_{tag}.so")


def build(*jobs) -> list:
    """The built libraries of ``jobs`` — ``(source, stem, build_dir,
    nvcc_fn, info)`` tuples — building each missing one with its own
    ``nvcc``, all started together and all waited for. ``info`` gets the
    library's path and, when it was built, the build's seconds and nvcc's
    register lines. Every failure is joined into one :class:`KernelError`."""
    started, errors = [], []
    for source, stem, build_dir, nvcc_fn, info in jobs:
        so = info["path"] = library_path(source, stem, build_dir)
        if os.path.exists(so):
            continue
        try:
            nvcc = nvcc_fn()
        except Exception as e:  # noqa: BLE001 - any failure to find nvcc fails the kernel's build
            errors.append(str(e) if isinstance(e, KernelError) else f"cannot build {source}: {e}")
            continue
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, source],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        started.append((proc, tmp, time.perf_counter(), source, so, info))
    for proc, tmp, t0, source, so, info in started:
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed to build {source} (exit {proc.returncode}):\n{out}\n{err}")
            continue
        os.replace(tmp, so)
        info["seconds"] = time.perf_counter() - t0
        info["ptxas"] = [
            ln.strip() for ln in (out + err).splitlines()
            if any(w in ln for w in ("Compiling entry", "registers", "spill"))
        ]
    if errors:
        raise KernelError("\n".join(errors))
    return [job[4]["path"] for job in jobs]


def open_library(so: str) -> ctypes.CDLL:
    try:
        return ctypes.CDLL(so)
    except OSError as e:
        raise KernelError(f"cannot load {so}: {e}") from e
