"""Build + load the native CPU kernels (g++ → .so, consumed via ctypes).

The port of the JAX package's ``native/build.py``, over this package's own
copy of ``kernels.cpp``. The library is compiled with ``g++`` at its first
use, with the reference's flags, into ``build/dlps_torch/`` at the root of
the checkout, under a name tagged with a hash of the source, the flags
and the host CPU (``-march=native`` code must not run on another CPU), and
loaded with typed ctypes signatures (process-cached). A missing or failing
``g++`` raises :class:`NativeBuildError`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "kernels.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "dlps_torch")
FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fopenmp", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    pass


def _host_cpu() -> str:
    """The CPU's model and feature flags (what ``-march=native`` reads)."""
    try:
        with open("/proc/cpuinfo") as fh:
            lines = [ln for ln in fh if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return platform.processor() or platform.machine()


def build(force: bool = False) -> str:
    """Compile kernels.cpp if this source, flag set and CPU have no
    library yet; returns the .so path."""
    with _lock:
        with open(_SRC, "rb") as fh:
            key = fh.read() + " ".join(FLAGS).encode() + _host_cpu().encode()
        so = os.path.join(BUILD_DIR, f"libdlps_kernels_{hashlib.sha256(key).hexdigest()[:12]}.so")
        if not force and os.path.exists(so):
            return so
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", *FLAGS, _SRC, "-o", tmp], check=True,
                           capture_output=True, text=True)
        except FileNotFoundError as e:
            raise NativeBuildError(f"g++ not available: {e}") from e
        except subprocess.CalledProcessError as e:
            raise NativeBuildError(f"native build failed:\n{e.stderr}") from e
        os.replace(tmp, so)
        return so


def load() -> ctypes.CDLL:
    """Build if needed and load with typed signatures (process-cached)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    dp = ctypes.POINTER(ctypes.c_double)
    lib.dlps_normal_eq.argtypes = [dp, dp, ctypes.c_int, ctypes.c_int, ctypes.c_double, dp, dp]
    lib.dlps_normal_eq.restype = None
    lib.dlps_cholesky.argtypes = [dp, ctypes.c_int]
    lib.dlps_cholesky.restype = ctypes.c_int
    lib.dlps_cho_solve.argtypes = [dp, dp, ctypes.c_int, dp]
    lib.dlps_cho_solve.restype = None
    lib.dlps_num_threads.argtypes = []
    lib.dlps_num_threads.restype = ctypes.c_int
    _lib = lib
    return lib
