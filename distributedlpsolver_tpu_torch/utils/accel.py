"""Accelerator-presence guard for measurement envelopes.

The counterpart of the JAX package's ``utils/accel.py::require_tpu``: a
measurement run that silently lands on the host produces unquotable
numbers, so a script that must measure the card calls
:func:`require_cuda` first and stops with a distinct exit code instead.
"""

from __future__ import annotations

import sys

REQUIRE_CUDA_EXIT = 4  # distinct from solve-failure (2/3) exit codes


def require_cuda(enabled: bool = True) -> None:
    """Hard-fail (``SystemExit`` with code :data:`REQUIRE_CUDA_EXIT`)
    unless a CUDA card is present. With ``enabled=False`` this is a
    no-op, so callers can write ``require_cuda("--require-cuda" in
    sys.argv)``."""
    if not enabled:
        return
    import torch

    try:
        ok = torch.cuda.is_available() and torch.cuda.device_count() > 0
    except RuntimeError as e:
        print(f"--require-cuda: CUDA initialization failed ({e}); refusing to "
              "run on the CPU", file=sys.stderr)
        raise SystemExit(REQUIRE_CUDA_EXIT)
    if not ok:
        print("--require-cuda: no CUDA device is available — aborting before any "
              "figure is produced", file=sys.stderr)
        raise SystemExit(REQUIRE_CUDA_EXIT)


# The health probes and the ONE simulated-loss registry live in
# ``parallel/runtime.py`` (the JAX package's home for them); the network
# plane's health endpoints and chaos probes reach them from here.
from distributedlpsolver_tpu_torch.parallel.runtime import (  # noqa: E402,F401
    probe_device,
    probe_devices,
    restore_devices,
    simulate_device_loss,
    simulated_lost_devices,
)
