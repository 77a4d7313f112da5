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


def probe_device(device, deadline: float = 2.0) -> bool:
    """Health probe of one device: launch one tiny op on it and
    synchronize, on a side thread, within ``deadline`` seconds. True iff
    the op came back with the right value in time. On a CUDA device this
    touches the card (a wedged or lost card times out or raises); on the
    CPU it checks the host. The counterpart of the JAX package's
    ``parallel/runtime.py::probe_device`` (a ``device_put`` under a
    deadline)."""
    import threading

    import torch

    dev = torch.device(device)
    if str(dev) in _LOST:
        return False
    out: list = []

    def _ping():
        try:
            t = torch.full((1,), 1.0, device=dev) + 1.0
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out.append(float(t.cpu()[0]) == 2.0)
        except Exception:  # a raising probe is an unhealthy device
            out.append(False)

    th = threading.Thread(target=_ping, daemon=True, name="dlps-device-probe")
    th.start()
    th.join(deadline)
    return bool(out) and out[0]


def probe_devices(devices, deadline: float = 2.0):
    """``(healthy, unhealthy)`` lists of ``torch.device`` from
    :func:`probe_device` on each of ``devices``."""
    import torch

    healthy, unhealthy = [], []
    for d in devices:
        d = torch.device(d)
        (healthy if probe_device(d, deadline) else unhealthy).append(d)
    return healthy, unhealthy


# Devices whose probe reports them lost without touching them (fault
# injection for tests and probes: the counterpart of the JAX package's
# ``parallel/runtime.simulate_device_loss``).
_LOST: set = set()


def simulate_device_loss(devices) -> None:
    """Make :func:`probe_device` report each of ``devices`` unhealthy."""
    import torch

    _LOST.update(str(torch.device(d)) for d in devices)


def restore_devices() -> None:
    """Undo :func:`simulate_device_loss`."""
    _LOST.clear()
