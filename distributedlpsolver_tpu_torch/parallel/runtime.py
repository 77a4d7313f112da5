"""Multi-process runtime: the reference's MPI world, over ``torch.distributed``.

The counterpart of the JAX package's ``parallel/runtime.py``. There,
``jax.distributed.initialize`` joins the processes and ``jax.devices()``
then lists the global device set. Here a world is a ``torch.distributed``
process group of one process per device (``distributed/world.py`` forms
it and picks its backend); this module is the rank/size view of it and
the device each rank runs on. Without a world everything degrades to a
world of one (the ``mpirun -np 1`` analogue).

Not ported yet (ROADMAP Queue 1 item 13b): the simulated device loss and
the per-device probes of the elastic shrink (``simulate_device_loss``,
``restore_devices``, ``probe_devices``). The one-device probe is
``utils/accel.py::probe_device``.
"""

from __future__ import annotations

from typing import Optional

import torch

# The World this process joined (distributed/world.py sets and clears it).
_WORLD = None


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def current_world():
    """The :class:`distributed.world.World` this process joined, or None."""
    return _WORLD


def set_world(world) -> None:
    global _WORLD
    _WORLD = world


def world_device(device=None) -> torch.device:
    """The device this rank runs on: ``device`` when given, else the
    joined world's, else the first card (raising without one: entry
    points run on the card unless the caller asks for the CPU)."""
    from distributedlpsolver_tpu_torch.backends.dense import resolve_device

    if device is None and _WORLD is not None:
        return _WORLD.device
    return resolve_device(device)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> dict:
    """Join (or create) the process group; returns the world layout.

    Mirrors ``MPI_Init`` + rank/size queries. With no arguments, reads the
    ``DLPS_*`` environment (``distributed/world.py``) and stays a world of
    one when it names no coordinator. Safe to call more than once."""
    from distributedlpsolver_tpu_torch.distributed import world as world_lib

    if _WORLD is None:
        cfg = world_lib.WorldConfig.from_env()
        over = {}
        if coordinator_address is not None:
            over["coordinator"] = coordinator_address
        if num_processes is not None:
            over["world_size"] = int(num_processes)
        if process_id is not None:
            over["rank"] = int(process_id)
        if device is not None:
            over["device"] = str(device)
        if over:
            import dataclasses

            cfg = dataclasses.replace(cfg, **over)
        if cfg.coordinator or cfg.world_size > 1:
            world_lib.init_world(cfg)
    return world()


def world() -> dict:
    """Rank/size view of the runtime (the MPI_Comm_rank/size analogue):
    one device per process, so the device counts are the process count."""
    dist = _dist()
    size = dist.get_world_size() if dist else 1
    return {
        "process_id": dist.get_rank() if dist else 0,
        "num_processes": size,
        "local_devices": 1,
        "global_devices": size,
    }


def is_primary() -> bool:
    """True on the process that should own logging and IO (rank 0)."""
    dist = _dist()
    return dist is None or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the world (a no-op without one). An
    all-reduce of one element on the world's collective device: the
    one collective every backend carries."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return
    dev = _WORLD.collective_device if _WORLD is not None else torch.device("cpu")
    t = torch.zeros(1, device=dev)
    dist.all_reduce(t)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
