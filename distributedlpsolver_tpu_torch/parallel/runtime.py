"""Multi-process runtime: the reference's MPI world, over ``torch.distributed``.

The counterpart of the JAX package's ``parallel/runtime.py``. There,
``jax.distributed.initialize`` joins the processes and ``jax.devices()``
then lists the global device set. Here a world is a ``torch.distributed``
process group of one process per device (``distributed/world.py`` forms
it and picks its backend); this module is the rank/size view of it and
the device each rank runs on. Without a world everything degrades to a
world of one (the ``mpirun -np 1`` analogue).

The elastic shrink's health probes live here too, with the process's
ONE simulated-loss registry (``simulate_device_loss``): the seam the
fault injector (``supervisor/faults.py``) and the network plane's chaos
probes use to make a loss testable without a real one. A key is a mesh
member's id (a world's rank, a local mesh's device id) or a device
(``"cuda:0"``, ``"cpu"``); ``utils/accel.py`` re-exports the registry.
A probe reports a member unhealthy when the registry names it, or when
a tiny op on its device raises or misses its deadline. Under a world a
rank probes only its own device: another rank's device gives no
evidence from here, as in the JAX package's multi-process guard.

Inside :func:`rank_local` a thread's work runs on its rank alone, as in
a world of one: a solve with no process-group mesh is then a program of
this process only, as a mesh-less program is in the JAX package.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence, Tuple

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


_RANK_LOCAL = threading.local()


@contextlib.contextmanager
def rank_local():
    """Run what this thread calls inside the block on this rank alone.

    For a solve that one rank of a world runs by itself: the serving
    service's per-request path on a slice's rank 0, whose followers only
    replay the dispatch journal. There the world's collectives would
    wait for ranks that never come. Inside the block :func:`in_world` is
    False, :func:`is_primary` and :func:`barrier` without a
    process-group mesh act as in a world of one; a mesh's own collectives
    are unchanged."""
    prev = getattr(_RANK_LOCAL, "on", False)
    _RANK_LOCAL.on = True
    try:
        yield
    finally:
        _RANK_LOCAL.on = prev


def _rank_local() -> bool:
    return getattr(_RANK_LOCAL, "on", False)


def in_world() -> bool:
    """True when this thread's work is shared by every rank of a world of
    more than one: False without a world and inside :func:`rank_local`."""
    return not _rank_local() and world()["num_processes"] > 1


def is_primary(mesh=None) -> bool:
    """True on the process that should own logging and IO: rank 0, or
    the first member of ``mesh`` when it has a process group (after a
    shrink, the survivors' first). Inside :func:`rank_local`, and with
    no such mesh, every rank is its own primary."""
    if mesh is not None and mesh.group is not None:
        return mesh.is_primary
    dist = _dist()
    return dist is None or _rank_local() or dist.get_rank() == 0


def barrier(mesh=None) -> None:
    """Wait for every rank of the world (a no-op without one, and inside
    :func:`rank_local`), or for every member of ``mesh`` when it has a
    process group. An all-reduce of one element on the world's
    collective device: the one collective every backend carries."""
    if mesh is not None and mesh.group is not None:
        mesh.barrier()
        return
    dist = _dist()
    if dist is None or _rank_local() or dist.get_world_size() == 1:
        return
    dev = _WORLD.collective_device if _WORLD is not None else torch.device("cpu")
    t = torch.zeros(1, device=dev)
    dist.all_reduce(t)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ----------------------------------------------------------------------
# Health probes and the simulated-loss registry (elastic recovery).

_SIMULATED_LOST: set = set()
_LOST_LOCK = threading.Lock()


def _loss_key(item):
    if isinstance(item, (int,)) and not isinstance(item, bool):
        return int(item)
    return str(torch.device(item))


def simulate_device_loss(devices: Sequence) -> None:
    """Mark mesh member ids (ints) or devices as lost for this process:
    the probes then report them unhealthy without touching them."""
    with _LOST_LOCK:
        _SIMULATED_LOST.update(_loss_key(d) for d in devices)


def restore_devices(devices: Optional[Sequence] = None) -> None:
    """Undo :func:`simulate_device_loss` (every entry when None)."""
    with _LOST_LOCK:
        if devices is None:
            _SIMULATED_LOST.clear()
        else:
            _SIMULATED_LOST.difference_update(_loss_key(d) for d in devices)


def simulated_lost_devices() -> frozenset:
    with _LOST_LOCK:
        return frozenset(_SIMULATED_LOST)


def probe_device(device, deadline: float = 2.0, device_id: Optional[int] = None) -> bool:
    """One device's health: a tiny op on it and a synchronize, on a side
    thread, within ``deadline`` seconds. Unhealthy when the op raises,
    returns a wrong value or misses the deadline, or when the registry
    names the device or its member id ``device_id``."""
    dev = torch.device(device)
    lost = simulated_lost_devices()
    if str(dev) in lost or (device_id is not None and int(device_id) in lost):
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


def probe_devices(devices: Optional[Sequence] = None, deadline: float = 2.0) -> Tuple[List, List]:
    """``(healthy, unhealthy)`` lists of ``torch.device`` from
    :func:`probe_device` on each of ``devices`` (None: this process's
    device, the world's or the first card or the CPU)."""
    if devices is None:
        devices = [_WORLD.device if _WORLD is not None
                   else "cuda" if torch.cuda.is_available() else "cpu"]
    healthy, unhealthy = [], []
    for d in devices:
        d = torch.device(d)
        (healthy if probe_device(d, deadline) else unhealthy).append(d)
    return healthy, unhealthy


def probe_mesh(mesh, deadline: float = 2.0) -> Tuple[List[int], List[int]]:
    """``(healthy, unhealthy)`` member ids of ``mesh``. A local mesh probes
    each member's device; a process-group mesh probes this rank's own
    device and reads the registry for the others (a peer's device gives
    no evidence from here: a member that is neither in the registry nor
    this rank is in neither list)."""
    healthy, unhealthy = [], []
    lost = simulated_lost_devices()
    for i, mid in enumerate(mesh.device_ids):
        if mesh.is_local:
            ok = probe_device(mesh.devices[i], deadline, device_id=mid)
        elif mid in lost:
            ok = False
        elif mesh.member and i == mesh.rank:
            ok = probe_device(mesh.device, deadline, device_id=mid)
        else:
            continue
        (healthy if ok else unhealthy).append(mid)
    return healthy, unhealthy
