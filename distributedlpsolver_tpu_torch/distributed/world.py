"""Process-group world runtime — the multi-process half of ``parallel/``.

The counterpart of the JAX package's ``distributed/world.py``. There,
``jax.distributed.initialize`` wires the processes into one runtime;
here every rank joins one ``torch.distributed`` process group through a
TCP rendezvous at rank 0's address, and runs on one device.

Env contract (set by ``distributed/launcher.py``; the JAX package's
names, plus the device and the process-group backend):

    DLPS_COORDINATOR    host:port of the rank-0 rendezvous
    DLPS_RANK           this process's rank (0-based)
    DLPS_WORLD_SIZE     total process count
    DLPS_LOCAL_DEVICES  devices per process: 1 (0 = the default, 1)
    DLPS_HEARTBEAT_DIR  per-rank heartbeat files (death detection)
    DLPS_SLICE_ID       logical slice name (serving registration)
    DLPS_WORLD_GEN      world generation (0 = first launch; bumped by
                        every coordinator-level re-initialization)
    DLPS_DEVICE         ``cuda`` (the default) or ``cpu``
    DLPS_PG_BACKEND     ``nccl`` or ``gloo``; unset = the device's own

Devices and backends. Rank r runs on ``cuda:(local_rank mod
device_count)`` (``cpu`` on the CPU). The process-group backend is an
explicit choice, never a silent switch:

* ``nccl`` on CUDA by default, and only while the world has no more
  ranks than the host has cards (NCCL refuses two ranks on one card) —
  a larger world raises;
* ``gloo`` on the CPU;
* ``gloo`` on CUDA only when asked for (``pg_backend="gloo"``). It
  carries ``all_reduce`` and ``broadcast`` of CUDA tensors through the
  host, which is what lets several ranks share one card.

One process a device is torch's idiom: ``local_devices`` other than 1
(the JAX harness's virtual devices per process) raises.

Death semantics follow the JAX package's: a world dies as a unit. A
rank whose peer dies sees its collective fail (gloo reports the closed
connection) or the peer's heartbeat go stale, and exits with
:data:`WORLD_PEER_LOST_EXIT`; the launcher's supervisor
(``distributed/launcher.WorldSupervisor``) relaunches a smaller world
from the checkpoint.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import sys
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from distributedlpsolver_tpu_torch.parallel import runtime

# Env keys — ONE definition for launcher, worker, cli and tests.
ENV_COORDINATOR = "DLPS_COORDINATOR"
ENV_RANK = "DLPS_RANK"
ENV_WORLD_SIZE = "DLPS_WORLD_SIZE"
ENV_LOCAL_DEVICES = "DLPS_LOCAL_DEVICES"
ENV_HEARTBEAT_DIR = "DLPS_HEARTBEAT_DIR"
ENV_SLICE_ID = "DLPS_SLICE_ID"
ENV_WORLD_GEN = "DLPS_WORLD_GEN"
ENV_DEVICE = "DLPS_DEVICE"
ENV_PG_BACKEND = "DLPS_PG_BACKEND"


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    """One process's view of the world it should join."""

    coordinator: Optional[str] = None  # host:port; None = no process group
    rank: int = 0
    world_size: int = 1
    local_devices: int = 0  # 0 = the default: one device per process
    heartbeat_dir: Optional[str] = None
    slice_id: Optional[str] = None
    generation: int = 0
    # Heartbeat cadence and staleness: a peer whose file has not moved for
    # ``heartbeat_ttl_s`` is presumed dead (the JAX package's values: a
    # false peer loss kills the whole world, so the TTL is generous).
    heartbeat_period_s: float = 1.0
    heartbeat_ttl_s: float = 15.0
    # Rendezvous and collective timeout (a rank waits this long for a
    # slower peer at a collective).
    init_timeout_s: float = 120.0
    device: str = "cuda"
    pg_backend: Optional[str] = None  # None = nccl on cuda, gloo on cpu

    @classmethod
    def from_env(cls, env=os.environ) -> "WorldConfig":
        return cls(
            coordinator=env.get(ENV_COORDINATOR) or None,
            rank=int(env.get(ENV_RANK, "0")),
            world_size=int(env.get(ENV_WORLD_SIZE, "1")),
            local_devices=int(env.get(ENV_LOCAL_DEVICES, "0")),
            heartbeat_dir=env.get(ENV_HEARTBEAT_DIR) or None,
            slice_id=env.get(ENV_SLICE_ID) or None,
            generation=int(env.get(ENV_WORLD_GEN, "0")),
            device=env.get(ENV_DEVICE) or "cuda",
            pg_backend=env.get(ENV_PG_BACKEND) or None,
        )


def rank_device(cfg: WorldConfig) -> torch.device:
    """Rank r's device: ``cuda:(local_rank mod device_count)``, or the
    CPU. The launcher's worlds live on one host, so the local rank is the
    rank. Raises when CUDA is asked for and there is no card."""
    kind = torch.device(cfg.device).type
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"unsupported world device {cfg.device!r} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", cfg.rank % torch.cuda.device_count())


def pg_backend_for(cfg: WorldConfig, device: torch.device) -> str:
    """The process-group backend of ``cfg``'s world on ``device`` (see the
    module note): raises for NCCL on the CPU and for an NCCL world with
    more ranks than cards."""
    if cfg.local_devices not in (0, 1):
        raise ValueError(
            f"local_devices={cfg.local_devices}: a torch world runs one process per "
            "device (the JAX harness's virtual devices per process have no torch "
            "counterpart); launch one rank per device instead"
        )
    asked = (cfg.pg_backend or "").lower() or None
    if asked not in (None, "nccl", "gloo"):
        raise ValueError(f"unknown process-group backend {cfg.pg_backend!r} (nccl or gloo)")
    if device.type == "cpu":
        if asked == "nccl":
            raise ValueError("the nccl backend needs CUDA devices; a CPU world runs gloo")
        return "gloo"
    if asked == "gloo":
        return "gloo"
    cards = torch.cuda.device_count()
    if cfg.world_size > cards:
        raise ValueError(
            f"an nccl world of {cfg.world_size} ranks needs {cfg.world_size} cards and "
            f"this host has {cards} (NCCL refuses two ranks on one card); ask for "
            "pg_backend='gloo' to share the cards"
        )
    return "nccl"


def peer_lost(world: "World", err: BaseException) -> bool:
    """Whether ``err``, raised on a rank of ``world``, is a peer's death:
    gloo reports a closed connection, or a peer's heartbeat is stale. Any
    other error is the rank's own."""
    if world.world_size <= 1 or isinstance(err, NotImplementedError):
        return False
    msg = str(err).lower()
    if any(w in msg for w in _CLOSED_CONNECTION):
        return True
    stale = world.peer_staleness() if world.cfg.heartbeat_dir else {}
    return any(s > world.cfg.heartbeat_ttl_s for s in stale.values())


def exit_on_peer_loss(world: "World", err: BaseException) -> None:
    """Leave the process with :data:`WORLD_PEER_LOST_EXIT` when ``err`` is
    a peer's death (a world dies as a unit; the launcher's supervisor
    relaunches it), skipping the teardown a collective with the dead peer
    would block; return otherwise."""
    if peer_lost(world, err):
        print(f"[world] rank {world.rank}: a peer died mid-collective ({err}); exiting",
              file=sys.stderr, flush=True)
        os._exit(WORLD_PEER_LOST_EXIT)


def _die_on_peer_loss(world: "World", dead: List[int]) -> None:
    """Default peer-loss reaction: exit hard, immediately. A collective
    may be wedged on the dead peer, and normal teardown would block
    behind it, so ``os._exit`` skips it."""
    print(
        f"[world] rank {world.rank}: peer rank(s) {dead} lost heartbeat — "
        f"world is dead, exiting",
        file=sys.stderr,
        flush=True,
    )
    os._exit(WORLD_PEER_LOST_EXIT)


# Exit code of a deliberate peer-loss exit — the launcher's supervisor
# distinguishes "this rank detected a dead peer" from "this rank was the
# original fault".
WORLD_PEER_LOST_EXIT = 43

# gloo's TCP transport reports a peer's closed connection so: a read
# that hit EOF, or a read or write that the OS refused (ECONNRESET, EPIPE).
_CLOSED_CONNECTION = ("connection closed by peer", "connection reset by peer", "broken pipe")


class World:
    """A joined process group: rank/size, its device and backend, the
    mesh, small host collectives, and the heartbeat threads."""

    def __init__(self, cfg: WorldConfig, device: torch.device, pg_backend: Optional[str]):
        import torch.distributed as dist

        self.cfg = cfg
        self.device = device
        self.pg_backend = pg_backend
        joined = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if joined else 0
        self.world_size = dist.get_world_size() if joined else 1
        self._joined = joined
        self._hb_thread: Optional[threading.Thread] = None
        self._monitor_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._closed = False

    # -- identity ---------------------------------------------------------

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    @property
    def collective_device(self) -> torch.device:
        """Where the world's own small collectives run: the card under
        NCCL, the host under gloo."""
        return self.device if self.pg_backend == "nccl" else torch.device("cpu")

    def describe(self) -> dict:
        return {
            "rank": self.rank,
            "world_size": self.world_size,
            "generation": self.cfg.generation,
            "slice_id": self.cfg.slice_id,
            "local_devices": 1,
            "global_devices": self.world_size,
            "platform": self.device.type,
            "device": str(self.device),
            "pg_backend": self.pg_backend,
        }

    # -- mesh / collectives ----------------------------------------------

    def mesh(self, axis: str = "batch"):
        """1-D mesh over every rank of the world."""
        from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib

        return mesh_lib.make_mesh(axis_names=(axis,), device=self.device)

    def barrier(self, tag: str = "world") -> None:
        runtime.barrier()

    def allgather(self, value) -> list:
        """Gather a small host value (scalar or 1-D list of numbers) from
        every rank; returns the rank-ordered list on ALL ranks. A
        collective (each rank writes its row of a zeroed table, then one
        all-reduce): every rank must call it in the same order."""
        if self.world_size <= 1:
            return [value]
        import torch.distributed as dist

        arr = np.atleast_1d(np.asarray(value, dtype=np.float64))
        table = torch.zeros((self.world_size, arr.size), dtype=torch.float64,
                            device=self.collective_device)
        table[self.rank] = torch.as_tensor(arr, device=table.device)
        dist.all_reduce(table)
        out = table.cpu().numpy()
        if np.ndim(value) == 0:
            return [float(v[0]) for v in out]
        return [list(map(float, v)) for v in out]

    def agree(self, value, what: str = "value") -> list:
        """Assert every rank holds the SAME ``value``; returns the
        gathered list, raises on a mismatch."""
        vals = self.allgather(value)
        if any(v != vals[0] for v in vals[1:]):
            raise AssertionError(f"world disagreement on {what}: per-rank values {vals}")
        return vals

    # -- heartbeat --------------------------------------------------------

    def _hb_path(self, rank: int) -> str:
        return os.path.join(self.cfg.heartbeat_dir, f"rank{rank}.hb")

    def start_heartbeat(
        self,
        on_peer_loss: Optional[Callable[["World", List[int]], None]] = None,
    ) -> None:
        """Start the heartbeat writer (every rank) and the peer monitor
        (worlds of more than one). No-op without a heartbeat_dir. A world
        of one still writes: the supervisor reads the beat as its
        world-ready signal."""
        if self.cfg.heartbeat_dir is None:
            return
        os.makedirs(self.cfg.heartbeat_dir, exist_ok=True)
        self._write_beat()  # first beat before anyone can monitor us
        self._stop.clear()
        self._hb_thread = threading.Thread(
            target=self._beat_loop, daemon=True, name="dlps-world-hb"
        )
        self._hb_thread.start()
        if self.world_size <= 1:
            return
        cb = on_peer_loss or _die_on_peer_loss
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, args=(cb,), daemon=True, name="dlps-world-monitor",
        )
        self._monitor_thread.start()

    def _write_beat(self) -> None:
        from distributedlpsolver_tpu_torch.utils.logging import stamp_record

        path = self._hb_path(self.rank)
        tmp = f"{path}.{os.getpid()}.tmp"
        payload = json.dumps(
            stamp_record({"rank": self.rank, "pid": os.getpid(),
                          "generation": self.cfg.generation})
        )
        try:
            with open(tmp, "w") as fh:
                fh.write(payload)
            os.replace(tmp, path)
        except OSError:
            pass  # a missed beat is recoverable; TTL ≥ 3 periods

    def _beat_loop(self) -> None:
        while not self._stop.wait(self.cfg.heartbeat_period_s):
            self._write_beat()

    def peer_staleness(self) -> dict:
        """rank -> seconds since that rank's last beat (inf = no file)."""
        now = time.time()
        out = {}
        for r in range(self.world_size):
            if r == self.rank:
                continue
            try:
                out[r] = now - os.stat(self._hb_path(r)).st_mtime
            except OSError:
                out[r] = float("inf")
        return out

    def _monitor_loop(self, on_peer_loss) -> None:
        # A peer is monitored once its FIRST beat has been seen.
        seen: set = set()
        while not self._stop.wait(self.cfg.heartbeat_period_s):
            stale = self.peer_staleness()
            seen.update(r for r, s in stale.items() if s < np.inf)
            dead = sorted(r for r, s in stale.items()
                          if r in seen and s > self.cfg.heartbeat_ttl_s)
            if dead:
                on_peer_loss(self, dead)
                return

    # -- teardown ---------------------------------------------------------

    def close(self) -> None:
        """Stop heartbeats and leave the process group."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        for t in (self._hb_thread, self._monitor_thread):
            if t is not None:
                t.join(timeout=2.0)
        if runtime.current_world() is self:
            runtime.set_world(None)
        if self._joined:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()


def init_world(cfg: Optional[WorldConfig] = None) -> World:
    """Join the configured world; returns the World.

    With a coordinator, every rank (a world of one included) joins a
    process group at ``tcp://<coordinator>``; without one, ``world_size``
    must be 1 and the world is this process alone, with no process group
    (the ``mpirun -np 1`` analogue)."""
    cfg = cfg or WorldConfig.from_env()
    device = rank_device(cfg)
    backend = pg_backend_for(cfg, device)
    if cfg.coordinator:
        import torch.distributed as dist

        if device.type == "cuda":
            torch.cuda.set_device(device)
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(
            backend=backend,
            init_method=f"tcp://{cfg.coordinator}",
            world_size=cfg.world_size,
            rank=cfg.rank,
            timeout=datetime.timedelta(seconds=cfg.init_timeout_s),
            **kw,
        )
    elif cfg.world_size > 1:
        raise ValueError(
            f"world_size={cfg.world_size} needs a coordinator address ({ENV_COORDINATOR})"
        )
    world = World(cfg, device, backend if cfg.coordinator else None)
    if world.world_size != cfg.world_size:
        raise RuntimeError(
            f"world formed with {world.world_size} processes, expected {cfg.world_size}"
        )
    runtime.set_world(world)
    return world


def world_from_env() -> World:
    """``init_world(WorldConfig.from_env())`` — the worker entry's one-liner."""
    return init_world(WorldConfig.from_env())
