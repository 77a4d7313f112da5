"""Single-machine multi-process world launcher + coordinator recovery.

The counterpart of the JAX package's ``distributed/launcher.py``: spawn
N rank processes with the world env contract (``distributed/world.py``),
all joined through one rendezvous on a freshly allocated localhost
port. Each rank runs one device: a card (``cuda:(rank mod cards)``), or
the CPU with ``device="cpu"`` (the tests' harness). ``pg_backend="gloo"``
asks for gloo on the cards, which lets several ranks share one card;
without it a CUDA world is NCCL and may not outnumber the cards.

Coordinator-level recovery: a world DIES AS A UNIT when any rank is
lost (a collective with a dead peer fails, or its heartbeat goes stale:
``distributed/world.py``). :class:`WorldSupervisor` watches the rank
processes and, when the world dies, launches a WHOLE NEW world over the
surviving capacity — smaller world size, fresh rendezvous port, bumped
generation — whose ranks resume from the host-canonical checkpoint
(written on a world of 3, restored on 2). Each re-initialization emits
a ``world_reinit`` JSONL event carrying ``recovery_overhead_s``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

from distributedlpsolver_tpu_torch.distributed import world as world_lib
from distributedlpsolver_tpu_torch.utils.logging import stamp_record

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@dataclasses.dataclass
class RankProcess:
    rank: int
    popen: subprocess.Popen
    log_path: str

    @property
    def pid(self) -> int:
        return self.popen.pid

    def alive(self) -> bool:
        return self.popen.poll() is None


class WorldHandle:
    """One launched world: its rank processes, env, and artifacts."""

    def __init__(
        self,
        procs: List[RankProcess],
        workdir: str,
        coordinator: str,
        generation: int,
        world_size: int,
    ):
        self.procs = procs
        self.workdir = workdir
        self.coordinator = coordinator
        self.generation = generation
        self.world_size = world_size

    @property
    def heartbeat_dir(self) -> str:
        return os.path.join(self.workdir, f"hb-gen{self.generation}")

    @property
    def out_dir(self) -> str:
        return os.path.join(self.workdir, "out")

    def alive_ranks(self) -> List[int]:
        return [p.rank for p in self.procs if p.alive()]

    def dead_ranks(self) -> List[int]:
        return [p.rank for p in self.procs if not p.alive()]

    def kill_rank(self, rank: int, sig: int = signal.SIGKILL) -> None:
        for p in self.procs:
            if p.rank == rank and p.alive():
                try:
                    os.kill(p.pid, sig)
                except ProcessLookupError:
                    pass

    def kill_all(self, sig: int = signal.SIGKILL) -> None:
        for p in self.procs:
            if p.alive():
                try:
                    os.kill(p.pid, sig)
                except ProcessLookupError:
                    pass
        for p in self.procs:
            try:
                p.popen.wait(timeout=15)
            except subprocess.TimeoutExpired:
                pass

    def wait(self, timeout: Optional[float] = None) -> Dict[int, int]:
        """Wait for every rank to exit; rank -> returncode. Raises
        TimeoutError (world left running) when the budget elapses."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for p in self.procs:
            t = None if deadline is None else max(0.0, deadline - time.monotonic())
            try:
                p.popen.wait(timeout=t)
            except subprocess.TimeoutExpired:
                raise TimeoutError(
                    f"world gen{self.generation}: rank {p.rank} still "
                    f"running after {timeout}s (log: {p.log_path})"
                )
        return {p.rank: p.popen.returncode for p in self.procs}

    def poll_any_death(self) -> Optional[int]:
        """First dead rank's rank id, or None while all run."""
        for p in self.procs:
            if not p.alive():
                return p.rank
        return None

    def results(self) -> Dict[int, dict]:
        """Per-rank result JSON written by the worker entry (rank files
        that exist and parse; a crashed rank simply has none)."""
        out: Dict[int, dict] = {}
        for p in self.procs:
            path = os.path.join(self.out_dir, f"rank{p.rank}.json")
            try:
                with open(path) as fh:
                    out[p.rank] = json.load(fh)
            except (OSError, ValueError):
                pass
        return out

    def tail_logs(self, nbytes: int = 4000) -> str:
        chunks = []
        for p in self.procs:
            try:
                with open(p.log_path, "rb") as fh:
                    fh.seek(0, os.SEEK_END)
                    size = fh.tell()
                    fh.seek(max(0, size - nbytes))
                    chunks.append(
                        f"--- rank {p.rank} ({p.log_path}) ---\n"
                        + fh.read().decode("utf-8", "replace")
                    )
            except OSError:
                pass
        return "\n".join(chunks)


def launch_world(
    argv_for: Callable[[int], List[str]],
    world_size: int,
    workdir: str,
    local_devices: int = 1,
    generation: int = 0,
    coordinator_port: Optional[int] = None,
    slice_id: Optional[str] = None,
    extra_env: Optional[dict] = None,
    device: str = "cuda",
    pg_backend: Optional[str] = None,
) -> WorldHandle:
    """Spawn one world of ``world_size`` rank processes.

    ``argv_for(rank)`` builds each rank's command line (usually the
    worker entry). The launcher owns the env contract: rendezvous
    address, rank/world size, device and process-group backend, and the
    heartbeat dir (per generation — a relaunch never reads the dead
    world's beats). CPU ranks run torch on one thread
    (``OMP_NUM_THREADS=1`` unless set): N ranks share the host's cores.
    """
    os.makedirs(workdir, exist_ok=True)
    port = coordinator_port or free_port()
    coordinator = f"127.0.0.1:{port}"
    handle = WorldHandle([], workdir, coordinator, generation, world_size)
    os.makedirs(handle.heartbeat_dir, exist_ok=True)
    os.makedirs(handle.out_dir, exist_ok=True)
    procs: List[RankProcess] = []
    for rank in range(world_size):
        env = dict(os.environ)
        env.update(extra_env or {})
        if device == "cpu":
            env.setdefault("OMP_NUM_THREADS", "1")
        env[world_lib.ENV_COORDINATOR] = coordinator
        env[world_lib.ENV_RANK] = str(rank)
        env[world_lib.ENV_WORLD_SIZE] = str(world_size)
        env[world_lib.ENV_LOCAL_DEVICES] = str(local_devices)
        env[world_lib.ENV_HEARTBEAT_DIR] = handle.heartbeat_dir
        env[world_lib.ENV_WORLD_GEN] = str(generation)
        env[world_lib.ENV_DEVICE] = device
        if pg_backend:
            env[world_lib.ENV_PG_BACKEND] = pg_backend
        else:
            env.pop(world_lib.ENV_PG_BACKEND, None)
        if slice_id:
            env[world_lib.ENV_SLICE_ID] = slice_id
        log_path = os.path.join(workdir, f"gen{generation}-rank{rank}.log")
        with open(log_path, "ab") as log:
            popen = subprocess.Popen(
                argv_for(rank), stdout=log, stderr=log, env=env, cwd=_REPO_ROOT,
            )
        procs.append(RankProcess(rank=rank, popen=popen, log_path=log_path))
    handle.procs = procs
    return handle


def worker_argv(task: str, spec: dict, out_dir: str) -> Callable[[int], List[str]]:
    """argv builder for the worker entry (distributed/worker.py)."""
    spec_json = json.dumps(spec)

    def argv(rank: int) -> List[str]:
        return [
            sys.executable, "-m", "distributedlpsolver_tpu_torch.distributed.worker",
            "--task", task, "--spec-json", spec_json, "--out", out_dir,
        ]

    return argv


def run_world(
    task: str,
    spec: dict,
    world_size: int,
    workdir: str,
    local_devices: int = 1,
    timeout: float = 300.0,
    retries: int = 1,
    device: str = "cuda",
    pg_backend: Optional[str] = None,
) -> Dict[int, dict]:
    """Launch a world on a worker task, wait, and return per-rank result
    JSON. Raises RuntimeError (with log tails) when any rank failed.

    ``retries``: a failed world is relaunched in a fresh generation
    subdirectory up to this many times (relaunching IS the recovery
    model, as in the JAX package); ``retries=0`` makes the first failure
    the answer. A world that outlives ``timeout`` is killed.
    """
    last_err: Optional[Exception] = None
    for attempt in range(1 + max(0, retries)):
        attempt_dir = workdir if attempt == 0 else os.path.join(workdir, f"retry{attempt}")
        handle = launch_world(
            worker_argv(task, spec, os.path.join(attempt_dir, "out")),
            world_size, attempt_dir, local_devices=local_devices,
            device=device, pg_backend=pg_backend,
        )
        try:
            codes = handle.wait(timeout)
        except TimeoutError as e:
            handle.kill_all()
            last_err = TimeoutError(f"{e}\n{handle.tail_logs()}")
            continue
        if any(codes.values()):
            last_err = RuntimeError(
                f"world task {task!r} failed: rank exit codes {codes}\n" + handle.tail_logs()
            )
            continue
        results = handle.results()
        missing = [r for r in range(world_size) if r not in results]
        if missing:
            last_err = RuntimeError(
                f"world task {task!r}: ranks {missing} wrote no result\n" + handle.tail_logs()
            )
            continue
        return results
    raise last_err  # type: ignore[misc]


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Tunables of the coordinator-level recovery loop."""

    # Smallest world a re-initialization may form; below it the
    # supervisor gives up.
    min_world: int = 1
    # Re-initializations before giving up (a crash-looping task must not
    # burn the machine).
    max_reforms: int = 3
    # How long to wait for every relaunched rank's first heartbeat
    # before calling the re-initialization itself failed.
    reform_ready_timeout_s: float = 120.0
    # JSONL event stream (world_reinit records); None = stderr summary only.
    log_jsonl: Optional[str] = None


class WorldSupervisor:
    """Run a world task under coordinator-level recovery.

    The loop: launch gen-g world → watch for rank death → on death,
    kill the remainder (they are dying anyway), relaunch gen-(g+1) with
    ``world_size - lost`` ranks on a fresh rendezvous port, and emit a
    ``world_reinit`` event stamped with ``recovery_overhead_s`` (death
    detected → every new rank heartbeating). The TASK owns resume
    semantics: a checkpoint path in its spec makes the relaunched solve
    continue from the last saved iterate on the re-formed world.
    """

    def __init__(
        self,
        argv_for_gen: Callable[[int, int, int], Callable[[int], List[str]]],
        world_size: int,
        workdir: str,
        local_devices: int = 1,
        config: Optional[SupervisorConfig] = None,
        slice_id: Optional[str] = None,
        device: str = "cuda",
        pg_backend: Optional[str] = None,
    ):
        # argv_for_gen(generation, world_size, coordinator_port) -> argv_for(rank)
        self._argv_for_gen = argv_for_gen
        self._world_size = world_size
        self._workdir = workdir
        self._local_devices = local_devices
        self._slice_id = slice_id
        self._device = device
        self._pg_backend = pg_backend
        self.config = config or SupervisorConfig()
        self.reinit_events: List[dict] = []
        self.handle: Optional[WorldHandle] = None

    def _emit(self, record: dict) -> None:
        self.reinit_events.append(record)
        if self.config.log_jsonl:
            with open(self.config.log_jsonl, "a") as fh:
                fh.write(json.dumps(stamp_record(dict(record))) + "\n")
        print(f"[world-supervisor] {record}", file=sys.stderr, flush=True)

    def _launch(self, generation: int, world_size: int, port: int) -> WorldHandle:
        return launch_world(
            self._argv_for_gen(generation, world_size, port), world_size, self._workdir,
            local_devices=self._local_devices, generation=generation,
            coordinator_port=port, slice_id=self._slice_id, device=self._device,
            pg_backend=self._pg_backend,
        )

    def _wait_ready(self, handle: WorldHandle) -> bool:
        """Every rank of the (re)launched world wrote a heartbeat —
        world formation completed."""
        deadline = time.monotonic() + self.config.reform_ready_timeout_s
        want = {
            os.path.join(handle.heartbeat_dir, f"rank{r}.hb")
            for r in range(handle.world_size)
        }
        while time.monotonic() < deadline:
            if all(os.path.exists(p) for p in want):
                return True
            if handle.dead_ranks():
                return False
            time.sleep(0.05)
        return False

    def run(self, poll_s: float = 0.1, timeout: float = 600.0) -> Dict[int, dict]:
        """Supervise until the world completes (all ranks exit 0) or
        recovery is exhausted. Returns the completing generation's
        per-rank results."""
        cfg = self.config
        world_size = self._world_size
        generation = 0
        handle = self._launch(generation, world_size, free_port())
        self.handle = handle
        deadline = time.monotonic() + timeout
        while True:
            if time.monotonic() > deadline:
                handle.kill_all()
                raise TimeoutError(
                    f"world supervision budget ({timeout}s) elapsed\n" + handle.tail_logs()
                )
            dead = handle.dead_ranks()
            if not dead:
                time.sleep(poll_s)
                continue
            # Clean completion: every rank exited 0.
            if len(dead) == len(handle.procs) and all(
                p.popen.returncode == 0 for p in handle.procs
            ):
                return handle.results()
            codes = {p.rank: p.popen.returncode for p in handle.procs if not p.alive()}
            if all(c == 0 for c in codes.values()):
                time.sleep(poll_s)  # stragglers still finishing cleanly
                continue
            # ---- world death: coordinator-level re-initialization ------
            t_detect = time.perf_counter()
            lost = [r for r, c in codes.items() if c not in (0, world_lib.WORLD_PEER_LOST_EXIT)]
            handle.kill_all()
            # Exit 43 = "I saw a dead peer and left deliberately": when
            # EVERY death is a 43 no capacity was lost, and the world
            # relaunches at the same size. When every rank died hard in
            # one cascade, ONE loss is attributed (the JAX package's rule).
            if len(lost) == len(codes) == world_size and world_size > 1:
                lost = lost[:1]
            new_size = world_size - len(lost)
            generation += 1
            if new_size < cfg.min_world or generation > cfg.max_reforms:
                raise RuntimeError(
                    f"world recovery exhausted: gen {generation}, "
                    f"survivor count {new_size} (min {cfg.min_world}), "
                    f"lost ranks {lost}\n" + handle.tail_logs()
                )
            world_size = new_size
            handle = self._launch(generation, world_size, free_port())
            self.handle = handle
            ready = self._wait_ready(handle)
            overhead = time.perf_counter() - t_detect
            self._emit({
                "event": "world_reinit",
                "generation": generation,
                "world_size": world_size,
                "slice_id": self._slice_id,
                "recovery_overhead_s": round(overhead, 3),
                "detail": (
                    f"lost ranks {lost} (exit codes {codes}); "
                    f"re-initialized over {world_size} survivors"
                    + ("" if ready else "; READY TIMEOUT")
                ),
            })
            if not ready:
                # The relaunch itself died — loop back; the death branch
                # counts it against max_reforms.
                continue
