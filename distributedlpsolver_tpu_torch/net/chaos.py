"""Deterministic chaos harness for the serving fabric: seeded fault
schedules injected into a live multi-process plane. The port of the JAX
package's ``net/chaos.py``: it spawns this package's CLI, each backend on
the plane's ``device`` (``--device``; the card unless the caller asks
for the CPU).

The harness manages REAL processes (``cli serve-http`` backends and
``cli route`` routers via :class:`ChaosPlane`) and injects the faults
the crash-safe fabric exists to survive:

- ``kill9``            — SIGKILL a process (backend, router, front-end);
- ``restart``          — relaunch a killed process with its original
                         command line (same port, same journal_dir —
                         the journal-replay recovery path);
- ``torn_tail``        — truncate the final bytes of a journal WAL
                         before a restart (the crash-mid-write
                         artifact replay must absorb);
- ``sigstop``/``sigcont`` — freeze/thaw a backend (the slow-backend
                         stall: probes time out, forwards hang, the
                         router must fail over without losing work);
- ``journal_fault``    — spawn a backend with
                         ``DLPS_JOURNAL_FAIL_AFTER=n`` so its n-th WAL
                         append raises (durability degrades, serving
                         must not).

Everything is seeded: :meth:`ChaosSchedule.seeded` derives the event
fractions from one ``random.Random(seed)``, and the router's probe
backoff jitter is already deterministic, so a failing chaos run replays
exactly from its seed. ``scripts/port_probe_chaos.py`` drives the acceptance
scenario (2 routers + 2 backends, 200 requests / 2 tenants) and asserts
the invariant the whole PR is about: **no acknowledged request is ever
lost** — every 200/202 resolves to an honest verdict after recovery,
with zero duplicate solves and zero warm rebuilds of a bucket program.

The elasticity leg (README "Elasticity & overload protection") adds a
closed control loop to the plane: :class:`LoadRamp` paces a
deterministic rps ramp (up / hold / down) while an
:class:`~distributedlpsolver_tpu_torch.serve.elastic.ElasticController`
scales real backends against it, and :meth:`ChaosPlane.kill9_pid`
SIGKILLs controller-spawned members (which live outside ``procs``) so
self-healing is validated mid-scale. The JAX package's ``scripts/probe_elastic_serve.py``
drives that acceptance scenario.

The tail leg (README "Tail tolerance") adds the straggler faults
hedging exists for: ``sigstop`` freezes one backend mid-stream (the
router's hedge — not just its retry — must keep the tail bounded) and
:class:`SlowLoris` drips never-completing request headers into a plane
process to tie up handler threads while live traffic keeps flowing.
The JAX package's ``scripts/probe_tail.py`` drives that scenario over its plane.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional

from distributedlpsolver_tpu_torch.serve.journal import FAULT_ENV

# Spawned processes run `python -m distributedlpsolver_tpu_torch.cli` from the
# repository root so the package resolves without installation.
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault: fires when the observed progress fraction
    (completed responses / planned requests) crosses ``at_frac``."""

    at_frac: float
    kind: str  # kill9 | restart | torn_tail | sigstop | sigcont
    target: str  # logical process name (ChaosPlane key)


class ChaosSchedule:
    """An ordered, seeded fault schedule over a request stream."""

    def __init__(self, events: List[ChaosEvent]):
        self.events = sorted(events, key=lambda e: e.at_frac)
        self._fired: set = set()

    @classmethod
    def seeded(cls, seed: int) -> "ChaosSchedule":
        """The acceptance schedule with seed-jittered firing points:
        backend B killed early and restarted (journal replay #1), the
        front-end of backend A killed mid-stream with a torn WAL tail
        and restarted (journal replay #2 over a crash artifact), one
        router killed outright (its sibling carries the traffic)."""
        import random

        rng = random.Random(seed)

        def j(center: float) -> float:
            return center + rng.uniform(-0.05, 0.05)

        return cls(
            [
                ChaosEvent(j(0.20), "kill9", "backend-b"),
                ChaosEvent(j(0.35), "restart", "backend-b"),
                ChaosEvent(j(0.50), "kill9", "backend-a"),
                ChaosEvent(j(0.55), "torn_tail", "backend-a"),
                ChaosEvent(j(0.58), "restart", "backend-a"),
                ChaosEvent(j(0.75), "kill9", "router-2"),
            ]
        )

    def due(self, frac: float) -> List[ChaosEvent]:
        """Events whose firing point has been crossed and not fired
        yet, in order."""
        out = []
        for i, e in enumerate(self.events):
            if i not in self._fired and frac >= e.at_frac:
                self._fired.add(i)
                out.append(e)
        return out


class LoadRamp:
    """Deterministic piecewise request pacing for the elasticity leg:
    ramp up to ``peak_rps`` over the first ``up_frac`` of the run, hold,
    then ramp back down over the final ``down_frac``. The controller
    under test must scale out during the hold and back in after the
    ramp releases — both transitions are driven by this one shape, so a
    failing run replays exactly."""

    def __init__(
        self,
        total: int,
        peak_rps: float,
        base_rps: float = 1.0,
        up_frac: float = 0.3,
        down_frac: float = 0.3,
    ):
        if total <= 0:
            raise ValueError("LoadRamp needs a positive request count")
        self.total = total
        self.peak_rps = max(peak_rps, base_rps)
        self.base_rps = max(1e-6, base_rps)
        self.up_frac = min(0.49, max(0.0, up_frac))
        self.down_frac = min(0.49, max(0.0, down_frac))

    def rps_at(self, frac: float) -> float:
        """Target request rate at progress fraction ``frac`` in [0, 1]."""
        frac = min(1.0, max(0.0, frac))
        lo, hi = self.base_rps, self.peak_rps
        if self.up_frac > 0.0 and frac < self.up_frac:
            return lo + (hi - lo) * (frac / self.up_frac)
        if self.down_frac > 0.0 and frac > 1.0 - self.down_frac:
            return lo + (hi - lo) * ((1.0 - frac) / self.down_frac)
        return hi

    def gap_s(self, i: int) -> float:
        """Inter-arrival sleep before request ``i`` (0-based)."""
        return 1.0 / self.rps_at(i / float(self.total))


class SlowLoris:
    """Slow-loris attacker for the tail leg: ``conns`` sockets against
    one plane process, each sending an HTTP request whose headers never
    finish — one byte every ``drip_s`` seconds, no terminating blank
    line. The plane's servers are threaded, so each drip pins one
    handler thread; the probe asserts that live traffic keeps meeting
    its latency bound while the drip holds. Deterministic by
    construction (fixed byte stream, fixed cadence)."""

    _PREFIX = b"POST /v1/solve HTTP/1.1\r\nHost: loris\r\nX-Loris: "

    def __init__(
        self,
        host: str,
        port: int,
        conns: int = 8,
        drip_s: float = 0.25,
    ):
        self.host = host
        self.port = port
        self.conns = conns
        self.drip_s = drip_s
        # Attack ledger (guarded by _lock): connections that opened and
        # total header bytes dripped — the probe's proof the attack was
        # actually in progress while the latency bound held.
        self.opened = 0
        self.dripped = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    def _run_one(self) -> None:
        try:
            sock = socket.create_connection(
                (self.host, self.port), timeout=5.0
            )
        except OSError:
            return
        with self._lock:
            self.opened += 1
        try:
            sock.sendall(self._PREFIX)
            while not self._stop.wait(self.drip_s):
                sock.sendall(b"y")
                with self._lock:
                    self.dripped += 1
        except OSError:
            pass  # the server hung up on us — that is its prerogative
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def start(self) -> "SlowLoris":
        for i in range(self.conns):
            t = threading.Thread(
                target=self._run_one,
                daemon=True,
                name=f"dlps-loris-{i}",
            )
            t.start()
            self._threads.append(t)
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout)


@dataclasses.dataclass
class ManagedProcess:
    """One spawned plane process plus everything needed to relaunch it."""

    name: str
    cmd: List[str]
    popen: subprocess.Popen
    url: str
    port: int
    journal_dir: Optional[str] = None
    log_path: Optional[str] = None
    env: Optional[dict] = None

    @property
    def pid(self) -> int:
        return self.popen.pid

    def alive(self) -> bool:
        return self.popen.poll() is None


def free_port() -> int:
    """An OS-assigned free TCP port (the restart scenario needs FIXED
    ports — poll URLs and registry entries embed them — so the plane
    reserves them up front instead of binding port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ChaosPlane:
    """Spawns and manipulates the multi-process serving plane. Backends
    (and the backends an elastic controller spawns) run on ``device``:
    the card by default, where a process that finds none fails rather
    than serving from the host; ``"cpu"`` asks for the host."""

    def __init__(self, workdir: str, device: str = "cuda"):
        self.workdir = workdir
        self.device = device
        self.procs: Dict[str, ManagedProcess] = {}
        os.makedirs(workdir, exist_ok=True)

    # -- spawning ---------------------------------------------------------

    def _spawn(
        self,
        name: str,
        cmd: List[str],
        port: int,
        journal_dir: Optional[str] = None,
        extra_env: Optional[dict] = None,
    ) -> ManagedProcess:
        log_path = os.path.join(self.workdir, f"{name}.log")
        env = dict(os.environ)
        env.update(extra_env or {})
        with open(log_path, "ab") as log:
            popen = subprocess.Popen(
                cmd, stdout=log, stderr=log, env=env, cwd=_REPO_ROOT,
            )
        proc = ManagedProcess(
            name=name,
            cmd=cmd,
            popen=popen,
            url=f"http://127.0.0.1:{port}",
            port=port,
            journal_dir=journal_dir,
            log_path=log_path,
            env=extra_env,
        )
        self.procs[name] = proc
        return proc

    def spawn_backend(
        self,
        name: str,
        port: Optional[int] = None,
        journal_dir: Optional[str] = None,
        buckets_json: Optional[str] = None,
        extra_flags: Optional[List[str]] = None,
        extra_env: Optional[dict] = None,
    ) -> ManagedProcess:
        """One ``cli serve-http`` backend (its own process, its own
        journal directory)."""
        port = port or free_port()
        journal_dir = journal_dir or os.path.join(
            self.workdir, f"journal-{name}"
        )
        cmd = [
            sys.executable, "-m", "distributedlpsolver_tpu_torch.cli",
            "serve-http", "--port", str(port),
            "--journal-dir", journal_dir,
            "--device", self.device,
            "--quiet",
        ]
        if buckets_json:
            cmd += ["--buckets", buckets_json, "--warm-buckets"]
        cmd += extra_flags or []
        return self._spawn(
            name, cmd, port, journal_dir=journal_dir, extra_env=extra_env
        )

    def spawn_controller(
        self,
        name: str,
        registry_path: str,
        min_backends: int = 1,
        max_backends: int = 3,
        buckets_json: Optional[str] = None,
        extra_flags: Optional[List[str]] = None,
    ) -> ManagedProcess:
        """One ``cli elastic`` autoscaler over the shared registry —
        the controller leg of the chaos plane. Its spawned backends are
        real ``serve-http`` processes the schedule can kill -9 by pid
        (:meth:`kill9_pid`); the loop must reap and replace them."""
        cmd = [
            sys.executable, "-m", "distributedlpsolver_tpu_torch.cli",
            "elastic", "--registry", registry_path,
            "--min-backends", str(min_backends),
            "--max-backends", str(max_backends),
            "--workdir", self.workdir,
            "--device", self.device,
        ]
        if buckets_json:
            cmd += ["--buckets", buckets_json]
        cmd += extra_flags or []
        return self._spawn(name, cmd, port=0)

    def spawn_router(
        self,
        name: str,
        backends: List[str],
        registry_path: str,
        port: Optional[int] = None,
        extra_flags: Optional[List[str]] = None,
    ) -> ManagedProcess:
        """One ``cli route`` router over the shared registry."""
        port = port or free_port()
        cmd = [
            sys.executable, "-m", "distributedlpsolver_tpu_torch.cli",
            "route", "--port", str(port),
            "--registry", registry_path,
            "--poll-s", "0.25",
        ]
        for b in backends:
            cmd += ["--backend", b]
        cmd += extra_flags or []
        return self._spawn(name, cmd, port)

    # -- readiness --------------------------------------------------------

    def wait_ready(self, proc: ManagedProcess, timeout: float = 120.0) -> bool:
        """Poll ``/healthz`` until 200 (backends answer once their
        warm-up finished and the listener bound)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not proc.alive():
                return False
            try:
                with urllib.request.urlopen(
                    proc.url + "/healthz", timeout=2.0
                ) as r:
                    if r.status == 200:
                        return True
            except (urllib.error.URLError, OSError, ValueError):
                pass
            time.sleep(0.1)
        return False

    # -- fault injection --------------------------------------------------

    def kill9(self, name: str) -> None:
        """SIGKILL — the fault the journal exists for: no atexit, no
        flush, no goodbye."""
        proc = self.procs[name]
        try:
            os.kill(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.popen.wait(timeout=30)

    @staticmethod
    def kill9_pid(pid: int) -> bool:
        """SIGKILL a process the plane did not spawn — the
        controller-leg fault: elastic-pool members are children of the
        ElasticController, not ``procs`` entries, yet the schedule must
        still be able to kill one mid-scale. Returns False if the pid
        was already gone."""
        try:
            os.kill(pid, signal.SIGKILL)
        except (ProcessLookupError, OSError):
            return False
        return True

    def restart(self, name: str, wait: bool = True) -> ManagedProcess:
        """Relaunch a killed process with its original command line —
        same port, same journal directory (the replay path)."""
        old = self.procs[name]
        if old.alive():
            self.kill9(name)
        with open(old.log_path, "ab") as log:
            env = dict(os.environ)
            # Injected journal faults are one-shot per incarnation: the
            # restart comes back with a healthy WAL.
            env.pop(FAULT_ENV, None)
            popen = subprocess.Popen(
                old.cmd, stdout=log, stderr=log, env=env, cwd=_REPO_ROOT,
            )
        proc = dataclasses.replace(old, popen=popen, env=None)
        self.procs[name] = proc
        if wait:
            self.wait_ready(proc)
        return proc

    def sigstop(self, name: str) -> None:
        """Freeze (the slow-backend stall: sockets stay open, nothing
        answers)."""
        os.kill(self.procs[name].pid, signal.SIGSTOP)

    def sigcont(self, name: str) -> None:
        os.kill(self.procs[name].pid, signal.SIGCONT)

    @staticmethod
    def torn_tail(journal_dir: str, nbytes: int = 9) -> bool:
        """Truncate the WAL's final bytes — the crash-mid-write
        artifact. Returns True if anything was cut."""
        path = os.path.join(journal_dir, "journal.jsonl")
        try:
            size = os.path.getsize(path)
        except OSError:
            return False
        if size <= nbytes:
            return False
        with open(path, "ab") as fh:
            fh.truncate(size - nbytes)
        return True

    def apply(self, event: ChaosEvent) -> str:
        """Fire one scheduled event; returns a human-readable note."""
        if event.kind == "kill9":
            self.kill9(event.target)
            return f"kill -9 {event.target}"
        if event.kind == "restart":
            self.restart(event.target)
            return f"restarted {event.target}"
        if event.kind == "torn_tail":
            jd = self.procs[event.target].journal_dir
            cut = bool(jd) and self.torn_tail(jd)
            return f"torn tail on {event.target} (cut={cut})"
        if event.kind == "sigstop":
            self.sigstop(event.target)
            return f"SIGSTOP {event.target}"
        if event.kind == "sigcont":
            self.sigcont(event.target)
            return f"SIGCONT {event.target}"
        raise ValueError(f"unknown chaos event kind {event.kind!r}")

    # -- teardown ---------------------------------------------------------

    def shutdown_all(self) -> None:
        for proc in self.procs.values():
            if proc.alive():
                try:
                    proc.popen.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + 10.0
        for proc in self.procs.values():
            try:
                proc.popen.wait(
                    timeout=max(0.1, deadline - time.monotonic())
                )
            except subprocess.TimeoutExpired:
                try:
                    os.kill(proc.pid, signal.SIGKILL)
                except OSError:
                    pass


def journal_duplicate_solves(journal_dir: str) -> int:
    """Finished-record duplicates in one journal WAL (0 = the
    fingerprint-idempotent replay never solved one job twice). Counts
    ``finished`` records per jid across the whole file, tolerating the
    same torn/garbage lines replay does."""
    path = os.path.join(journal_dir, "journal.jsonl")
    counts: Dict[str, int] = {}
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("j") == "finished":
                    jid = str(rec.get("jid"))
                    counts[jid] = counts.get(jid, 0) + 1
    except OSError:
        return 0
    return sum(c - 1 for c in counts.values() if c > 1)
