"""Closed-loop elasticity: telemetry-driven backend pool autoscaling.

:class:`ElasticController` closes the loop the serving fabric left
open: admission/queue-depth telemetry driving backend pool scale-out/in
(README "Elasticity & overload protection"). A control thread polls the
shared :class:`~distributedlpsolver_tpu_torch.net.registry.BackendRegistry`
and every live backend's ``/statusz`` (queue depth, admission rejects,
p99 latency, inflight, brownout stage) and reconciles the pool against
a hysteresis-gated target:

- **Scale-OUT** spawns a real ``cli serve-http`` process with
  ``--warm-buckets`` and ``--registry``: the new backend builds
  its whole bucket ladder, binds its listener, and only THEN
  self-registers — a rollout never puts a cold backend in rotation, so
  elasticity cannot introduce warm rebuilds by construction.
- **Scale-IN** always drains via ``POST /quitquitquit``: the victim
  leaves rotation (``/readyz`` 503), resolves every admitted request —
  outstanding async polls keep answering through the routers'
  journal-backed fan-out while it drains — and exits on its own; zero
  lost acknowledged requests by construction. Journal directories are
  slot-keyed and REUSED by later spawns on the same slot, so poll ids
  minted by a drained incarnation re-bind in its successor.
- **Self-healing**: a pool member that dies (kill -9, OOM) is reaped
  and replaced toward the standing target without waiting for a scale
  signal — replacement bypasses the cooldown (it restores capacity,
  it doesn't change the target).

Every decision is a stamped JSONL event with an attributed reason:
``scale_out`` / ``scale_in`` on action, ``scale_veto`` when a wanted
action is gated (cooldown, flap damper, min/max bounds, nothing
drainable). Bounds (``min_backends``/``max_backends``), per-action
cooldown, and a sliding-window flap damper keep the loop from
oscillating with its own signal.

Thread-safety: the control loop is single-threaded; the lock guards
the pool map and history against ``statusz()`` readers. Process spawns,
HTTP polls, and drain waits all run OUTSIDE the lock.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics
from distributedlpsolver_tpu_torch.utils.logging import IterLogger


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Tunables of the elasticity control loop."""

    # Shared backend registry (net/registry.py) the pool lives in —
    # spawned backends self-register here and routers adopt them.
    registry_path: str = "registry.json"
    # Pool bounds. The controller immediately grows to min_backends at
    # start and never drains below it / spawns above max.
    min_backends: int = 1
    max_backends: int = 4
    # Decision cadence.
    poll_s: float = 0.5
    # Scale-OUT signal (any of, sustained >= out_sustain_s): mean
    # per-backend load (queue_depth + inflight) at/above load_high;
    # pool-wide admission-reject rate (new rejects per second) at/above
    # reject_rate_high; any backend's brownout stage >= 1; p99 above
    # p99_high_ms (0 disables the latency trigger).
    load_high: float = 8.0
    reject_rate_high: float = 1.0
    p99_high_ms: float = 0.0
    out_sustain_s: float = 1.0
    # Scale-IN signal (all of, sustained >= in_sustain_s): mean load
    # at/below load_low, zero rejects, no brownout anywhere.
    load_low: float = 1.0
    in_sustain_s: float = 5.0
    # Gates: minimum quiet time between target changes, and a sliding-
    # window flap damper over ALL actions (including replacements — a
    # crash-looping backend must not respawn unboundedly fast).
    cooldown_s: float = 5.0
    flap_window_s: float = 60.0
    flap_max_actions: int = 6
    # Spawn parameters for scale-out backends (cli serve-http).
    host: str = "127.0.0.1"
    workdir: str = "."
    buckets_json: Optional[str] = None  # --buckets ladder file
    backend_flags: Sequence[str] = ()  # extra serve-http flags
    backend_env: Mapping[str, str] = dataclasses.field(default_factory=dict)
    heartbeat_s: float = 0.5
    spawn_timeout_s: float = 180.0
    drain_timeout_s: float = 120.0
    # Consecutive failed /statusz sweeps before a registry entry stops
    # counting toward the live pool. Liveness is observer-derived: a
    # stale entry (kill -9'd or drained backend that never unregisters)
    # must not inflate n_live — standalone, with no router probing the
    # registry, nothing else would ever clear it, and an inflated
    # n_live makes reconcile drain HEALTHY members below min_backends
    # while the self-heal respawn never fires.
    statusz_miss_limit: int = 3
    # scale_out/scale_in/scale_veto JSONL event stream; None = off.
    log_jsonl: Optional[str] = None


@dataclasses.dataclass
class ManagedBackend:
    """One pool member this controller spawned (guarded by the
    controller lock; the loop thread writes, statusz readers read)."""

    name: str
    slot: int
    url: str
    port: int
    proc: subprocess.Popen
    journal_dir: str
    log_path: str
    spawned_at: float
    gen: int


# Root directory the package is importable from — spawned backends run
# ``python -m distributedlpsolver_tpu_torch.cli`` and must find it regardless
# of the controller process's cwd (probes run from anywhere).
_PKG_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def _free_port(host: str = "127.0.0.1") -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


class ElasticController:
    """The autoscaler. ``start()`` launches the control thread (after a
    synchronous first reconcile up to ``min_backends``); ``shutdown()``
    stops it and optionally drains the managed pool."""

    def __init__(
        self,
        config: Optional[ElasticConfig] = None,
        metrics: Optional[obs_metrics.MetricsRegistry] = None,
    ):
        self.config = config or ElasticConfig()
        if self.config.min_backends < 0 or (
            self.config.max_backends < max(1, self.config.min_backends)
        ):
            raise ValueError(
                "need 0 <= min_backends <= max_backends (>= 1), got "
                f"{self.config.min_backends}..{self.config.max_backends}"
            )
        self.metrics = (
            metrics if metrics is not None else obs_metrics.get_registry()
        )
        self._logger = IterLogger(
            verbose=False, jsonl_path=self.config.log_jsonl
        )
        from distributedlpsolver_tpu_torch.net.registry import BackendRegistry

        self._registry = BackendRegistry(
            self.config.registry_path, metrics=self.metrics
        )
        self._lock = threading.Lock()
        self._pool: Dict[str, ManagedBackend] = {}  # guarded-by: _lock
        self._history: List[Tuple[float, int]] = []  # guarded-by: _lock
        self._actions: List[dict] = []  # guarded-by: _lock
        self._target = max(self.config.min_backends, 0)
        self._t0 = time.perf_counter()
        self._gen = 0
        self._last_action = 0.0  # perf_counter of the last target change
        self._action_times: List[float] = []  # flap-damper window
        self._hi_since: Optional[float] = None
        self._lo_since: Optional[float] = None
        self._last_veto: Tuple[str, int] = ("", 0)
        self._statusz_misses: Dict[str, int] = {}
        self._prev_rejects: Dict[str, int] = {}
        self._prev_reject_t: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        m = self.metrics
        self._m_pool = m.gauge(
            "elastic_pool_size", help="live backends the controller sees"
        )
        self._m_target = m.gauge(
            "elastic_target_backends", help="current reconcile target"
        )
        self._m_actions = m.counter(
            "elastic_actions_total", help="scale_out + scale_in actions"
        )
        self._m_vetoes = m.counter(
            "elastic_vetoes_total", help="wanted scale actions gated"
        )

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "ElasticController":
        if self._thread is None:
            self.step()  # synchronous first reconcile: min pool exists now
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="dlps-elastic"
            )
            self._thread.start()
        return self

    def shutdown(self, drain: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        if drain:
            with self._lock:
                members = list(self._pool.values())
            for mb in members:
                self._drain_one(mb, reason="shutdown")
        else:
            with self._lock:
                members = list(self._pool.values())
            for mb in members:
                if mb.proc.poll() is None:
                    mb.proc.terminate()
        self._logger.close()

    def _run(self) -> None:
        while not self._stop.wait(self.config.poll_s):
            try:
                self.step()
            except Exception:  # the control loop must survive anything
                pass

    # -- telemetry -------------------------------------------------------

    def _fetch_json(self, url: str, timeout: float = 1.0) -> Optional[dict]:
        try:
            with urllib.request.urlopen(url, timeout=timeout) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except (
            urllib.error.URLError,
            socket.timeout,
            OSError,
            ValueError,
        ):
            return None

    @staticmethod
    def _rejects_in(stz: dict) -> int:
        """Total admission rejections a backend has recorded (all
        tenants, all reasons — brownout sheds included: shed traffic is
        demand the pool is failing to serve)."""
        total = 0
        adm = (stz.get("stats") or {}).get("admission") or {}
        for t in adm.values():
            for n in (t.get("rejected") or {}).values():
                total += int(n)
        return total

    def _observe(self) -> dict:
        """One telemetry sweep: the registry's non-ejected backends +
        each one's /statusz. Returns the signal summary the decision
        step consumes (no lock held across the HTTP fetches).

        Liveness is derived by this observer, not trusted from the
        registry: an entry counts toward ``n_live`` only while its
        /statusz keeps answering (with ``statusz_miss_limit``
        consecutive misses of grace for transient blips). Registry
        entries are registered by the backends themselves and never
        unregistered — a kill -9'd or drained member would otherwise
        inflate ``n_live`` forever when no router is around to probe
        it out, driving reconcile to drain healthy members below
        ``min_backends`` while the self-heal respawn never fires."""
        data = self._registry.load()
        registered = [
            url
            for url, entry in (data.get("backends") or {}).items()
            if not entry.get("ejected", False)
        ]
        now = time.perf_counter()
        loads: List[int] = []
        p99s: List[float] = []
        brownout_stage = 0
        rejects: Dict[str, int] = {}
        ready = 0
        for url in registered:
            stz = self._fetch_json(url.rstrip("/") + "/statusz")
            if stz is None:
                self._statusz_misses[url] = (
                    self._statusz_misses.get(url, 0) + 1
                )
                continue
            self._statusz_misses[url] = 0
            ready += 1
            stats = stz.get("stats") or {}
            net = stz.get("net") or {}
            loads.append(
                int(stats.get("queue_depth", 0) or 0)
                + int(net.get("inflight", 0) or 0)
            )
            bo = stats.get("brownout") or {}
            brownout_stage = max(brownout_stage, int(bo.get("stage", 0) or 0))
            p99 = stats.get("latency_ms_p99")
            if p99 is not None:
                p99s.append(float(p99))
            rejects[url] = self._rejects_in(stz)
        reg_set = set(registered)
        self._statusz_misses = {
            u: c for u, c in self._statusz_misses.items() if u in reg_set
        }
        live_urls = [
            u
            for u in registered
            if self._statusz_misses.get(u, 0)
            < max(1, self.config.statusz_miss_limit)
        ]
        # Reject RATE over the inter-poll window, from per-backend
        # monotonic totals (a drained backend's counter disappearing
        # never counts negative).
        delta = 0
        for url, cur in rejects.items():
            delta += max(0, cur - self._prev_rejects.get(url, cur))
        dt = (
            now - self._prev_reject_t
            if self._prev_reject_t is not None
            else None
        )
        # Merge fresh totals over the old baseline rather than replace
        # it: a backend whose /statusz blipped this sweep keeps its
        # baseline, so rejects accrued during the gap still count when
        # it reappears. Prune only URLs that left the registry.
        self._prev_rejects = {
            u: c for u, c in self._prev_rejects.items() if u in reg_set
        }
        self._prev_rejects.update(rejects)
        self._prev_reject_t = now
        reject_rate = (delta / dt) if dt and dt > 0 else 0.0
        return {
            "now": now,
            "n_live": len(live_urls),
            "n_ready": ready,
            "mean_load": (sum(loads) / len(loads)) if loads else 0.0,
            "reject_rate": reject_rate,
            "brownout_stage": brownout_stage,
            "p99_ms": max(p99s) if p99s else None,
        }

    # -- decisions -------------------------------------------------------

    def step(self) -> None:
        """One control cycle: reap, observe, adjust the target under
        hysteresis + gates, reconcile the pool one action at a time."""
        self._reap()
        obs = self._observe()
        now = obs["now"]
        cfg = self.config
        reason = self._signal_reason(obs)
        overloaded = reason is not None
        idle = (
            obs["mean_load"] <= cfg.load_low
            and obs["reject_rate"] == 0.0
            and obs["brownout_stage"] == 0
        )
        if overloaded:
            self._lo_since = None
            if self._hi_since is None:
                self._hi_since = now
            if now - self._hi_since >= cfg.out_sustain_s:
                self._want(self._target + 1, reason, obs)
        elif idle:
            self._hi_since = None
            if self._lo_since is None:
                self._lo_since = now
            if now - self._lo_since >= cfg.in_sustain_s:
                self._want(self._target - 1, "idle", obs)
        else:
            # Between the watermarks: hysteresis, both clocks restart.
            self._hi_since = None
            self._lo_since = None
        # Reconcile toward the (possibly unchanged) target, one action
        # per cycle. Growth below target without a target change is the
        # self-heal path: a member died and its capacity comes back.
        n = obs["n_live"]
        if n < self._target:
            grow_reason = reason if overloaded else "replace_dead"
            if n < cfg.min_backends:
                grow_reason = "min_backends"
            self._spawn_one(grow_reason)
        elif n > self._target:
            self._shrink_one("idle" if idle else "target")
        with self._lock:
            self._history.append((round(now - self._t0, 3), n))
            if len(self._history) > 100_000:
                del self._history[: len(self._history) - 100_000]
        self._m_pool.set(float(n))
        self._m_target.set(float(self._target))

    def _signal_reason(self, obs: dict) -> Optional[str]:
        cfg = self.config
        if obs["brownout_stage"] >= 1:
            return "brownout"
        if obs["reject_rate"] >= cfg.reject_rate_high:
            return "reject_rate"
        if obs["mean_load"] >= cfg.load_high and obs["n_ready"] > 0:
            return "queue_depth"
        if (
            cfg.p99_high_ms > 0
            and obs["p99_ms"] is not None
            and obs["p99_ms"] >= cfg.p99_high_ms
        ):
            return "p99"
        return None

    def _want(self, target: int, reason: str, obs: dict) -> None:
        """Move the target, or emit an attributed scale_veto for why
        not. Identical consecutive vetoes are logged once."""
        cfg = self.config
        now = obs["now"]
        clamped = max(cfg.min_backends, min(cfg.max_backends, target))
        veto = None
        if clamped == self._target:
            veto = (
                "max_backends" if target > self._target else "min_backends"
            )
        elif now - self._last_action < cfg.cooldown_s:
            veto = "cooldown"
        elif self._flapping(now):
            veto = "flap"
        if veto is not None:
            key = (veto, target)
            if key != self._last_veto:
                self._last_veto = key
                self._m_vetoes.inc()
                self._logger.event(
                    {
                        "event": "scale_veto",
                        "reason": veto,
                        "pool": obs["n_live"],
                        "target": target,
                        "detail": f"signal={reason}",
                    }
                )
            return
        self._last_veto = ("", 0)
        self._target = clamped
        self._last_action = now
        # The sustain clock restarts so the NEXT step needs fresh
        # evidence — one sustained burst buys one step, not a sweep to
        # the bound.
        self._hi_since = None
        self._lo_since = None

    def _flapping(self, now: float) -> bool:
        cutoff = now - self.config.flap_window_s
        self._action_times = [t for t in self._action_times if t >= cutoff]
        return len(self._action_times) >= self.config.flap_max_actions

    # -- actions ---------------------------------------------------------

    def _reap(self) -> None:
        """Drop managed members whose process died (kill -9, OOM) and
        publish their ejection to the registry — standalone (no router
        probing), nothing else would ever clear the stale entry, and a
        stale entry inflates n_live. Reconcile respawns."""
        with self._lock:
            dead = [
                mb
                for mb in self._pool.values()
                if mb.proc.poll() is not None
            ]
            for mb in dead:
                del self._pool[mb.name]
        for mb in dead:  # registry I/O outside the lock
            self._eject_from_registry(mb.url)

    def _eject_from_registry(self, url: str) -> None:
        """Best-effort: mark a member this controller knows is gone as
        ejected, so n_live drops without waiting for the statusz miss
        streak (or an external router's probes)."""
        try:
            self._registry.record(
                url, ejected=True, fails=0, observed_ts=time.time()
            )
        except Exception:
            pass  # the miss-streak liveness still converges
        self._statusz_misses.pop(url, None)

    def _next_slot(self) -> int:
        with self._lock:
            used = {mb.slot for mb in self._pool.values()}
        slot = 0
        while slot in used:
            slot += 1
        return slot

    def _spawn_one(self, reason: str) -> Optional[ManagedBackend]:
        """Spawn one warm backend: ``cli serve-http --warm-buckets
        --registry`` builds the ladder, binds, and only then
        registers — the lead time stamped on the scale_out event is
        decision-to-ready. The slot's journal dir is reused across
        incarnations so drained poll ids re-bind here."""
        cfg = self.config
        if self._flapping(time.perf_counter()):
            return None
        t_decide = time.perf_counter()
        slot = self._next_slot()
        self._gen += 1
        gen = self._gen
        port = _free_port(cfg.host)
        url = f"http://{cfg.host}:{port}"
        jdir = os.path.join(cfg.workdir, f"elastic-be{slot}-journal")
        os.makedirs(jdir, exist_ok=True)
        log_path = os.path.join(
            cfg.workdir, f"elastic-be{slot}-g{gen}.log"
        )
        cmd = [
            sys.executable,
            "-m",
            "distributedlpsolver_tpu_torch.cli",
            "serve-http",
            "--host",
            cfg.host,
            "--port",
            str(port),
            "--journal-dir",
            jdir,
            "--registry",
            cfg.registry_path,
            "--heartbeat-s",
            str(cfg.heartbeat_s),
        ]
        if cfg.buckets_json:
            cmd += ["--buckets", cfg.buckets_json, "--warm-buckets"]
        cmd += list(cfg.backend_flags)
        env = dict(os.environ)
        prior = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = (
            _PKG_ROOT + os.pathsep + prior if prior else _PKG_ROOT
        )
        env.update(cfg.backend_env)
        log_fh = open(log_path, "ab")
        try:
            proc = subprocess.Popen(
                cmd, stdout=log_fh, stderr=subprocess.STDOUT, env=env
            )
        finally:
            log_fh.close()
        mb = ManagedBackend(
            name=f"elastic-{slot}-g{gen}",
            slot=slot,
            url=url,
            port=port,
            proc=proc,
            journal_dir=jdir,
            log_path=log_path,
            spawned_at=t_decide,
            gen=gen,
        )
        deadline = t_decide + cfg.spawn_timeout_s
        ok = False
        while time.perf_counter() < deadline and not self._stop.is_set():
            if proc.poll() is not None:
                break
            h = self._fetch_json(url + "/healthz")
            if h is not None and h.get("status") == "ok":
                ok = True
                break
            time.sleep(0.05)
        if not ok:
            if proc.poll() is None:
                proc.terminate()
            self._logger.event(
                {
                    "event": "scale_veto",
                    "reason": "spawn_failed",
                    "backend": url,
                    "target": self._target,
                    "detail": f"signal={reason}",
                }
            )
            return None
        # A fresh incarnation can land on a URL an earlier one was
        # ejected under (the OS reuses freed ports) and register() never
        # clears an ejection. The controller just fresh-probed /healthz,
        # so publish re-admission the way a router's probe would.
        try:
            self._registry.record(
                url, ejected=False, fails=0, observed_ts=time.time()
            )
        except Exception:
            pass
        self._statusz_misses.pop(url, None)
        lead_ms = round((time.perf_counter() - t_decide) * 1e3, 3)
        self._action_times.append(time.perf_counter())
        self._m_actions.inc()
        event = {
            "event": "scale_out",
            "reason": reason,
            "backend": url,
            "pool": self.pool_size() + 1,
            "target": self._target,
            "ms": lead_ms,
            "pid": proc.pid,
        }
        with self._lock:
            self._pool[mb.name] = mb
            self._actions.append(event)
        self._logger.event(event)
        return mb

    def _pick_victim(self) -> Optional[ManagedBackend]:
        """Least-loaded managed member (ties: youngest). Externally
        registered backends are never drained by this controller."""
        with self._lock:
            members = list(self._pool.values())
        if not members:
            return None
        scored = []
        for mb in members:
            stz = self._fetch_json(mb.url + "/statusz") or {}
            stats = stz.get("stats") or {}
            net = stz.get("net") or {}
            load = int(stats.get("queue_depth", 0) or 0) + int(
                net.get("inflight", 0) or 0
            )
            scored.append((load, -mb.gen, mb))
        scored.sort(key=lambda t: (t[0], t[1]))
        return scored[0][2]

    def _shrink_one(self, reason: str) -> None:
        mb = self._pick_victim()
        if mb is None:
            self._logger.event(
                {
                    "event": "scale_veto",
                    "reason": "no_managed",
                    "pool": self.pool_size(),
                    "target": self._target,
                }
            )
            return
        self._drain_one(mb, reason)

    def _drain_one(self, mb: ManagedBackend, reason: str) -> None:
        """Graceful scale-in: POST /quitquitquit, then wait for the
        process to exit on its own (it does, once every admitted
        request has a verdict and the listener closed). Outstanding
        async polls resolve through the router fan-out the whole time.
        A drain that outlives the timeout escalates to terminate."""
        t0 = time.perf_counter()
        drained = False
        try:
            req = urllib.request.Request(
                mb.url + "/quitquitquit", data=b"", method="POST"
            )
            with urllib.request.urlopen(req, timeout=5.0):
                pass
        except (urllib.error.URLError, socket.timeout, OSError):
            pass  # already dead or deaf — the wait below settles it
        deadline = t0 + self.config.drain_timeout_s
        while time.perf_counter() < deadline:
            if mb.proc.poll() is not None:
                drained = True
                break
            time.sleep(0.05)
        if not drained and mb.proc.poll() is None:
            mb.proc.terminate()
        # The drained incarnation never unregisters itself: publish its
        # ejection so the next sweep's n_live drops immediately instead
        # of reconcile draining ANOTHER healthy member against a stale
        # count.
        self._eject_from_registry(mb.url)
        self._action_times.append(time.perf_counter())
        self._m_actions.inc()
        event = {
            "event": "scale_in",
            "reason": reason,
            "backend": mb.url,
            "pool": max(0, self.pool_size() - 1),
            "target": self._target,
            "ms": round((time.perf_counter() - t0) * 1e3, 3),
            "drained": drained,
        }
        with self._lock:
            self._pool.pop(mb.name, None)
            self._actions.append(event)
        self._logger.event(event)

    # -- introspection ---------------------------------------------------

    def pool_size(self) -> int:
        with self._lock:
            return len(self._pool)

    def target(self) -> int:
        return self._target

    def history(self) -> List[Tuple[float, int]]:
        """(t_rel_s, observed pool size) per control cycle — the
        trajectory bench --elastic records."""
        with self._lock:
            return list(self._history)

    def actions(self) -> List[dict]:
        with self._lock:
            return list(self._actions)

    def statusz(self) -> dict:
        with self._lock:
            return {
                "target": self._target,
                "pool": [
                    {
                        "name": mb.name,
                        "url": mb.url,
                        "pid": mb.proc.pid,
                        "slot": mb.slot,
                        "gen": mb.gen,
                        "journal_dir": mb.journal_dir,
                    }
                    for mb in self._pool.values()
                ],
                "actions": len(self._actions),
            }
