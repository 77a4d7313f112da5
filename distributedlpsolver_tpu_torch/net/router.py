"""Router tier: one front process over N backend serving processes
(README "Network serving").

The router holds a live registry of backend base URLs. A poll thread
health-checks each backend (``GET /healthz``) and refreshes its
``/statusz`` snapshot — the advertised bucket ladder and queue depth
that drive routing:

- **shape-aware pick**: a request whose (m, n) is visible (JSON
  envelope or query hints — :func:`net.protocol.peek_route_hint`) is
  scored against each backend's advertised ladder: the padding
  fraction the tightest fitting bucket would waste on it. A backend
  already serving that shape wastes less than one that would open a
  fresh pow2 bucket (and a fresh program build).
- **load-aware tie-break**: equal padding scores break on polled queue
  depth + live HTTP inflight, then round-robin.
- **health-checked failover**: ``eject_after`` consecutive failed
  probes (or one failed forward — a dead socket is better evidence
  than a stale 200) ejects a backend from rotation; the poll thread
  keeps probing ejected backends and re-admits on recovery. Forwards
  that die on a transport error, or come back 502/503/504 WITHOUT the
  backend's ``X-DLPS-Plane`` header, are retried ONCE on the next-best
  backend — retry-once keeps a dead backend's in-flight requests alive
  without letting a poisoned request storm every backend. A 504/503
  that DOES carry the header is the backend talking (a solver TIMEOUT
  verdict, a graceful shutdown — normal SLO outcomes, not failover
  evidence) and passes through to the client without ejecting the
  backend: under a deadline storm, ejecting on those would empty the
  whole rotation and duplicate every shed solve elsewhere.

Tail tolerance (README "Tail tolerance"):

- **deadline propagation**: a request carrying ``deadline_ms`` is
  forwarded with the ``X-DLPS-Deadline-Ms`` header holding the
  REMAINING budget (original minus elapsed at this router), and every
  retry/hedge re-stamps body and header with what is left — a hop can
  consume budget but never resurrect it. Backends admission-reject
  expired-on-arrival work with a structured timeout verdict.
- **adaptive hedging**: per-backend latency digests over completed
  forwards set a hedge delay (clamped p95); when the primary forward
  of a ``POST /v1/solve`` is silent past it, ONE hedge goes to the
  next-best backend and the first acceptable response wins. Safe
  because journal fingerprint dedup makes duplicate submits attach to
  one solve, and the losing leg's acknowledged-but-queued work is
  cancelled (``POST /v1/cancel/{jid}``). A global hedge-rate cap and a
  per-tenant retry-budget token bucket bound the speculative load:
  budget-exhausted or cap-hit → no hedge, attributed event. Hedges
  compose with breaker/readiness state (an open breaker or draining
  backend is never a hedge target), and a stamped 429 (browned-out
  backend shedding) never wins a hedge — backpressure is not raced.

Everything is stdlib: ``urllib.request`` for forwarding,
``http.server`` for the front. Async-poll ids are backend-local, so
``GET /v1/solve/{id}`` consults the router's bounded id → backend map
remembered from each 202 response.
"""

from __future__ import annotations

import dataclasses
import json
import queue as queue_mod
import socket
import threading
import time
import urllib.error
import urllib.request
import zlib
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlsplit

from distributedlpsolver_tpu_torch.net import protocol
from distributedlpsolver_tpu_torch.net.server import PlaneHTTPServer
from distributedlpsolver_tpu_torch.obs import context as obs_context
from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics
from distributedlpsolver_tpu_torch.obs import trace as obs_trace
from distributedlpsolver_tpu_torch.obs.stats import percentile
from distributedlpsolver_tpu_torch.utils.logging import IterLogger


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    host: str = "127.0.0.1"
    port: int = 0  # 0 = ephemeral
    # Backend poll cadence (healthz + statusz refresh).
    poll_s: float = 1.0
    # Consecutive failed health probes before a backend is ejected.
    eject_after: int = 2
    # Timeouts: health/status probes are fast-path; forwards must
    # outlive a backend's own solve wait.
    probe_timeout_s: float = 2.0
    forward_timeout_s: float = 300.0
    # Bounded async id -> backend map (oldest evicted past the cap).
    async_map_cap: int = 4096
    # route/eject JSONL event stream (stamped schema); None = off.
    log_jsonl: Optional[str] = None
    # Shared backend registry (net/registry.py): N routers pointed at
    # the same file share one consistent view of backends, ejections
    # and re-admissions — an ejection observed by one router is honored
    # by all, and a restarted router warm-loads the table instead of
    # starting blind. None = classic single-router, in-memory only.
    registry_path: Optional[str] = None
    # Single-writer lease duration on the registry file.
    registry_lease_s: float = 5.0
    # Ejected backends are re-probed with exponential backoff (base
    # doubling per consecutive failure, deterministic jitter) instead
    # of every poll tick, capped at the ceiling — a dead backend isn't
    # hammered, a flapping one can't oscillate the registry each tick.
    probe_backoff_base_s: float = 0.5
    probe_backoff_cap_s: float = 30.0
    # Heartbeat TTL over registry entries that REGISTERED themselves
    # (cli serve-slice stamps last_heartbeat_ts every beat): an entry
    # whose heartbeat is older than this leaves rotation as an ejection
    # (counted in registry_expired_total) even if no probe has failed
    # yet — the deterministic exit for a kill -9'd slice. 0 disables;
    # entries that never heartbeat are exempt either way. Aging is
    # measured on OBSERVER-LOCAL receipt time of each beat, never on
    # the serving host's wall-clock stamp — cross-host clock skew can't
    # mass-eject a healthy pool.
    registry_ttl_s: float = 0.0
    # Per-backend circuit breaker over FORWARD outcomes. Probes have
    # their own eject/backoff machinery, but a successful probe resets
    # it — so a backend whose /healthz answers while its forwards keep
    # dying flaps in and out of rotation, eating the retry-once budget
    # of one live request per flap. The breaker remembers across probe
    # re-admissions: closed → open when the error rate over the recent
    # forward window crosses the threshold, open → half-open after a
    # hold that doubles per consecutive trip (same deterministic-jitter
    # shape as the probe backoff), half-open admits exactly ONE trial
    # forward — success closes, failure re-opens with a longer hold.
    breaker_window: int = 8
    breaker_min_samples: int = 4
    breaker_error_rate: float = 0.5
    breaker_hold_base_s: float = 1.0
    breaker_hold_cap_s: float = 30.0
    breaker_enabled: bool = True
    # Adaptive hedged requests (POST /v1/solve only): when the primary
    # forward is silent past the hedge delay — the backend's recent p95
    # forward latency, clamped to [min, max] ms with deterministic
    # jitter — ONE hedge goes to the next-best backend; first acceptable
    # response wins. A backend with fewer than hedge_min_samples
    # completed forwards has no digest and never triggers a hedge
    # (measure, don't guess).
    hedge_enabled: bool = True
    hedge_delay_min_ms: float = 50.0
    hedge_delay_max_ms: float = 2000.0
    hedge_min_samples: int = 8
    # Global cap: launched hedges may never exceed this fraction of all
    # forwards — speculative load is bounded even when every backend
    # looks slow (which under overload is exactly when hedging would
    # amplify the problem).
    hedge_rate_cap: float = 0.05
    # Per-tenant retry-budget token bucket (tokens/s, burst cap),
    # charged one token per retry AND per hedge. Retries always proceed
    # — retry-once is the plane's no-lost-acks mechanism — but they
    # DRAIN the bucket, so under a retry storm the speculative hedges
    # are what stop first; an exhausted bucket suppresses hedging with
    # an attributed event. Bounded latency-sample window per backend.
    retry_budget_rate: float = 5.0
    retry_budget_burst: float = 20.0
    latency_window: int = 64
    # Stamp/decrement X-DLPS-Deadline-Ms on every forward hop of a
    # request that carries deadline_ms (and re-stamp the body's own
    # field with the remaining budget on retries/hedges).
    deadline_propagation: bool = True


@dataclasses.dataclass
class BackendState:
    """One backend's live registry entry (all fields guarded by the
    router lock; the poll thread writes, handler threads read)."""

    url: str
    healthy: bool = False
    ejected: bool = False
    fails: int = 0
    probes: int = 0
    queue_depth: int = 0
    inflight: int = 0
    buckets: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list
    )
    last_poll: float = 0.0
    forwards: int = 0
    # When the backend was last ejected (perf_counter). A health probe
    # that STARTED before this moment is stale evidence — a poll in
    # flight across a crash reads the old process's last 200 and must
    # not bounce the dead backend back into rotation.
    ejected_at: float = 0.0
    # Forwards this router currently has in flight toward the backend —
    # the LIVE half of the load signal. Polled queue_depth/inflight are
    # up to poll_s stale, and a stale snapshot makes every pick in a
    # poll window herd onto the same "least loaded" backend; the live
    # count moves with each forward and spreads them.
    live: int = 0
    # Readiness (GET /readyz): a draining backend is healthy-but-not-
    # ready — it leaves rotation without eject/failover storms and
    # returns when ready again.
    ready: bool = True
    # Wall-clock stamps of the last state observation and ejection —
    # the merge keys the shared registry's stale-writer guard compares
    # across router processes (perf_counter doesn't cross processes).
    observed_ts: float = 0.0
    ejected_at_ts: float = 0.0
    # Probe backoff while ejected: current wait and the perf_counter
    # moment the next probe is allowed.
    backoff_s: float = 0.0
    next_probe: float = 0.0
    # Last heartbeat the serving process itself wrote into the shared
    # registry (0 = this backend never registered/heartbeat — exempt
    # from TTL ejection). REMOTE wall clock, adopted on registry pulls;
    # used only as a monotonicity key ("is this beat newer than the
    # last one I saw"), never compared against the local clock.
    last_heartbeat_ts: float = 0.0
    # Observer-local (perf_counter) moment a NEWER heartbeat stamp was
    # adopted — the clock TTL aging actually runs on. A serving host
    # whose wall clock is hours off still refreshes this on every beat,
    # so skew can't mass-eject a healthy pool; a dead host stops
    # producing newer stamps and ages out exactly at the TTL.
    hb_rx: float = 0.0
    # Circuit breaker (see RouterConfig.breaker_*): state machine over
    # forward outcomes, orthogonal to probe-driven eject/readmit.
    breaker: str = "closed"  # closed | open | half_open
    outcomes: List[bool] = dataclasses.field(default_factory=list)
    breaker_trips: int = 0  # lifetime opens (stats)
    breaker_streak: int = 0  # consecutive opens without sustained close
    breaker_until: float = 0.0  # perf_counter when open may half-open
    breaker_hold_s: float = 0.0
    breaker_probe_live: bool = False  # the single half-open trial
    breaker_closed_at: float = 0.0  # perf_counter of the last close
    # Bounded streaming latency digest (ms) over completed stamped
    # forwards — drives the adaptive hedge delay (p50/p95 in statusz).
    lat_ms: List[float] = dataclasses.field(default_factory=list)


class Router:
    """Backend registry + routing policy + poll loop (no HTTP surface
    of its own — :class:`RouterHTTPServer` puts one in front)."""

    def __init__(
        self,
        backends: List[str],
        config: Optional[RouterConfig] = None,
        metrics: Optional[obs_metrics.MetricsRegistry] = None,
    ):
        self.config = config or RouterConfig()
        self.metrics = (
            metrics if metrics is not None else obs_metrics.get_registry()
        )
        self._lock = threading.Lock()
        self._backends: Dict[str, BackendState] = OrderedDict(  # guarded-by: _lock
            (u.rstrip("/"), BackendState(url=u.rstrip("/"))) for u in backends
        )
        self._rr = 0  # round-robin tie-break cursor; guarded-by: _lock
        self._failovers = 0  # guarded-by: _lock
        self._async_map: OrderedDict = OrderedDict()  # id -> url; guarded-by: _lock
        self._logger = IterLogger(
            verbose=False, jsonl_path=self.config.log_jsonl
        )
        m = self.metrics
        self._m_healthy: Dict[str, object] = {}  # guarded-by: _lock
        self._m_routed: Dict[str, object] = {}  # guarded-by: _lock
        self._m_backoff: Dict[str, object] = {}  # guarded-by: _lock
        self._m_failovers = m.counter(
            "router_failovers_total",
            help="forwards retried on another backend after a failure",
        )
        self._m_breaker: Dict[str, object] = {}  # guarded-by: _lock
        self._m_breaker_trips = m.counter(
            "router_breaker_opens_total",
            help="circuit-breaker trips (closed/half-open -> open)",
        )
        # Tail tolerance: hedge accounting and the per-tenant retry
        # budget. Hedge outcome counters are label-keyed and lazily
        # created; the tenant bucket table is bounded (client strings).
        self._m_hedges: Dict[str, object] = {}  # outcome -> counter; guarded-by: _lock
        self._m_hedge_delay = m.histogram(
            "router_hedge_delay_ms",
            help="hedge delay used when a hedge was launched",
        )
        self._m_budget_exhausted = m.counter(
            "retry_budget_exhausted_total",
            help="retries/hedges that found the tenant's retry-budget "
            "bucket empty (hedges are suppressed; retries proceed but "
            "drain the bucket)",
        )
        self._forwards_total = 0  # guarded-by: _lock
        self._hedges_launched = 0  # guarded-by: _lock
        self._hedge_outcomes: Dict[str, int] = {}  # guarded-by: _lock
        self._hedge_cancels = 0  # loser-cancel POSTs issued; guarded-by: _lock
        self._budget_exhausted = 0  # guarded-by: _lock
        # tenant -> (tokens, t_refill); bounded LRU over client strings.
        self._retry_tokens: OrderedDict = OrderedDict()  # guarded-by: _lock
        # Shared registry: warm-load the table a sibling (or our own
        # previous incarnation) built instead of starting blind, then
        # contribute our configured backends.
        if self.config.registry_path:
            from distributedlpsolver_tpu_torch.net.registry import BackendRegistry

            self._registry: Optional[object] = BackendRegistry(
                self.config.registry_path,
                lease_s=self.config.registry_lease_s,
                metrics=m,
                logger=self._logger,
            )
            self._registry_version = 0
            self._registry.ensure(list(self._backends))
            self._sync_registry_pull()
        else:
            self._registry = None
            self._registry_version = 0
        if not self._backends and self._registry is None:
            # With a shared registry the table may legitimately start
            # empty: slices self-register as they come up (cli
            # serve-slice) and the pull adopts them — zero manual
            # backend config is the multi-host contract.
            raise ValueError(
                "router needs at least one backend URL (from the "
                "constructor or the shared registry)"
            )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "Router":
        if self._thread is None:
            self.poll_once()  # synchronous first sweep: route() works now
            self._thread = threading.Thread(
                target=self._poll_loop, daemon=True, name="dlps-router-poll"
            )
            self._thread.start()
        return self

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self._logger.close()

    # -- polling ---------------------------------------------------------

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.config.poll_s):
            try:
                self.poll_once()
            except Exception:  # the poll thread must survive anything
                pass

    def _fetch_json(self, url: str) -> Optional[dict]:
        try:
            with urllib.request.urlopen(
                url, timeout=self.config.probe_timeout_s
            ) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            # A well-formed error response (healthz 503) still carries
            # a JSON body worth reading; transport-level errors don't.
            try:
                return json.loads(e.read().decode("utf-8"))
            except Exception:
                return None
        except (urllib.error.URLError, socket.timeout, OSError, ValueError):
            return None

    def poll_once(self) -> None:
        """One sweep: pull sibling routers' registry observations, then
        probe every due backend's /healthz (ejected ones included —
        that is the re-admission path, paced by their backoff window)
        + /readyz, and refresh /statusz for the healthy ones."""
        self._sync_registry_pull()
        self._expire_stale_heartbeats()
        now = time.perf_counter()
        with self._lock:
            urls = [
                u
                for u, st in self._backends.items()
                # Exponential probe backoff: an ejected backend is only
                # re-probed once its window elapses.
                if not (st.ejected and now < st.next_probe)
            ]
        for url in urls:
            t_start = time.perf_counter()
            h = self._fetch_json(url + "/healthz")
            ok = bool(h) and h.get("status") == "ok"
            ready = True
            stz = None
            if ok:
                # Readiness is a separate axis: 503 here means
                # "draining — stop routing", never failure evidence.
                # Legacy backends without /readyz fall back to the
                # healthz draining field (absent = ready).
                r = self._fetch_json(url + "/readyz")
                if r is not None and "status" in r:
                    ready = r.get("status") == "ready"
                else:
                    ready = not bool(h.get("draining", False))
                stz = self._fetch_json(url + "/statusz")
            self._record_probe(url, ok, stz, t_start, ready=ready)

    def _expire_stale_heartbeats(self) -> None:
        """Heartbeat-TTL ejection (the registry's liveness rule): a backend whose
        serving process registered itself but whose last heartbeat is
        older than ``registry_ttl_s`` leaves rotation NOW — kill -9'd
        slices exit deterministically at the TTL instead of whenever
        ``eject_after`` probes happen to have failed. Runs on the
        CACHED heartbeat stamps: a dead slice stops moving the registry
        version, so the pull path alone would never re-examine it.

        Aging compares the OBSERVER-LOCAL receipt time of the newest
        adopted beat (``hb_rx``, our perf_counter) against our own
        clock — never the serving host's wall-clock stamp against local
        ``time.time()``. The remote stamp is only a monotonicity key;
        a host with hours of clock skew keeps refreshing ``hb_rx`` on
        every beat and stays in rotation, while a dead host stops
        producing newer stamps and ages out at exactly the TTL."""
        ttl = self.config.registry_ttl_s
        if ttl <= 0:
            return
        now_wall = time.time()
        now_mono = time.perf_counter()
        expired = []
        with self._lock:
            for url, st in self._backends.items():
                if (
                    st.ejected
                    or st.last_heartbeat_ts <= 0.0
                    or st.hb_rx <= 0.0
                ):
                    continue
                if now_mono - st.hb_rx <= ttl:
                    continue
                st.fails += 1
                st.healthy = False
                st.ejected = True
                st.ejected_at = time.perf_counter()
                st.ejected_at_ts = now_wall
                st.observed_ts = now_wall
                self._bump_backoff(st, time.perf_counter())
                self._gauge_for(url).set(0.0)
                expired.append((url, self._snapshot_for_registry(st)))
        if expired:
            self.metrics.counter(
                "registry_expired_total",
                help="backends ejected because their registry heartbeat "
                "aged past registry_ttl_s",
            ).inc(len(expired))
        for url, push in expired:
            self._logger.event(
                {
                    "event": "backend_ejected",
                    "backend": url,
                    "reason": "heartbeat_ttl",
                }
            )
            self._registry_push(push)

    # -- shared-registry sync ---------------------------------------------

    def _sync_registry_pull(self) -> None:
        """Adopt newer observations from the shared registry: backends
        a sibling discovered, ejections it observed (honored here even
        though our own probes still said 200), and re-admissions. Only
        runs a real load when the file version moved."""
        if self._registry is None:
            return
        ver = self._registry.version()
        if ver == self._registry_version:
            return
        data = self._registry.load()
        self._registry_version = ver
        now = time.perf_counter()
        with self._lock:
            for url, entry in data.get("backends", {}).items():
                st = self._backends.get(url)
                if st is None:
                    st = BackendState(url=url)
                    self._backends[url] = st
                # Heartbeats are liveness, not eject-state observations:
                # adopt the freshest stamp unconditionally (the serving
                # process writes it; no router ever competes on it).
                # The remote stamp is a monotonicity key only; TTL
                # aging runs on hb_rx — OUR receipt time of the newer
                # beat — so cross-host clock skew never ejects anyone.
                hb = float(entry.get("last_heartbeat_ts", 0.0))
                if hb > st.last_heartbeat_ts:
                    st.last_heartbeat_ts = hb
                    st.hb_rx = now
                obs = float(entry.get("observed_ts", 0.0))
                if obs <= st.observed_ts:
                    continue  # our own view is as fresh or fresher
                ejected = bool(entry.get("ejected", False))
                if ejected and not st.ejected:
                    st.ejected = True
                    st.healthy = False
                    # Stamp the LOCAL clock too: an in-flight probe of
                    # ours that started before adoption is stale
                    # evidence, exactly like a local ejection.
                    st.ejected_at = now
                elif not ejected and st.ejected:
                    st.ejected = False
                    st.backoff_s = 0.0
                    st.next_probe = 0.0
                    # healthy stays False until our own probe confirms.
                st.fails = int(entry.get("fails", st.fails))
                st.ejected_at_ts = float(
                    entry.get("ejected_at_ts", st.ejected_at_ts)
                )
                st.observed_ts = obs

    def _registry_push(self, st_snapshot: dict) -> None:
        """Publish one observed transition (values snapshotted under
        the router lock; the registry does its own file locking)."""
        if self._registry is None:
            return
        self._registry.record(
            st_snapshot["url"],
            ejected=st_snapshot["ejected"],
            fails=st_snapshot["fails"],
            observed_ts=st_snapshot["observed_ts"],
            ejected_at_ts=st_snapshot["ejected_at_ts"],
        )

    def _gauge_for(self, url: str):  # holds: _lock
        g = self._m_healthy.get(url)
        if g is None:
            g = self.metrics.gauge(
                "router_backend_healthy",
                labels={"backend": url},
                help="1 = in rotation, 0 = ejected/unhealthy",
            )
            self._m_healthy[url] = g
        return g

    def _backoff_gauge(self, url: str):  # holds: _lock
        g = self._m_backoff.get(url)
        if g is None:
            g = self.metrics.gauge(
                "router_probe_backoff_s",
                labels={"backend": url},
                help="current re-probe backoff of an ejected backend",
            )
            self._m_backoff[url] = g
        return g

    def _bump_backoff(self, st: BackendState, now: float) -> None:  # holds: _lock
        """Exponential backoff with deterministic jitter for the next
        re-probe of an ejected backend: doubles per consecutive failed
        probe, jittered ±25% by a hash of (url, fails) — deterministic,
        so a seeded chaos run replays exactly, but de-phased across
        backends so re-probes don't synchronize."""
        import zlib

        base = self.config.probe_backoff_base_s
        cap = self.config.probe_backoff_cap_s
        raw = min(cap, base * (2.0 ** max(0, st.fails - self.config.eject_after)))
        frac = (
            zlib.crc32(f"{st.url}:{st.fails}".encode("utf-8")) % 1000
        ) / 1000.0
        st.backoff_s = min(cap, raw * (0.75 + 0.5 * frac))
        st.next_probe = now + st.backoff_s
        self._backoff_gauge(st.url).set(st.backoff_s)

    def _record_probe(
        self, url: str, ok: bool, statusz: Optional[dict],
        t_start: float = 0.0, ready: bool = True,
    ) -> None:
        ejected = readmitted = False
        push = None
        with self._lock:
            st = self._backends.get(url)
            if st is None:
                return
            st.probes += 1
            st.last_poll = time.perf_counter()
            if ok:
                if st.ejected and t_start <= st.ejected_at:
                    # Stale success: the probe began before the
                    # ejection landed (poll racing a crash/forward
                    # failure). Keep the ejection; a probe started
                    # AFTER it is the real recovery signal.
                    return
                st.fails = 0
                if st.ejected:
                    st.ejected = False
                    readmitted = True
                st.healthy = True
                st.ready = ready
                st.backoff_s = 0.0
                st.next_probe = 0.0
                self._backoff_gauge(url).set(0.0)
                st.observed_ts = time.time()
                if statusz:
                    stats = statusz.get("stats") or {}
                    st.queue_depth = int(stats.get("queue_depth", 0) or 0)
                    net = statusz.get("net") or {}
                    st.inflight = int(net.get("inflight", 0) or 0)
                    st.buckets = [
                        tuple(b) for b in (stats.get("buckets") or [])
                    ]
                if readmitted:
                    push = self._snapshot_for_registry(st)
            else:
                st.fails += 1
                st.healthy = False
                if not st.ejected and st.fails >= self.config.eject_after:
                    st.ejected = True
                    st.ejected_at = time.perf_counter()
                    st.ejected_at_ts = time.time()
                    ejected = True
                st.observed_ts = time.time()
                if st.ejected:
                    self._bump_backoff(st, time.perf_counter())
                if ejected:
                    push = self._snapshot_for_registry(st)
            fails = st.fails
            self._gauge_for(url).set(1.0 if ok else 0.0)
        if ejected:
            self._logger.event(
                {"event": "backend_ejected", "backend": url, "fails": fails}
            )
        if readmitted:
            self._logger.event(
                {"event": "backend_readmitted", "backend": url}
            )
        if push is not None:
            self._registry_push(push)

    @staticmethod
    def _snapshot_for_registry(st: BackendState) -> dict:  # holds: _lock
        return {
            "url": st.url,
            "ejected": st.ejected,
            "fails": st.fails,
            "observed_ts": st.observed_ts,
            "ejected_at_ts": st.ejected_at_ts,
        }

    def _note_forward_failure(self, url: str) -> None:
        """A forward died on ``url``: a dead socket is better evidence
        than the last 200 probe, so eject immediately — the poll thread
        re-admits when /healthz recovers."""
        with self._lock:
            st = self._backends.get(url)
            if st is None:
                return
            st.fails += 1
            st.healthy = False
            already = st.ejected
            st.ejected = True
            st.ejected_at = time.perf_counter()
            st.ejected_at_ts = time.time()
            st.observed_ts = time.time()
            self._bump_backoff(st, time.perf_counter())
            fails = st.fails
            push = self._snapshot_for_registry(st)
            self._gauge_for(url).set(0.0)
        if not already:
            self._logger.event(
                {"event": "backend_ejected", "backend": url, "fails": fails}
            )
        self._registry_push(push)

    # -- circuit breaker -------------------------------------------------

    def _breaker_gauge(self, url: str):  # holds: _lock
        g = self._m_breaker.get(url)
        if g is None:
            g = self.metrics.gauge(
                "router_breaker_open",
                labels={"backend": url},
                help="1 = breaker open/half-open (out of normal rotation)",
            )
            self._m_breaker[url] = g
        return g

    def _breaker_trip(self, st: BackendState, now: float) -> None:  # holds: _lock
        """Open the breaker on ``st``: hold doubles per consecutive
        trip (a close that didn't stick — within two hold-caps of the
        re-open — escalates; a long quiet close resets the streak),
        jittered deterministically like the probe backoff so trips
        don't re-probe in phase across backends."""
        import zlib

        if st.breaker_closed_at and (
            now - st.breaker_closed_at < 2.0 * self.config.breaker_hold_cap_s
        ):
            st.breaker_streak += 1
        else:
            st.breaker_streak = 1
        st.breaker = "open"
        st.breaker_trips += 1
        base = self.config.breaker_hold_base_s
        cap = self.config.breaker_hold_cap_s
        raw = min(cap, base * (2.0 ** max(0, st.breaker_streak - 1)))
        frac = (
            zlib.crc32(
                f"breaker:{st.url}:{st.breaker_trips}".encode("utf-8")
            )
            % 1000
        ) / 1000.0
        st.breaker_hold_s = min(cap, raw * (0.75 + 0.5 * frac))
        st.breaker_until = now + st.breaker_hold_s
        st.breaker_probe_live = False
        st.outcomes.clear()
        self._breaker_gauge(st.url).set(1.0)

    def _record_forward_outcome(
        self, url: str, ok: bool, trial: Optional[bool] = None
    ) -> None:
        """Feed one forward outcome (ok = the backend answered with a
        stamped response; not-ok = transport death or an unstamped
        gateway code) into the backend's breaker window. Draining
        responses are routed around and never recorded. ``trial`` says
        whether THIS forward was the admitted half-open trial (stamped
        by pick() at route time): only the trial's outcome may resolve
        a half-open breaker — a slow forward dispatched before the trip
        must not close it the moment the hold elapses. None = unknown
        attribution (direct callers); falls back to the probe-live
        flag."""
        if not self.config.breaker_enabled:
            return
        event = None
        now = time.perf_counter()
        with self._lock:
            st = self._backends.get(url)
            if st is None:
                return
            if st.breaker == "half_open":
                if trial is False or (
                    trial is None and not st.breaker_probe_live
                ):
                    # Outcome of a forward dispatched before the trip
                    # — stale evidence, ignored like the open state.
                    return
                # The single trial came back: close on success, re-open
                # with an escalated hold on failure.
                st.breaker_probe_live = False
                if ok:
                    st.breaker = "closed"
                    st.breaker_closed_at = now
                    st.outcomes.clear()
                    self._breaker_gauge(url).set(0.0)
                    event = {"event": "breaker_close", "backend": url}
                else:
                    self._breaker_trip(st, now)
                    event = {
                        "event": "breaker_open",
                        "backend": url,
                        "error_rate": 1.0,
                        "backoff_s": round(st.breaker_hold_s, 3),
                        "reason": "half_open_trial_failed",
                    }
                    self._m_breaker_trips.inc()
            elif st.breaker == "closed":
                st.outcomes.append(ok)
                if len(st.outcomes) > self.config.breaker_window:
                    del st.outcomes[
                        : len(st.outcomes) - self.config.breaker_window
                    ]
                n = len(st.outcomes)
                errs = n - sum(st.outcomes)
                if (
                    n >= self.config.breaker_min_samples
                    and errs / n >= self.config.breaker_error_rate
                ):
                    rate = errs / n
                    self._breaker_trip(st, now)
                    event = {
                        "event": "breaker_open",
                        "backend": url,
                        "error_rate": round(rate, 3),
                        "backoff_s": round(st.breaker_hold_s, 3),
                        "reason": "error_rate",
                    }
                    self._m_breaker_trips.inc()
            # breaker == "open": pick() never routes here, so the only
            # forwards that can still land are ones already in flight
            # when it tripped — stale evidence, ignored.
        if event is not None:
            self._logger.event(event)

    def _note_draining(self, url: str, trial: bool = False) -> None:
        """A forward came back with a backend-stamped draining 503: the
        backend is alive but shutting down — take it out of rotation
        (ready=False) without ejection or failure accounting; the poll
        loop re-admits it the moment /readyz recovers. When the forward
        was the half-open breaker trial, release the trial slot: a
        draining verdict resolves neither way, and a live probe flag
        with no forward behind it would pin the backend out of rotation
        forever (even across a restart on the same URL)."""
        with self._lock:
            st = self._backends.get(url)
            if st is not None:
                st.ready = False
                if trial and st.breaker == "half_open":
                    st.breaker_probe_live = False

    # -- tail tolerance: latency digest, hedge delay, retry budget -------

    def _observe_latency(self, url: str, ms: float) -> None:
        """Feed one completed stamped forward's wall into the backend's
        bounded latency digest (the hedge delay's input)."""
        with self._lock:
            st = self._backends.get(url)
            if st is None:
                return
            st.lat_ms.append(ms)
            if len(st.lat_ms) > self.config.latency_window:
                del st.lat_ms[: len(st.lat_ms) - self.config.latency_window]

    def _hedge_delay_s(self, url: str) -> Optional[float]:
        """Adaptive hedge delay for a forward to ``url``: the backend's
        recent p95 forward latency clamped to [min, max] ms, with the
        same deterministic ±25% jitter shape as the probe backoff (keyed
        by the backend and its forward count, so a seeded chaos run
        replays exactly but hedges de-phase across backends). None =
        hedging disabled or the digest is under-sampled — the router
        never guesses a delay it has not measured."""
        if not self.config.hedge_enabled:
            return None
        with self._lock:
            st = self._backends.get(url)
            if st is None or len(st.lat_ms) < self.config.hedge_min_samples:
                return None
            samples = list(st.lat_ms)
            n_fwd = st.forwards
        p95 = percentile(samples, 95)
        lo = self.config.hedge_delay_min_ms
        hi = self.config.hedge_delay_max_ms
        raw = min(max(p95, lo), hi)
        frac = (
            zlib.crc32(f"hedge:{url}:{n_fwd}".encode("utf-8")) % 1000
        ) / 1000.0
        return min(hi, raw * (0.75 + 0.5 * frac)) / 1e3

    def _spend_retry_budget(self, tenant: str, kind: str) -> bool:
        """Charge one token from ``tenant``'s retry-budget bucket for a
        retry or a hedge. Returns whether the spend was FUNDED. Retries
        proceed either way (retry-once is the plane's no-lost-acks
        mechanism) but drain the bucket to its floor, so under a retry
        storm the speculative hedges stop first; an unfunded hedge is
        suppressed by the caller. Unfunded spends count into
        retry_budget_exhausted_total with an attributed event."""
        cfg = self.config
        now = time.perf_counter()
        event = None
        with self._lock:
            tokens, t_refill = self._retry_tokens.get(
                tenant, (cfg.retry_budget_burst, now)
            )
            tokens = min(
                cfg.retry_budget_burst,
                tokens + (now - t_refill) * cfg.retry_budget_rate,
            )
            funded = tokens >= 1.0
            if funded:
                tokens -= 1.0
            self._retry_tokens[tenant] = (tokens, now)
            self._retry_tokens.move_to_end(tenant)
            while len(self._retry_tokens) > 256:  # bounded client strings
                self._retry_tokens.popitem(last=False)
            if not funded:
                self._budget_exhausted += 1
                event = {
                    "event": "retry_budget",
                    "tenant": tenant,
                    "kind": kind,
                    "reason": "exhausted",
                }
        if event is not None:
            self._m_budget_exhausted.inc()
            self._logger.event(event)
        return funded

    def _refund_retry_token(self, tenant: str) -> None:
        """Return a token spent on a hedge that never launched (no
        second eligible backend) — suppression must not charge."""
        cfg = self.config
        with self._lock:
            tokens, t_refill = self._retry_tokens.get(tenant, (0.0, 0.0))
            self._retry_tokens[tenant] = (
                min(cfg.retry_budget_burst, tokens + 1.0),
                t_refill,
            )

    def _count_hedge(self, outcome: str) -> None:
        """router_hedges_total{outcome} + the statusz tally. Outcomes:
        hedge_won / primary_won / both_failed for launched hedges;
        suppressed_cap / suppressed_budget / suppressed_no_backend for
        hedges the policy refused — counted so the rate cap and budget
        are auditable against events."""
        with self._lock:
            self._hedge_outcomes[outcome] = (
                self._hedge_outcomes.get(outcome, 0) + 1
            )
            ctr = self._m_hedges.get(outcome)
            if ctr is None:
                ctr = self.metrics.counter(
                    "router_hedges_total",
                    labels={"outcome": outcome},
                    help="hedge decisions by outcome (launched hedges "
                    "resolve to hedge_won/primary_won/both_failed; "
                    "suppressed_* are policy refusals)",
                )
                self._m_hedges[outcome] = ctr
        ctr.inc()

    def _hedge_pick(
        self,
        hint: Optional[Tuple[int, int, float]],
        exclude: Tuple[str, ...],
        tenant: str,
    ) -> Tuple[Optional[str], bool]:
        """(url, is_trial) for the single hedge of one forward, or
        (None, False) when hedging is suppressed: the global rate cap
        is hit, the tenant's retry budget is exhausted, or no second
        eligible backend exists (breaker-open, draining, and ejected
        backends are already out of _pick_attributed's rotation — a
        hedge never lands on one)."""
        with self._lock:
            capped = (self._hedges_launched + 1) > (
                self.config.hedge_rate_cap * max(1, self._forwards_total)
            )
        if capped:
            self._count_hedge("suppressed_cap")
            return None, False
        if not self._spend_retry_budget(tenant, "hedge"):
            self._count_hedge("suppressed_budget")
            return None, False
        url, is_trial = self._pick_attributed(hint, exclude=exclude)
        if url is None:
            self._refund_retry_token(tenant)
            self._count_hedge("suppressed_no_backend")
            return None, False
        with self._lock:
            self._hedges_launched += 1
        return url, is_trial

    def _cancel_loser(self, url: str, payload: bytes, tenant: str) -> None:
        """The losing hedge leg ACKed queued work (202): cancel its
        queued-but-not-dispatched copy at that backend so the duplicate
        admit releases its admission units and the journal stamps
        ``cancelled``. Best-effort — the winner already answered the
        client, and a 409 (the copy was dispatched before the cancel
        landed) just means fingerprint dedup or the duplicate solve
        finishes on its own."""
        try:
            rid = json.loads(payload.decode("utf-8")).get("id")
        except (ValueError, UnicodeDecodeError, AttributeError):
            return
        if not rid:
            return
        state = "unreachable"
        code = 599
        try:
            code, body, _ = self._forward_once(
                url, f"/v1/cancel/{rid}", b"", "application/json", "POST"
            )
            try:
                state = str(
                    json.loads(body.decode("utf-8")).get("state", "?")
                )
            except (ValueError, UnicodeDecodeError, AttributeError):
                state = "?"
        except (urllib.error.URLError, socket.timeout, OSError):
            pass
        with self._lock:
            self._hedge_cancels += 1
        self._logger.event(
            {
                "event": "cancel",
                "backend": url,
                "jid": str(rid),
                "tenant": tenant,
                "code": code,
                "state": state,
            }
        )

    def _stamped_request(
        self,
        path: str,
        body: bytes,
        content_type: str,
        method: str,
        deadline_ms: Optional[float],
        t_start: float,
        trace: Optional[obs_context.TraceContext] = None,
    ) -> Tuple[str, bytes, Optional[Dict[str, str]]]:
        """(path, body, extra headers) for one forward attempt with the
        REMAINING deadline budget stamped: header always, and the
        body's/query's own deadline_ms re-stamped so a retry or hedge
        consumes what is left of the budget rather than resurrecting
        the original. ``trace`` is the ATTEMPT's context (a fresh child
        span per retry/hedge leg — siblings under the ingress span) and
        rides the trace header independently of deadline propagation."""
        headers: Dict[str, str] = {}
        if trace is not None:
            headers[protocol.TRACE_HEADER] = trace.to_header()
        if (
            deadline_ms is None
            or not self.config.deadline_propagation
            or method != "POST"
        ):
            return path, body, headers or None
        elapsed_ms = (time.perf_counter() - t_start) * 1e3
        remaining = max(0.0, deadline_ms - elapsed_ms)
        parts = urlsplit(path)
        new_body, new_query = protocol.restamp_deadline(
            body, content_type, parts.query, remaining
        )
        new_path = parts.path + (f"?{new_query}" if new_query else "")
        headers[protocol.DEADLINE_HEADER] = f"{remaining:.3f}"
        return new_path, new_body, headers

    def _attempt_result(
        self,
        url: str,
        path: str,
        body: bytes,
        content_type: str,
        method: str,
        headers: Optional[Dict[str, str]],
    ) -> Tuple[int, bytes, bool, bool, float]:
        """One forward attempt with live-count release and wall timing:
        (code, payload, from_backend, transport_dead, ms)."""
        t0 = time.perf_counter()
        try:
            code, payload, from_backend = self._forward_once(
                url, path, body, content_type, method, headers
            )
            dead = False
        except (urllib.error.URLError, socket.timeout, OSError):
            code, payload, from_backend = 502, b"", False
            dead = True
        finally:
            self._release(url)
        return code, payload, from_backend, dead, (
            (time.perf_counter() - t0) * 1e3
        )

    def _classify(
        self, code: int, payload: bytes, from_backend: bool, dead: bool
    ) -> str:
        """One forward outcome's routing class: ``dead`` (transport
        death or unstamped gateway code — failover evidence),
        ``draining`` (backend-stamped graceful shutdown — route around,
        no failure accounting), or ``good`` (any backend-stamped
        response, including its own 429/504 verdicts)."""
        if dead or (code in (502, 503, 504) and not from_backend):
            return "dead"
        if code == 503 and from_backend and self._is_draining(payload):
            return "draining"
        return "good"

    def _log_route(
        self,
        url: str,
        route_path: str,
        code: int,
        hint: Optional[Tuple[int, int, float]],
        ms: float,
        retried: bool,
        hedge: bool,
        trace: Optional[obs_context.TraceContext] = None,
    ) -> None:
        rec = {
            "event": "route",
            "backend": url,
            "path": route_path,
            "code": code,
            "m": hint[0] if hint else None,
            "n": hint[1] if hint else None,
            "tol": hint[2] if hint else None,
            "ms": round(ms, 3),
            "retried": retried,
            "hedge": hedge,
        }
        if trace is not None:
            # The attempt's own span: its parent is the ingress span, so
            # hedge siblings land side by side under one request.
            rec.update(trace.span_args())
            tr = obs_trace.get_tracer()
            if tr.enabled:
                tr.complete(
                    "route.hedge" if hedge else "route.attempt",
                    ms / 1e3,
                    cat="route",
                    args={
                        **trace.span_args(),
                        "backend": url,
                        "code": code,
                        "retried": retried,
                    },
                )
        self._logger.event(rec)

    # -- routing ---------------------------------------------------------

    @staticmethod
    def _padding_score(
        m: int, n: int, buckets: List[Tuple[int, int, int]]
    ) -> float:
        """Fraction of the tightest fitting advertised bucket this shape
        would waste (0 = exact fit). No advertised fit = 1.0: the
        backend would open (and build) a fresh bucket."""
        best = 1.0
        for bm, bn, _bb in buckets:
            if bm >= m and bn >= n:
                waste = 1.0 - (m * n) / float(bm * bn)
                best = min(best, waste)
        return best

    def pick(
        self,
        hint: Optional[Tuple[int, int, float]] = None,
        exclude: Tuple[str, ...] = (),
    ) -> Optional[str]:
        """The best in-rotation backend for one request: min padding
        score (when the shape is visible), then min load, then
        round-robin. None = nothing routable. Breaker-open backends
        are out of rotation even when their probes pass; once the hold
        elapses they go half-open and exactly one trial forward may
        route here until it resolves."""
        return self._pick_attributed(hint, exclude)[0]

    def _pick_attributed(
        self,
        hint: Optional[Tuple[int, int, float]] = None,
        exclude: Tuple[str, ...] = (),
    ) -> Tuple[Optional[str], bool]:
        """pick() plus trial attribution: (url, is_trial) where
        is_trial marks that THIS route admitted the backend's single
        half-open trial — forward() threads it back into
        _record_forward_outcome so stale in-flight outcomes can't
        resolve the breaker."""
        now = time.perf_counter()
        with self._lock:
            in_rotation = []
            for st in self._backends.values():
                if (
                    not st.healthy
                    or not st.ready
                    or st.ejected
                    or st.url in exclude
                ):
                    continue
                if st.breaker == "open":
                    if now < st.breaker_until:
                        continue
                    st.breaker = "half_open"
                    st.breaker_probe_live = False
                if st.breaker == "half_open" and st.breaker_probe_live:
                    continue  # the single trial is already in flight
                in_rotation.append(st)
            if not in_rotation:
                return None, False
            self._rr += 1
            rr = self._rr
            scored = []
            for i, st in enumerate(in_rotation):
                pad = (
                    self._padding_score(hint[0], hint[1], st.buckets)
                    if hint
                    else 0.0
                )
                load = st.queue_depth + st.inflight + st.live
                scored.append(
                    (round(pad, 4), load, (i + rr) % len(in_rotation), st.url)
                )
            scored.sort()
            url = scored[0][3]
            self._backends[url].forwards += 1
            self._backends[url].live += 1
            is_trial = self._backends[url].breaker == "half_open"
            if is_trial:
                # probe_live was False (gated above), so this route IS
                # the single admitted trial.
                self._backends[url].breaker_probe_live = True
            ctr = self._m_routed.get(url)
            if ctr is None:
                ctr = self.metrics.counter(
                    "router_routed_total",
                    labels={"backend": url},
                    help="requests routed to this backend",
                )
                self._m_routed[url] = ctr
        ctr.inc()
        return url, is_trial

    # -- forwarding ------------------------------------------------------

    def _release(self, url: str) -> None:
        with self._lock:
            st = self._backends.get(url)
            if st is not None and st.live > 0:
                st.live -= 1

    @staticmethod
    def _from_backend(headers) -> bool:
        """True when the response was application-level (the backend
        front-end stamped it) rather than a gateway/transport artifact
        of the same status code."""
        return (
            headers.get(protocol.PLANE_HEADER) == protocol.PLANE_BACKEND
        )

    def _forward_once(
        self, url: str, path: str, body: bytes, content_type: str,
        method: str, headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[int, bytes, bool]:
        """(code, body, from_backend) for one forward attempt."""
        hdrs = {"Content-Type": content_type} if body else {}
        if headers:
            hdrs.update(headers)
        req = urllib.request.Request(
            url + path,
            data=body if method == "POST" else None,
            headers=hdrs,
            method=method,
        )
        try:
            with urllib.request.urlopen(
                req, timeout=self.config.forward_timeout_s
            ) as resp:
                return (
                    resp.status, resp.read(),
                    self._from_backend(resp.headers),
                )
        except urllib.error.HTTPError as e:
            return e.code, e.read(), self._from_backend(e.headers)

    def forward(
        self,
        path: str,
        body: bytes,
        content_type: str,
        method: str = "POST",
        trace: Optional[obs_context.TraceContext] = None,
    ) -> Tuple[int, bytes, Optional[str]]:
        """Route + forward one request with retry-once failover and,
        for solves, adaptive hedging. Returns (code, body, backend) —
        backend None means no backend was routable (the 503 path).
        Transport errors and gateway-class responses (502/503/504
        WITHOUT the backend's plane header) from the first backend
        eject it and retry exactly once elsewhere. A backend-stamped
        504/503 — the solver's own TIMEOUT verdict or a graceful
        shutdown — is a normal response: it passes through without
        ejecting the (healthy) backend or duplicating the solve on a
        second one.

        Tail tolerance: a solve whose primary stays silent past the
        adaptive hedge delay (the backend's recent p95, once its digest
        is warm) launches ONE hedge to the next-best backend; the first
        good response wins, and the losing 202 is cancelled at its
        backend (journal fingerprint dedup makes the duplicate admit
        safe regardless). Every attempt — first, retry, or hedge —
        re-stamps the REMAINING deadline budget so spent budget never
        resurrects downstream."""
        route_path = urlsplit(path).path
        hint = (
            protocol.peek_route_hint(
                body, content_type, urlsplit(path).query
            )
            if method == "POST"
            else None
        )
        is_solve = method == "POST" and route_path == "/v1/solve"
        deadline_ms: Optional[float] = None
        tenant = "default"
        if is_solve:
            deadline_ms, tenant = protocol.peek_deadline_tenant(
                body, content_type, urlsplit(path).query
            )
            with self._lock:
                self._forwards_total += 1
            if trace is None:
                # Ingress mint: a solve entering the plane without a
                # context starts its own trace here (pure host-side
                # string work — stays out of program inputs).
                trace = obs_context.new_context()
        t_start = time.perf_counter()
        code, payload, url = 503, b"", None
        tried: Tuple[str, ...] = ()
        for attempt in range(2):
            url, is_trial = self._pick_attributed(hint, exclude=tried)
            if url is None:
                return 503, b"", None
            delay_s = (
                self._hedge_delay_s(url)
                if is_solve and attempt == 0
                else None
            )
            if delay_s is not None:
                done = self._forward_hedged(
                    url, is_trial, path, body, content_type, method,
                    hint, route_path, deadline_ms, tenant, t_start,
                    delay_s, trace,
                )
                if done is not None:
                    return done
                # The primary failed with no hedge launched: fall back
                # to the classic retry-once path on a sibling.
                self._spend_retry_budget(tenant, "retry")
                tried = (url,)
                with self._lock:
                    self._failovers += 1
                self._m_failovers.inc()
                continue
            attempt_ctx = trace.child() if trace is not None else None
            spath, sbody, sheaders = self._stamped_request(
                path, body, content_type, method, deadline_ms, t_start,
                trace=attempt_ctx,
            )
            code, payload, from_backend, dead, ms = self._attempt_result(
                url, spath, sbody, content_type, method, sheaders
            )
            self._log_route(
                url, route_path, code, hint, ms, attempt > 0, False,
                trace=attempt_ctx,
            )
            cls = self._classify(code, payload, from_backend, dead)
            if cls == "dead":
                self._record_forward_outcome(url, False, trial=is_trial)
                self._note_forward_failure(url)
                if attempt == 0:
                    # Retries always proceed (retry-once is the plane's
                    # no-lost-acks mechanism) but drain the tenant's
                    # budget, so under a retry storm the speculative
                    # hedges are what stop first.
                    self._spend_retry_budget(tenant, "retry")
                    tried = (url,)
                    with self._lock:
                        self._failovers += 1
                    self._m_failovers.inc()
                    continue
            elif cls == "draining":
                # The backend is gracefully shutting down: alive (no
                # eject, no failure accounting) but done taking work —
                # stop routing to it and retry this one request on a
                # sibling. Distinct from a stamped 429/504, which pass
                # through as the backend's own verdict.
                self._note_draining(url, trial=is_trial)
                if attempt == 0:
                    self._spend_retry_budget(tenant, "retry")
                    tried = (url,)
                    with self._lock:
                        self._failovers += 1
                    self._m_failovers.inc()
                    continue
            else:
                # Any backend-stamped response — including its own 429
                # and TIMEOUT verdicts — proves the backend serves; it
                # counts FOR the breaker window, not against it.
                self._record_forward_outcome(url, True, trial=is_trial)
                if from_backend:
                    self._observe_latency(url, ms)
            return code, payload, url
        return code, payload, url  # second attempt's outcome, whatever it was

    def _forward_hedged(
        self,
        primary: str,
        primary_trial: bool,
        path: str,
        body: bytes,
        content_type: str,
        method: str,
        hint: Optional[Tuple[int, int, float]],
        route_path: str,
        deadline_ms: Optional[float],
        tenant: str,
        t_start: float,
        delay_s: float,
        trace: Optional[obs_context.TraceContext] = None,
    ) -> Optional[Tuple[int, bytes, Optional[str]]]:
        """The hedge-eligible leg of forward(): run the already-picked
        primary on a worker thread; if it stays silent past ``delay_s``,
        launch one hedge to the next-best backend and let the first
        good response win. Returns the winner's (code, body, backend);
        the primary's failure when every launched leg failed AND a
        hedge ran (the hedge consumed the retry); or None when the
        primary failed with no hedge launched — the caller falls back
        to the classic retry-once path.

        Runner threads do ALL their own leg bookkeeping (breaker
        outcome, failure/draining notes, latency observe, route log,
        loser cancel) so this method answers the client the moment a
        winner exists — it never joins a leg stalled on a straggler."""
        results: "queue_mod.Queue" = queue_mod.Queue()
        state = {"winner": None}
        state_lock = threading.Lock()

        def run_leg(url: str, is_trial: bool, leg: str) -> None:
            # Each leg is a SIBLING span: a fresh child of the ingress
            # context, minted per attempt — primary and hedge share a
            # parent, never a span_id.
            leg_ctx = trace.child() if trace is not None else None
            spath, sbody, sheaders = self._stamped_request(
                path, body, content_type, method, deadline_ms, t_start,
                trace=leg_ctx,
            )
            code, payload, from_backend, dead, ms = self._attempt_result(
                url, spath, sbody, content_type, method, sheaders
            )
            cls = self._classify(code, payload, from_backend, dead)
            if cls == "dead":
                self._record_forward_outcome(url, False, trial=is_trial)
                self._note_forward_failure(url)
            elif cls == "draining":
                self._note_draining(url, trial=is_trial)
            else:
                self._record_forward_outcome(url, True, trial=is_trial)
                if from_backend:
                    self._observe_latency(url, ms)
            self._log_route(
                url, route_path, code, hint, ms, False, leg == "hedge",
                trace=leg_ctx,
            )
            # A hedge leg's 429 never wins: admission/brownout said no,
            # and answering the client 429 while the primary may still
            # succeed would turn a speculative probe into a shed.
            eligible = cls == "good" and not (
                leg == "hedge" and code == 429
            )
            with state_lock:
                lost_to = state["winner"]
                won = eligible and lost_to is None
                if won:
                    state["winner"] = leg
            if not won and lost_to is not None and cls == "good" and (
                code == 202
            ):
                # This leg queued work the client will never poll:
                # cancel the duplicate so its admission units release
                # without waiting for fingerprint dedup or a solve.
                self._cancel_loser(url, payload, tenant)
            results.put(
                {
                    "leg": leg,
                    "code": code,
                    "payload": payload,
                    "url": url,
                    "won": won,
                }
            )

        threading.Thread(
            target=run_leg,
            args=(primary, primary_trial, "primary"),
            daemon=True,
            name="dlps-fwd-primary",
        ).start()
        legs = 1
        hedged = False
        hedge_url: Optional[str] = None
        got: List[dict] = []
        try:
            got.append(results.get(timeout=delay_s))
        except queue_mod.Empty:
            hedge_url, hedge_trial = self._hedge_pick(
                hint, (primary,), tenant
            )
            if hedge_url is not None:
                hedged = True
                legs = 2
                self._m_hedge_delay.observe(delay_s * 1e3)
                threading.Thread(
                    target=run_leg,
                    args=(hedge_url, hedge_trial, "hedge"),
                    daemon=True,
                    name="dlps-fwd-hedge",
                ).start()
        # Each leg's urlopen is bounded by forward_timeout_s, so these
        # gets terminate even when a leg is SIGSTOPped mid-response.
        while not any(r["won"] for r in got) and len(got) < legs:
            got.append(results.get())
        winner = next((r for r in got if r["won"]), None)
        if hedged:
            outcome = (
                "both_failed"
                if winner is None
                else (
                    "hedge_won"
                    if winner["leg"] == "hedge"
                    else "primary_won"
                )
            )
            self._count_hedge(outcome)
            hedge_rec = {
                "event": "hedge",
                "backend": hedge_url,
                "primary": primary,
                "delay_ms": round(delay_s * 1e3, 3),
                "outcome": outcome,
                "tenant": tenant,
            }
            if trace is not None:
                hedge_rec["trace_id"] = trace.trace_id
                hedge_rec["span_id"] = trace.span_id
            self._logger.event(hedge_rec)
        if winner is not None:
            return winner["code"], winner["payload"], winner["url"]
        if not hedged:
            return None  # caller's classic retry takes over
        # Both legs failed; the hedge consumed the retry. Answer with
        # the primary's verdict (the hedge was speculative).
        last = next((r for r in got if r["leg"] == "primary"), got[-1])
        return last["code"], last["payload"], last["url"]

    @staticmethod
    def _is_draining(payload: bytes) -> bool:
        try:
            return json.loads(payload.decode("utf-8")).get("reason") == (
                "draining"
            )
        except (ValueError, UnicodeDecodeError, AttributeError):
            return False

    # -- async id mapping ------------------------------------------------

    def remember_async(self, rid: str, url: str) -> None:
        with self._lock:
            self._async_map[rid] = url
            while len(self._async_map) > self.config.async_map_cap:
                self._async_map.popitem(last=False)

    def backend_for_async(self, rid: str) -> Optional[str]:
        with self._lock:
            return self._async_map.get(rid)

    # -- introspection ---------------------------------------------------

    def healthy_count(self) -> int:
        with self._lock:
            return sum(
                1
                for st in self._backends.values()
                if st.healthy and not st.ejected
            )

    def statusz(self) -> dict:
        now = time.perf_counter()
        with self._lock:
            out = {
                "failovers": self._failovers,
                # Auditable hedging ledger: probes and tests reconcile
                # the JSONL hedge/retry_budget events against these
                # counts to prove the rate cap and budgets were honored.
                "hedging": {
                    "forwards_total": self._forwards_total,
                    "hedges_launched": self._hedges_launched,
                    "rate_cap": self.config.hedge_rate_cap,
                    "outcomes": dict(self._hedge_outcomes),
                    "cancels": self._hedge_cancels,
                    "budget_exhausted": self._budget_exhausted,
                },
                "backends": [
                    {
                        "url": st.url,
                        "healthy": st.healthy,
                        "ready": st.ready,
                        "ejected": st.ejected,
                        "fails": st.fails,
                        "probes": st.probes,
                        "backoff_s": round(st.backoff_s, 3),
                        "breaker": st.breaker,
                        "breaker_trips": st.breaker_trips,
                        "queue_depth": st.queue_depth,
                        "inflight": st.inflight,
                        "live": st.live,
                        "buckets": [list(b) for b in st.buckets],
                        "forwards": st.forwards,
                        "latency_ms_p50": (
                            round(percentile(st.lat_ms, 50), 3)
                            if st.lat_ms
                            else None
                        ),
                        "latency_ms_p95": (
                            round(percentile(st.lat_ms, 95), 3)
                            if st.lat_ms
                            else None
                        ),
                        "last_poll_age_s": (
                            round(now - st.last_poll, 3)
                            if st.last_poll
                            else None
                        ),
                    }
                    for st in self._backends.values()
                ],
            }
        if self._registry is not None:
            data = self._registry.load()
            out["registry"] = {
                "path": self.config.registry_path,
                "generation": data.get("generation", 0),
                "writer": data.get("writer"),
                "backends": len(data.get("backends", {})),
            }
        return out

    def all_backend_urls(self) -> List[str]:
        """Every known backend URL, in-rotation first — the fan-out
        order for polls of async ids this router never issued (the id
        was minted before a router restart, or by a sibling)."""
        with self._lock:
            states = list(self._backends.values())
        states.sort(key=lambda st: (st.ejected, not st.healthy))
        return [st.url for st in states]


class RouterHTTPServer:
    """HTTP front for a :class:`Router`: forwards ``/v1/solve`` (+async
    polls), serves its own ``/metrics``, ``/healthz`` (healthy iff ≥1
    backend is in rotation), and ``/statusz`` (the backend table)."""

    def __init__(
        self,
        router: Router,
        host: str = "127.0.0.1",
        port: int = 0,
        metrics: Optional[obs_metrics.MetricsRegistry] = None,
    ):
        self.router = router
        self.metrics = metrics if metrics is not None else router.metrics
        self._httpd = PlaneHTTPServer((host, port), _RouterHandler)
        self._httpd.front = self
        self._host = host
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def start(self) -> "RouterHTTPServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.05},
                daemon=True,
                name=f"dlps-router-{self.port}",
            )
            self._thread.start()
        return self

    def __enter__(self) -> "RouterHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def shutdown(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=10.0)
            self._thread = None
        self._httpd.server_close()


class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _send(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, payload: dict) -> None:
        self._send(
            code, json.dumps(payload).encode("utf-8"), "application/json"
        )

    def do_POST(self) -> None:  # noqa: N802
        front = self.server.front
        parts = urlsplit(self.path)
        try:
            if parts.path.startswith("/v1/cancel/"):
                self._cancel_fanout(front, parts.path)
                return
            if parts.path != "/v1/solve":
                self._send_json(404, {"error": f"no such route {parts.path}"})
                return
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) if length else b""
            content_type = self.headers.get(
                "Content-Type", "application/json"
            )
            # Router ingress: continue the client's trace (we become a
            # child of its span) or start a fresh one. Header parse
            # only — no device values.
            # graftcheck: disable=host-sync (header parse, no device value)
            ctx = obs_context.parse(
                self.headers.get(protocol.TRACE_HEADER)
            ) or obs_context.new_context()
            t_in = time.perf_counter()
            code, payload, backend = front.router.forward(
                self.path, body, content_type, method="POST", trace=ctx
            )
            tr = obs_trace.get_tracer()
            if tr.enabled:
                tr.complete(
                    "route.ingress",
                    time.perf_counter() - t_in,
                    cat="route",
                    args={
                        **ctx.span_args(),
                        "code": code,
                        "backend": backend,
                    },
                )
            if backend is None:
                self._send_json(
                    503, {"error": "no healthy backend in rotation"}
                )
                return
            # Remember 202 async ids so later polls route to the same
            # backend (ids are backend-local).
            if code == 202:
                try:
                    rid = json.loads(payload.decode("utf-8")).get("id")
                    if rid:
                        front.router.remember_async(str(rid), backend)
                except (ValueError, UnicodeDecodeError):
                    pass
            self._send(code, payload, "application/json")
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _cancel_fanout(self, front, cancel_path: str) -> None:
        """Forward ``POST /v1/cancel/{jid}`` to the job's backend: the
        remembered async backend first, then (job ids are journal-nonce
        scoped, so the first non-404 answer is authoritative) every
        other known backend."""
        rid = cancel_path.rsplit("/", 1)[1]
        url = front.router.backend_for_async(rid)
        urls = front.router.all_backend_urls()
        candidates = (
            [url] + [u for u in urls if u != url]
            if url is not None
            else urls
        )
        code, payload = 404, json.dumps(
            {"id": rid, "cancelled": False, "state": "unknown"}
        ).encode("utf-8")
        for u in candidates:
            try:
                c, pl, _ = front.router._forward_once(
                    u, cancel_path, b"", "application/json", "POST"
                )
            except (urllib.error.URLError, socket.timeout, OSError):
                code, payload = 502, json.dumps(
                    {"error": f"backend {u} unreachable"}
                ).encode("utf-8")
                continue
            if c != 404:
                code, payload = c, pl
                break
        self._send(code, payload, "application/json")

    def do_GET(self) -> None:  # noqa: N802
        front = self.server.front
        parts = urlsplit(self.path)
        path = parts.path
        try:
            if path == "/metrics":
                self._send(
                    200,
                    front.metrics.to_prometheus_text().encode("utf-8"),
                    "text/plain; version=0.0.4",
                )
            elif path == "/healthz":
                n = front.router.healthy_count()
                ok = n > 0
                self._send_json(
                    200 if ok else 503,
                    {
                        "status": "ok" if ok else "unhealthy",
                        "healthy_backends": n,
                    },
                )
            elif path == "/statusz":
                self._send_json(200, front.router.statusz())
            elif path.startswith("/v1/solve/"):
                rid = path.rsplit("/", 1)[1]
                url = front.router.backend_for_async(rid)
                # Fan-out fallback: an id this router never issued (a
                # sibling's, or minted before a router restart) — or
                # whose remembered backend is unreachable (it may have
                # restarted elsewhere in the registry) — is tried
                # against every known backend. Durable job ids embed a
                # per-journal nonce, so the first non-404 answer is
                # authoritative and re-remembered.
                urls = front.router.all_backend_urls()
                candidates = (
                    [url] + [u for u in urls if u != url]
                    if url is not None
                    else urls
                )
                code, payload = 404, json.dumps(
                    {"error": f"unknown async id {rid!r}"}
                ).encode("utf-8")
                for u in candidates:
                    try:
                        c, pl, _ = front.router._forward_once(
                            u, path, b"", "application/json", "GET"
                        )
                    except (urllib.error.URLError, socket.timeout, OSError):
                        code, payload = 502, json.dumps(
                            {"error": f"backend {u} unreachable"}
                        ).encode("utf-8")
                        continue
                    if c != 404:
                        code, payload = c, pl
                        front.router.remember_async(rid, u)
                        break
                self._send(code, payload, "application/json")
            else:
                self._send_json(404, {"error": f"no such route {path}"})
        except (BrokenPipeError, ConnectionResetError):
            pass
