"""HTTP front-end over :class:`~distributedlpsolver_tpu_torch.serve.
SolveService` — stdlib ``http.server`` only. The port of the JAX
package's ``net/server.py``: the same routes, JSON bodies and events.

Endpoints:

- ``POST /v1/solve`` — JSON problem or raw MPS body
  (:mod:`net.protocol`); blocks on the service future and returns the
  result (solver verdicts are 200, queued-past-deadline 504, exhausted
  recovery 500). ``"async": true`` returns ``202`` +
  ``{"id": ..., "href": "/v1/solve/<id>"}`` instead. Admission
  rejections map to ``429`` with a ``Retry-After`` header carrying the
  structured verdict's wait hint.
- ``GET /v1/solve/{id}`` — async poll: 200 done, 202 pending, 404
  unknown/expired (the store is a bounded LRU — collected results
  evict oldest-first past ``async_results_cap``).
- ``POST /v1/cancel/{jid}`` — cancel queued-but-not-dispatched work
  (the router's hedge-loser path): 200 cancelled, 409 dispatched or
  already finished (lanes are never torn mid-program), 404 unknown.
- ``X-DLPS-Deadline-Ms`` on ``POST /v1/solve`` is the propagated
  remaining budget (router-stamped, decremented per hop/retry/hedge):
  it upper-bounds the body's own ``deadline_ms``, and expired-on-arrival
  work is admission-rejected immediately with a structured 504 verdict
  instead of queueing to die.
- ``GET /metrics`` — Prometheus text off the obs registry.
- ``GET /healthz`` — 200/503 from three signals: a health probe of the
  service's device (``utils/accel.py::probe_device``: one tiny op on
  the card, synchronized on a side thread within ``probe_deadline_s``;
  on ``device="cpu"`` the host), dispatcher pipeline
  liveness (all three threads running), and a wedge detector (queue
  depth > 0 with the dispatch count frozen past ``wedge_s``).
- ``GET /statusz`` — ``SolveService.stats()`` (with its
  ``dispatch_totals``: the bucket programs' bodies, replays, captures and
  K1 launches summed over every dispatch) + the front-end's own request
  counters; the router tier's shape/load feed.

Each request lands one ``http_request`` JSONL event (stamped schema)
and counts into ``net_requests_total{code,tenant}`` / the
``net_inflight`` gauge. The handler threads (ThreadingHTTPServer: one
per connection) only parse, submit, and block on futures — all device
work stays on the service's pipeline threads.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import OrderedDict
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import urlsplit

from distributedlpsolver_tpu_torch.net import protocol
from distributedlpsolver_tpu_torch.net.admission import TenantLabeler
from distributedlpsolver_tpu_torch.obs import context as obs_context
from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics
from distributedlpsolver_tpu_torch.serve.scheduler import ServiceOverloaded
from distributedlpsolver_tpu_torch.utils.logging import IterLogger


class PlaneHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer tuned for the serving plane: handler threads
    are daemons (a stuck client must not block interpreter exit), and
    the listen backlog is sized for bursty many-client load — the
    socketserver default of 5 resets connections under exactly the
    flood the admission layer exists to absorb."""

    daemon_threads = True
    request_queue_size = 128


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Tunables of one HTTP front-end."""

    host: str = "127.0.0.1"
    # 0 = ephemeral (the OS picks; tests and the probe read .port back).
    port: int = 0
    # Sync-POST wait bound when the request carries no deadline: a
    # client that asked for no deadline still must not pin a handler
    # thread forever if the service wedges.
    max_wait_s: float = 300.0
    # Grace past a request's own deadline before the handler gives up
    # on the future (the service resolves TIMEOUT at pop time, which
    # can lag the deadline by a flush window).
    deadline_grace_s: float = 10.0
    # Bounded async-result store (oldest evicted past the cap).
    async_results_cap: int = 1024
    # healthz probe results are cached this long (device pings are
    # cheap but not free; the router polls every backend).
    healthz_cache_s: float = 0.5
    # Device health-probe deadline (utils/accel.probe_device).
    probe_deadline_s: float = 2.0
    # Queue depth > 0 with zero dispatch progress for this long = the
    # pipeline is wedged and healthz goes unhealthy.
    wedge_s: float = 30.0
    # Graceful drain (POST /quitquitquit): how long the drain thread
    # waits for in-flight work before closing the listener anyway.
    drain_timeout_s: float = 60.0
    # Retry-After hint on not-ready (draining) 503s.
    drain_retry_after_s: float = 5.0
    # After the drain finishes, keep the listener answering for up to
    # this long while computed-but-unclaimed async verdicts exist — a
    # client polling at any sane cadence collects its result before the
    # process exits (scale-in must not orphan acknowledged work). The
    # linger ends early once every resolved async id has been fetched.
    drain_linger_s: float = 2.0
    # http_request JSONL event stream (stamped schema); None = off.
    log_jsonl: Optional[str] = None
    # Honor the router-stamped X-DLPS-Deadline-Ms remaining-budget
    # header: bound the request deadline by it and reject
    # expired-on-arrival work up front. Off = header ignored (the
    # body's own deadline_ms still applies).
    deadline_propagation: bool = True


class SolveHTTPServer:
    """One HTTP front-end bound to one :class:`SolveService`.

    ``start()`` binds and serves on a daemon thread; ``shutdown()``
    stops accepting and closes the socket (the service itself is NOT
    shut down — callers own its lifecycle, and the router probe kills
    front-ends while their services drain)."""

    def __init__(
        self,
        service,
        config: Optional[NetConfig] = None,
        metrics: Optional[obs_metrics.MetricsRegistry] = None,
    ):
        self.service = service
        self.config = config or NetConfig()
        # Default to the service's registry so one scrape of /metrics
        # shows the whole backend (serve_* and net_* families together).
        self.metrics = metrics if metrics is not None else service.metrics
        m = self.metrics
        # Tenant strings are client-controlled: bound the metric label
        # set, sharing the admission controller's labeler when the
        # service has one so both metric families agree on "other".
        adm = getattr(service, "admission", None)
        self._tenant_labels = (
            adm.labeler
            if adm is not None and hasattr(adm, "labeler")
            else TenantLabeler()
        )
        self._m_by_code: Dict[tuple, object] = {}  # guarded-by: _lock
        self._m_inflight = m.gauge(
            "net_inflight", help="HTTP requests currently being handled"
        )
        self._m_http_ms = m.histogram(
            "net_request_ms", help="HTTP request wall time (handler span)"
        )
        self._m_deadline_expired = m.counter(
            "net_deadline_expired_on_arrival_total",
            help="solve requests whose propagated deadline budget was "
            "already spent on arrival (rejected before queueing)",
        )
        # Async-store eviction accounting: {state="resolved"} is normal
        # bounded turnover; {state="unresolved"} must stay 0 — a nonzero
        # value is the silent-loss regression this metric exists to make
        # observable (eviction only ever takes resolved entries now).
        self._m_evictions: Dict[str, object] = {}  # guarded-by: _lock
        self._logger = IterLogger(
            verbose=False, jsonl_path=self.config.log_jsonl
        )
        self._lock = threading.Lock()
        self._requests_total = 0  # guarded-by: _lock
        self._by_code: Dict[int, int] = {}  # guarded-by: _lock
        self._inflight = 0  # guarded-by: _lock
        # Async-poll store: id -> (future, include_x, t_created).
        self._async: OrderedDict = OrderedDict()  # guarded-by: _lock
        self._async_seq = 0  # guarded-by: _lock
        # Resolved async ids a client has fetched at least once — the
        # drain linger waits only on resolved-but-never-claimed ids.
        self._async_claimed: set = set()  # guarded-by: _lock
        # healthz cache + wedge-detector pulse.
        self._health: Optional[Tuple[bool, dict]] = None  # guarded-by: _health_lock
        self._health_t = 0.0  # guarded-by: _health_lock
        self._progress = (-1, 0.0)  # guarded-by: _health_lock
        self._health_lock = threading.Lock()
        self._t_start = time.perf_counter()
        # Graceful drain: the admin endpoint runs this on its own
        # thread (drain → flush → close listener); /readyz flips the
        # moment it starts. Optional callback fires after the listener
        # closes (the CLI uses it to exit the process cleanly).
        self._drain_thread: Optional[threading.Thread] = None  # guarded-by: _lock
        self.on_drained = None  # callable(drained: bool) | None
        self._httpd = PlaneHTTPServer(
            (self.config.host, self.config.port), _Handler
        )
        self._httpd.front = self
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.config.host}:{self.port}"

    def start(self) -> "SolveHTTPServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.05},
                daemon=True,
                name=f"dlps-http-{self.port}",
            )
            self._thread.start()
        return self

    def __enter__(self) -> "SolveHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def shutdown(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=10.0)
            self._thread = None
        self._httpd.server_close()
        self._logger.close()

    # -- bookkeeping the handler threads call ----------------------------

    def _enter_request(self) -> float:
        with self._lock:
            self._inflight += 1
            self._m_inflight.set(self._inflight)
        return time.perf_counter()

    def _exit_request(
        self, t0: float, method: str, path: str, code: int,
        tenant: str, request_id, trace=None,
    ) -> None:
        ms = (time.perf_counter() - t0) * 1e3
        label = self._tenant_labels.label(tenant)
        with self._lock:
            self._inflight -= 1
            self._requests_total += 1
            self._by_code[code] = self._by_code.get(code, 0) + 1
            self._m_inflight.set(self._inflight)
            ctr = self._m_by_code.get((code, label))
            if ctr is None:
                ctr = self.metrics.counter(
                    "net_requests_total",
                    labels={"code": str(code), "tenant": label},
                    help="HTTP requests by response code and tenant",
                )
                self._m_by_code[(code, label)] = ctr
        ctr.inc()
        # The latency histogram keeps its slowest observation's trace_id
        # as an exemplar: the aggregator surfaces "this bucket's worst
        # request was trace X" without scanning every record.
        self._m_http_ms.observe(
            ms, exemplar=(trace.trace_id if trace is not None else None)
        )
        rec = {
            "event": "http_request",
            "method": method,
            "path": path,
            "code": code,
            "tenant": tenant,
            "id": request_id,
            "ms": round(ms, 3),
        }
        if trace is not None:
            rec.update(trace.span_args())
        self._logger.event(rec)

    def _m_evict(self, state: str):  # holds: _lock
        ctr = self._m_evictions.get(state)
        if ctr is None:
            ctr = self.metrics.counter(
                "net_store_evictions_total",
                labels={"state": state},
                help="async-store evictions by entry state (unresolved "
                "must stay 0 — a resolved-only eviction policy)",
            )
            self._m_evictions[state] = ctr
        return ctr

    def _register_async(self, fut, include_x: bool) -> str:
        # With a durable journal the service's job id IS the poll id —
        # stable across front-end restarts (GET /v1/solve/{jid} falls
        # through to the on-disk store). Without one, a process-local
        # LRU id.
        jid = getattr(fut, "jid", None)
        with self._lock:
            if jid:
                rid = str(jid)
            else:
                self._async_seq += 1
                rid = f"a{self._async_seq}"
            self._async[rid] = (fut, include_x, time.perf_counter())
            # Evict only RESOLVED entries past the cap: dropping an
            # unresolved future under pressure silently lost its poll
            # URL (the acknowledged request became a permanent 404).
            # With nothing resolved the store may exceed the cap — it
            # is still bounded by admission (max_queue_depth) upstream.
            if len(self._async) > self.config.async_results_cap:
                for old_rid in list(self._async):
                    if len(self._async) <= self.config.async_results_cap:
                        break
                    old_fut = self._async[old_rid][0]
                    if old_fut.done():
                        del self._async[old_rid]
                        self._async_claimed.discard(old_rid)
                        self._m_evict("resolved").inc()
        return rid

    def _lookup_async(self, rid: str):
        with self._lock:
            return self._async.get(rid)

    def _mark_async_claimed(self, rid: str) -> None:
        with self._lock:
            if rid in self._async:
                self._async_claimed.add(rid)

    def _async_unclaimed(self) -> int:
        """Resolved async ids no client has fetched yet — what the
        drain linger waits on."""
        with self._lock:
            return sum(
                1
                for rid, entry in self._async.items()
                if entry[0].done() and rid not in self._async_claimed
            )

    # -- health ----------------------------------------------------------

    def health(self) -> Tuple[bool, dict]:
        """(healthy, payload) from device probes + pipeline liveness +
        the wedge detector; cached ``healthz_cache_s``."""
        now = time.perf_counter()
        with self._health_lock:
            if (
                self._health is not None
                and now - self._health_t < self.config.healthz_cache_s
            ):
                return self._health
        # Probe OUTSIDE the lock: a slow device ping must not serialize
        # concurrent healthz handlers behind it.
        from distributedlpsolver_tpu_torch.utils.accel import probe_devices

        healthy_devs, unhealthy_devs = probe_devices(
            [self.service.device], deadline=self.config.probe_deadline_s
        )
        pipeline = self.service.pipeline_alive()
        dispatches, depth = self.service.progress()
        with self._health_lock:
            last_d, last_t = self._progress
            if depth == 0 or dispatches != last_d:
                self._progress = (dispatches, now)
                wedged = False
            else:
                wedged = now - last_t > self.config.wedge_s
            ok = pipeline and not wedged and not unhealthy_devs
            payload = {
                "status": "ok" if ok else "unhealthy",
                "devices_healthy": len(healthy_devs),
                "devices_unhealthy": [
                    -1 if d.index is None else int(d.index) for d in unhealthy_devs
                ],
                # The probed device: the service's card, or the host.
                "device": str(self.service.device),
                "pipeline_alive": pipeline,
                "wedged": wedged,
                "queue_depth": depth,
                # Liveness and readiness are separate axes: a draining
                # backend is HEALTHY (don't eject it) but NOT READY
                # (stop routing to it) — /readyz carries the verdict.
                "draining": bool(getattr(self.service, "draining", False)),
            }
            self._health = (ok, payload)
            self._health_t = now
            return self._health

    def ready(self) -> Tuple[bool, dict]:
        """(ready, payload) for ``/readyz``: ready to ACCEPT work —
        pipeline up and not draining. Routers stop routing on 503 here
        without treating it as failure evidence (the backend is alive
        and finishing what it holds)."""
        draining = bool(getattr(self.service, "draining", False))
        pipeline = self.service.pipeline_alive()
        ok = pipeline and not draining
        return ok, {
            "status": "ready" if ok else "not_ready",
            "draining": draining,
            "pipeline_alive": pipeline,
        }

    # -- graceful drain ----------------------------------------------------

    def begin_drain(self) -> bool:
        """Start the graceful-shutdown sequence (the ``/quitquitquit``
        admin path): flip the service to draining (readyz 503s from this
        instant), finish in-flight work, flush the journal, then close
        the HTTP listener and fire ``on_drained``. Returns False if a
        drain was already running."""
        with self._lock:
            if self._drain_thread is not None:
                return False
            self._drain_thread = threading.Thread(
                target=self._drain_and_close,
                daemon=True,
                name=f"dlps-http-drain-{self.port}",
            )
            t = self._drain_thread
        # Flip BEFORE the thread spins up so the 200 response to
        # /quitquitquit races nothing: readyz is already 503 when the
        # caller sees the acknowledgment.
        self.service.begin_draining()
        t.start()
        return True

    def _drain_and_close(self) -> None:
        drained = self.service.drain_for_shutdown(
            timeout=self.config.drain_timeout_s
        )
        # Linger: every admitted request now has its verdict, but a
        # client that was just ACKed may not have polled it yet. Keep
        # the listener answering until each resolved async id has been
        # claimed (or the linger budget runs out) — closing earlier
        # turns acknowledged work into permanent 404s on scale-in.
        linger_deadline = (
            time.perf_counter() + self.config.drain_linger_s
        )
        while (
            time.perf_counter() < linger_deadline
            and self._async_unclaimed() > 0
        ):
            time.sleep(0.05)
        self._logger.event(
            {
                "event": "drain",
                "phase": "listener_close",
                "drained": drained,
            }
        )
        cb = self.on_drained
        self.shutdown()
        if cb is not None:
            cb(drained)

    def statusz(self) -> dict:
        stats = self.service.stats()
        with self._lock:
            net = {
                "requests_total": self._requests_total,
                "by_code": {str(k): v for k, v in self._by_code.items()},
                "inflight": self._inflight,
                "async_pending": len(self._async),
            }
        return {
            "uptime_s": round(time.perf_counter() - self._t_start, 3),
            "net": net,
            "stats": stats,
        }


class _Handler(BaseHTTPRequestHandler):
    """Per-connection handler; all state lives on ``server.front``."""

    protocol_version = "HTTP/1.1"
    # http.server's default request line log goes to stderr per request
    # — a 200-rps load test must not pay (or emit) that.
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _send_json(
        self, code: int, payload: dict, headers: Optional[dict] = None
    ) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        # Marks this as an application-level response: the router must
        # not read a backend-originated 504 (solver TIMEOUT verdict) or
        # 503 as gateway failure and eject a healthy backend.
        self.send_header(protocol.PLANE_HEADER, protocol.PLANE_BACKEND)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str, content_type: str) -> None:
        body = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.send_header(protocol.PLANE_HEADER, protocol.PLANE_BACKEND)
        self.end_headers()
        self.wfile.write(body)

    # -- POST /v1/solve --------------------------------------------------

    def do_POST(self) -> None:  # noqa: N802 (http.server convention)
        front = self.server.front
        parts = urlsplit(self.path)
        t0 = front._enter_request()
        code, tenant, rid = 500, "default", None
        trace_ctx: Optional[obs_context.TraceContext] = None
        try:
            if parts.path in ("/quitquitquit", "/drainz"):
                # Admin drain: acknowledge, then finish in-flight work
                # and close the listener from a background thread.
                # readyz is already 503 when this response is sent.
                started = front.begin_drain()
                code = 200
                self._send_json(
                    code,
                    {
                        "draining": True,
                        "started": started,
                        "queue_depth": front.service.progress()[1],
                    },
                )
                return
            if parts.path.startswith("/v1/cancel/"):
                rid = parts.path.rsplit("/", 1)[1]
                cancel = getattr(front.service, "cancel", None)
                if cancel is None:
                    code = 501
                    self._send_json(
                        code, {"error": "cancellation unsupported"}
                    )
                    return
                ok, state = cancel(rid)
                # 409 = admitted but no longer cancellable (dispatched
                # work runs to completion; finished work has a verdict).
                code = 200 if ok else (404 if state == "unknown" else 409)
                self._send_json(
                    code, {"id": rid, "cancelled": bool(ok), "state": state}
                )
                return
            if parts.path != "/v1/solve":
                code = 404
                self._send_json(code, {"error": f"no such route {parts.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b""
                req = protocol.parse_solve_request(
                    body,
                    self.headers.get("Content-Type", "application/json"),
                    parts.query,
                )
            except protocol.ProtocolError as e:
                code = 400
                self._send_json(code, {"error": str(e)})
                return
            tenant = req.tenant
            # Trace join: the router stamped this leg's span in the
            # trace header; the backend's pipeline becomes its child so
            # hedge siblings stay distinguishable fleet-wide. Malformed
            # or absent → None (the solve is untraced, never failed).
            # graftcheck: disable=host-sync (header parse, no device value)
            trace_ctx = obs_context.parse(
                self.headers.get(protocol.TRACE_HEADER)
            )
            hdr = self.headers.get(protocol.DEADLINE_HEADER)
            if hdr is not None and front.config.deadline_propagation:
                try:
                    remaining_s = float(hdr) / 1e3  # graftcheck: disable=host-sync (header parse, no device value)
                except ValueError:
                    remaining_s = None  # malformed header: ignore it
                if remaining_s is not None:
                    if remaining_s <= 0.0:
                        # Expired on arrival: a structured verdict NOW
                        # beats queueing work that can only die. The
                        # plane header marks this 504 as an
                        # application verdict, so the router passes it
                        # through instead of reading it as failover
                        # evidence (retrying a dead budget elsewhere
                        # is exactly the amplification to avoid).
                        code = 504
                        front._m_deadline_expired.inc()
                        front._logger.event(
                            {
                                "event": "deadline_expired",
                                "path": parts.path,
                                "tenant": tenant,
                                "remaining_ms": round(remaining_s * 1e3, 3),
                            }
                        )
                        self._send_json(
                            code,
                            {
                                # The structured verdict IS a timeout:
                                # clients see the same status field a
                                # queued-past-deadline request reports.
                                "status": "timeout",
                                "error": "deadline budget expired on "
                                "arrival",
                                "reason": "deadline_expired",
                                "tenant": tenant,
                            },
                        )
                        return
                    # The propagated budget upper-bounds the client's
                    # original deadline: a retry/hedge hop must consume
                    # the REMAINING budget, never resurrect the full one.
                    req.deadline_s = (
                        min(req.deadline_s, remaining_s)
                        if req.deadline_s is not None
                        else remaining_s
                    )
            try:
                fut = front.service.submit(
                    req.problem,
                    deadline=req.deadline_s,
                    tol=req.tol,
                    name=req.name,
                    tenant=req.tenant,
                    priority=req.priority,
                    trace=trace_ctx,
                )
            except ServiceOverloaded as e:
                # Draining is a readiness verdict, not load shedding:
                # 503 tells the router "route elsewhere, this backend
                # is finishing up" (the plane header keeps it from
                # being read as a transport failure and ejecting us).
                code = 503 if e.reason == "draining" else 429
                # Admission clamps its hints, but keep the header/body
                # finite no matter which path raised the overload.
                retry = min(max(e.retry_after_s, 0.001), 3600.0)
                self._send_json(
                    code,
                    {
                        "error": str(e),
                        "reason": e.reason,
                        "retry_after_s": retry,
                        "tenant": e.tenant,
                    },
                    headers={"Retry-After": f"{retry:.3f}"},
                )
                return
            except RuntimeError as e:  # service shut down
                code = 503
                self._send_json(code, {"error": str(e)})
                return
            if req.want_async:
                handle = front._register_async(fut, req.include_x)
                rid = handle
                code = 202
                self._send_json(
                    code, {"id": handle, "href": f"/v1/solve/{handle}"}
                )
                return
            wait = (
                req.deadline_s + front.config.deadline_grace_s
                if req.deadline_s is not None
                else front.config.max_wait_s
            )
            try:
                result = fut.result(timeout=wait)
            except FutureTimeout:
                code = 504
                self._send_json(
                    code, {"error": f"no result within {wait:.1f}s"}
                )
                return
            rid = result.request_id
            code, payload = protocol.result_payload(result, req.include_x)
            self._send_json(code, payload)
        except (BrokenPipeError, ConnectionResetError):
            code = 499  # client went away mid-response; counted, not raised
        finally:
            front._exit_request(
                t0, "POST", parts.path, code, tenant, rid, trace=trace_ctx
            )

    # -- GETs ------------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802
        front = self.server.front
        parts = urlsplit(self.path)
        path = parts.path
        t0 = front._enter_request()
        code, rid = 500, None
        try:
            if path == "/metrics":
                code = 200
                self._send_text(
                    code,
                    front.metrics.to_prometheus_text(),
                    "text/plain; version=0.0.4",
                )
            elif path == "/healthz":
                ok, payload = front.health()
                code = 200 if ok else 503
                self._send_json(code, payload)
            elif path == "/readyz":
                ok, payload = front.ready()
                code = 200 if ok else 503
                self._send_json(
                    code,
                    payload,
                    headers=(
                        {}
                        if ok
                        else {
                            "Retry-After": (
                                f"{front.config.drain_retry_after_s:.3f}"
                            )
                        }
                    ),
                )
            elif path == "/statusz":
                code = 200
                self._send_json(code, front.statusz())
            elif path.startswith("/v1/solve/"):
                rid = path.rsplit("/", 1)[1]
                entry = front._lookup_async(rid)
                if entry is not None:
                    fut, include_x, _ = entry
                    if not fut.done():
                        code = 202
                        self._send_json(
                            code, {"id": rid, "status": "pending"}
                        )
                    else:
                        code, payload = protocol.result_payload(
                            fut.result(), include_x
                        )
                        self._send_json(code, payload)
                        front._mark_async_claimed(rid)
                else:
                    # Durable fallback: ids this process never minted
                    # (issued before a restart) resolve through the
                    # journal's on-disk store / pending set.
                    job_result = getattr(
                        front.service, "job_result", None
                    )
                    kind, rec = (
                        job_result(rid)
                        if job_result is not None
                        else ("unknown", None)
                    )
                    if kind == "done":
                        code, payload = protocol.payload_from_record(rec)
                        self._send_json(code, payload)
                    elif kind == "pending":
                        code = 202
                        self._send_json(
                            code, {"id": rid, "status": "pending"}
                        )
                    else:
                        code = 404
                        self._send_json(
                            code,
                            {"error": f"unknown or expired id {rid!r}"},
                        )
            else:
                code = 404
                self._send_json(code, {"error": f"no such route {path}"})
        except (BrokenPipeError, ConnectionResetError):
            code = 499
        finally:
            front._exit_request(t0, "GET", path, code, "default", rid)
