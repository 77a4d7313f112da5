"""The torch package's network plane (``net/``) against the JAX package's,
on the CPU.

* ``protocol``: every body kind (inline c/A/b, generated spec, MPS text
  body and inline ``mps_text``, async, query fields, malformed) parses to
  the same problem bit for bit with the same request fields, and the
  malformed ones raise ``ProtocolError`` in both; the payload encoders and
  the router's peeks agree. A two-stage body raises the port's
  ``NotImplementedError`` naming ROADMAP item 11 (501 over HTTP).
* ``server``: both ``SolveHTTPServer``s answer the same 16 requests with
  the same HTTP codes and response keys, the same statuses and objectives
  within 1e-8 relative; the same drain/readiness sequence; the port's
  ``/metrics`` carries the reference's metric names (the scenario tier's
  aside, item 11). ``/healthz`` reports the torch probe of the service's
  device, and ``/statusz`` the dispatches' device-loop totals.
* ``router``: over stub backends both ``Router``s give the same ejection,
  breaker and hedge-delay decisions and events; a live hedge over two
  stub backends ends ``hedge_won`` in both; the twin of the reference's
  ``test_router_metrics_and_events`` waits on its events with deadlines.
* ``scripts/port_probe_net.py --device cpu`` passes.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from distributedlpsolver_tpu.io.mps import write_mps as jax_write_mps
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.net import NetConfig as JaxNetConfig
from distributedlpsolver_tpu.net import SolveHTTPServer as JaxHTTPServer
from distributedlpsolver_tpu.net import protocol as jproto
from distributedlpsolver_tpu.net import router as jrouter
from distributedlpsolver_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from distributedlpsolver_tpu.serve import ServiceConfig as JaxServiceConfig
from distributedlpsolver_tpu.serve import SolveService as JaxService
from distributedlpsolver_tpu.serve.records import RequestResult as JaxResult
from distributedlpsolver_tpu.ipm.state import Status as JaxStatus
from distributedlpsolver_tpu_torch.ipm.state import Status
from distributedlpsolver_tpu_torch.net import NetConfig, SolveHTTPServer
from distributedlpsolver_tpu_torch.net import protocol as tproto
from distributedlpsolver_tpu_torch.net import router as trouter
from distributedlpsolver_tpu_torch.obs.metrics import MetricsRegistry
from distributedlpsolver_tpu_torch.serve import ServiceConfig, SolveService
from distributedlpsolver_tpu_torch.serve.records import RequestResult
from distributedlpsolver_tpu_torch.utils import accel
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JSON = "application/json"
# Child processes run torch single-threaded: the suite's workers already
# use every core, and a child's thread pool would only contend with them.
SINGLE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}


def _http(url, body=None, timeout=60.0, raw=None, ctype=JSON):
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read())
        except Exception:
            return e.code, {}
    except (urllib.error.URLError, OSError) as e:
        return 599, {"error": f"{type(e).__name__}: {e}"}


def _mps_text(m, n, seed, tmp_path):
    path = tmp_path / f"p{m}x{n}s{seed}.mps"
    jax_write_mps(jgen.random_dense_lp(m, n, seed=seed), str(path))
    return path.read_text()


# -- protocol -------------------------------------------------------------------


def _bodies(tmp_path):
    p = jgen.random_dense_lp(4, 9, seed=3)
    inline = {"problem": {"c": p.c.tolist(), "A": np.asarray(p.A).tolist(), "b": p.rlb.tolist()},
              "tol": 1e-6, "deadline_ms": 250, "tenant": "acme", "priority": "high",
              "id": "job-1"}
    mps = _mps_text(3, 7, 5, tmp_path)
    return {
        "inline": (json.dumps(inline).encode(), JSON, ""),
        "generated": (json.dumps({"m": 6, "n": 14, "seed": 1}).encode(), JSON,
                      "tenant=t9&deadline_ms=100"),
        "generated_async": (json.dumps({"m": 8, "n": 24, "seed": 2, "async": True,
                                        "include_x": False}).encode(), JSON, ""),
        "mps_body": (mps.encode(), "text/plain", "tenant=mps&tol=1e-7"),
        "mps_inline": (json.dumps({"mps_text": mps, "id": "m1"}).encode(), JSON, ""),
    }


FIELDS = ("tol", "deadline_s", "tenant", "priority", "want_async", "name", "include_x")
PROBLEM = ("c", "A", "rlb", "rub", "lb", "ub")


@pytest.mark.parametrize("kind", ["inline", "generated", "generated_async", "mps_body",
                                  "mps_inline"])
def test_bodies_parse_to_the_same_problem(kind, tmp_path):
    body, ctype, query = _bodies(tmp_path)[kind]
    rj = jproto.parse_solve_request(body, ctype, query)
    rt = tproto.parse_solve_request(body, ctype, query)
    for f in FIELDS:
        assert getattr(rt, f) == getattr(rj, f), f
    for f in PROBLEM:
        a, b = getattr(rt.problem, f), getattr(rj.problem, f)
        a = a.toarray() if hasattr(a, "toarray") else np.asarray(a)
        b = b.toarray() if hasattr(b, "toarray") else np.asarray(b)
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (rt.problem.name, rt.problem.m, rt.problem.n) == (rj.problem.name, rj.problem.m,
                                                              rj.problem.n)


@pytest.mark.parametrize("body, ctype", [
    (b"not json", JSON),
    (b"{}", JSON),
    (b"[1, 2]", JSON),
    (b'{"problem": {"c": [1], "A": [[1, 2]], "b": [1]}}', JSON),
    (b'{"problem": {"c": "x"}}', JSON),
    (b"", "text/plain"),
    (b"\xff\xfe", "text/plain"),
    (b"NAME X\nROWS\n N COST\nBOGUS\n", "text/plain"),
])
def test_malformed_bodies_raise_protocol_error_in_both(body, ctype):
    errs = []
    for proto in (jproto, tproto):
        with pytest.raises(proto.ProtocolError) as e:
            proto.parse_solve_request(body, ctype)
        errs.append(str(e.value).split(":")[0])
    assert errs[0] == errs[1]


def test_two_stage_bodies_name_the_unported_item():
    """The body kind this test once found unported (item 11, now ported):
    a ``scenarios`` body lowers to the JAX package's problem and hint, in
    the generated form and the explicit (``ScenarioLP.to_dict``) form."""
    body = json.dumps({"scenarios": {"n_scenarios": 2, "seed": 0}}).encode()
    jp = jproto.parse_solve_request(body, JSON).problem
    tp = tproto.parse_solve_request(body, JSON).problem
    assert tp.block_structure == jp.block_structure
    assert tp.block_structure["kind"] == "two_stage"
    assert (tp.A != jp.A).nnz == 0 and np.array_equal(tp.rub, jp.rub) and np.array_equal(tp.c, jp.c)
    from distributedlpsolver_tpu_torch.models.scenario import two_stage_storm

    slp = two_stage_storm(3, 4, 7, 4, 1, seed=4)
    tp2 = tproto.parse_solve_request(json.dumps({"scenarios": slp.to_dict()}).encode(), JSON).problem
    assert (tp2.A != slp.to_block_angular().A).nnz == 0 and tp2.block_structure["num_blocks"] == 3


@pytest.mark.parametrize("query, body", [
    ("", {"m": 8, "n": 24, "tol": 1e-6}),
    ("", {"problem": {"c": [1, 2, 3], "A": [[1, 2, 3]], "b": [4]}}),
    ("m=5&n=9&deadline_ms=40&tenant=q", None),
    ("", {"m": 8, "n": 24, "deadline_ms": 120.5, "tenant": "acme"}),
])
def test_router_peeks_and_restamp_agree(query, body):
    raw = b"RAW MPS" if body is None else json.dumps(body).encode()
    ctype = "text/plain" if body is None else JSON
    for fn in ("peek_route_hint", "peek_deadline_tenant"):
        assert getattr(tproto, fn)(raw, ctype, query) == getattr(jproto, fn)(raw, ctype, query)
    assert tproto.restamp_deadline(raw, ctype, query, 33.25) == jproto.restamp_deadline(
        raw, ctype, query, 33.25)


@pytest.mark.parametrize("status", ["optimal", "timeout", "failed", "cancelled",
                                    "iteration_limit"])
def test_payloads_agree(status):
    out = []
    for Result, St, proto in ((JaxResult, JaxStatus, jproto), (RequestResult, Status, tproto)):
        opt = status == "optimal"
        r = Result(request_id=7, name="r7", status=St(status),
                   objective=1.5 if opt else float("nan"),
                   x=np.arange(3.0) if opt else None, iterations=4,
                   rel_gap=1e-9 if opt else float("inf"), pinf=1e-10, dinf=float("inf"),
                   bucket=(8, 24, 4), queue_ms=1.25, compile_ms=0.0, solve_ms=2.5,
                   total_ms=3.75, padding_waste=0.1, m=8, n=24)
        code, body = proto.result_payload(r)
        rec = r.record()
        rec["x"] = body.get("x")
        out.append((code, body, proto.payload_from_record(rec), proto.error_payload(418, "e")))
    assert out[0] == out[1]


# -- server ---------------------------------------------------------------------


def _jax_front(net=None, **cfg):
    reg = JaxRegistry()
    svc = JaxService(JaxServiceConfig(**cfg), metrics=reg)
    net = JaxNetConfig(**{"healthz_cache_s": 0.02, **(net or {})})
    return svc, JaxHTTPServer(svc, net, metrics=reg).start()


def _torch_front(net=None, **cfg):
    reg = MetricsRegistry()
    svc = SolveService(ServiceConfig(**cfg), metrics=reg, device="cpu")
    net = NetConfig(**{"healthz_cache_s": 0.02, **(net or {})})
    return svc, SolveHTTPServer(svc, net, metrics=reg).start()


def _sixteen(tmp_path):
    """The 16 requests: (path, json body or raw, content type)."""
    p = jgen.random_dense_lp(6, 16, seed=11)
    inline = {"problem": {"c": p.c.tolist(), "A": np.asarray(p.A).tolist(), "b": p.rlb.tolist()},
              "id": "inline-11"}
    mps = _mps_text(5, 12, 4, tmp_path)
    reqs = [("/v1/solve", {"m": m, "n": n, "seed": s}, JSON)
            for s, (m, n) in enumerate([(8, 24), (12, 32)] * 4)]
    reqs += [
        ("/v1/solve", inline, JSON),
        ("/v1/solve", mps.encode(), "text/plain"),
        ("/v1/solve", {"mps_text": mps, "id": "mps-inline", "include_x": False}, JSON),
        ("/v1/solve", {"m": 8, "n": 24, "seed": 40, "tol": 1e-4}, JSON),
        ("/v1/solve", {"m": 8, "n": 24, "seed": 41, "deadline_ms": 0.001}, JSON),
        ("/v1/solve", b"{nope", JSON),
        ("/v1/nothing", {"m": 8, "n": 24}, JSON),
        ("/v1/solve", {"m": 8, "n": 24, "seed": 42, "async": True}, JSON),
    ]
    assert len(reqs) == 16
    return reqs


def _serve_sixteen(front, reqs):
    out = []
    for path, body, ctype in reqs:
        raw = body if isinstance(body, bytes) else None
        code, resp = _http(front.url + path, None if raw else body, raw=raw, ctype=ctype)
        if code == 202:  # async: poll to the verdict
            deadline = time.monotonic() + 60
            href = resp["href"]
            while code == 202 or (code == 200 and "status" not in resp):
                assert time.monotonic() < deadline
                time.sleep(0.02)
                code, resp = _http(front.url + href)
            out.append(("async", code, resp))
        else:
            out.append(("sync", code, resp))
    return out


def test_the_two_servers_answer_the_same_sixteen_requests(tmp_path):
    reqs = _sixteen(tmp_path)
    answers = {}
    for pkg, mk in (("jax", _jax_front), ("torch", _torch_front)):
        svc, front = mk(batch=4, flush_s=0.01)
        try:
            answers[pkg] = _serve_sixteen(front, reqs)
        finally:
            front.shutdown()
            svc.shutdown()
    for k, (ref, port) in enumerate(zip(answers["jax"], answers["torch"])):
        assert port[:2] == ref[:2], (k, port, ref)
        assert set(port[2]) == set(ref[2]), (k, set(port[2]) ^ set(ref[2]))
        if "status" in ref[2]:
            assert port[2]["status"] == ref[2]["status"], k
        if ref[2].get("objective") is not None:
            o, r = port[2]["objective"], ref[2]["objective"]
            assert abs(o - r) <= 1e-8 * (1 + abs(r)), (k, o, r)
    codes = [a[1] for a in answers["torch"]]
    assert codes.count(200) == 13 and 504 in codes and 400 in codes and 404 in codes


def _drain_sequence(mk):
    # The linger outlasts any load on the machine: it ends when the
    # async verdict is fetched, not on a clock.
    svc, front = mk(net={"drain_linger_s": 60.0}, batch=4, flush_s=0.01)
    seq = []
    try:
        url = front.url
        seq.append(_http(url + "/readyz")[0])
        code, resp = _http(url + "/v1/solve", {"m": 8, "n": 24, "seed": 3, "async": True})
        seq.append(code)
        # Resolve the async request first: the drain then lingers for
        # its unclaimed verdict, so the listener stays up to be read.
        deadline = time.monotonic() + 60
        while not svc.stats()["requests"]:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        code, ack = _http(url + "/quitquitquit", {})
        seq += [code, ack.get("draining")]
        seq.append(_http(url + "/readyz")[0])
        seq.append(_http(url + "/healthz")[0])
        seq.append(_http(url + "/v1/solve", {"m": 8, "n": 24, "seed": 4})[1].get("reason"))
        code, out = _http(url + resp["href"])
        seq += [code, out.get("status")]
        deadline = time.monotonic() + 30
        while _http(url + "/healthz", timeout=2)[0] != 599:
            assert time.monotonic() < deadline, "listener never closed"
            time.sleep(0.05)
        seq.append("closed")
    finally:
        front.shutdown()
        svc.shutdown(drain=False)
    return seq


def test_drain_and_readiness_sequence_matches():
    ref = _drain_sequence(_jax_front)
    port = _drain_sequence(_torch_front)
    assert port == ref
    assert ref == [200, 202, 200, True, 503, 200, "draining", 200, "optimal", "closed"]


def _metric_names(text):
    return {ln.split("{")[0].split(" ")[0] for ln in text.splitlines() if ln and ln[0] != "#"}


def test_metrics_carry_the_reference_names():
    names = {}
    for pkg, mk in (("jax", _jax_front), ("torch", _torch_front)):
        svc, front = mk(batch=4, flush_s=0.01)
        try:
            for k in range(3):
                assert _http(front.url + "/v1/solve", {"m": 8, "n": 24, "seed": k})[0] == 200
            with urllib.request.urlopen(front.url + "/metrics", timeout=10) as r:
                names[pkg] = _metric_names(r.read().decode())
        finally:
            front.shutdown()
            svc.shutdown()
    assert names["jax"] <= names["torch"], names["jax"] - names["torch"]


def test_healthz_probes_the_services_device_and_statusz_sums_dispatches():
    svc, front = _torch_front(batch=4, flush_s=0.01)
    try:
        code, h = _http(front.url + "/healthz")
        assert code == 200 and h["devices_healthy"] == 1 and h["device"] == "cpu"
        assert _http(front.url + "/v1/solve", {"m": 8, "n": 24, "seed": 1})[0] == 200
        code, st = _http(front.url + "/statusz")
        tot = st["stats"]["dispatch_totals"]
        rows = svc.dispatch_report()
        assert tot["bodies"] == sum(r["bodies"] for r in rows) > 0
        assert tot["launches"] == sum(r["launches"] for r in rows)  # 0: no card here
        try:
            accel.simulate_device_loss(["cpu"])
            time.sleep(0.05)  # past the healthz cache
            code, h = _http(front.url + "/healthz")
            assert code == 503 and h["devices_healthy"] == 0 and h["devices_unhealthy"] == [-1]
        finally:
            accel.restore_devices()
        time.sleep(0.05)
        assert _http(front.url + "/healthz")[0] == 200
    finally:
        front.shutdown()
        svc.shutdown()


def test_the_torch_probe_touches_the_device_within_its_deadline(monkeypatch):
    assert accel.probe_device("cpu", deadline=5.0)
    import torch

    def hang(*a, **k):
        time.sleep(2.0)
        return torch.zeros(1)

    monkeypatch.setattr(torch, "full", hang)
    t0 = time.monotonic()
    assert not accel.probe_device("cpu", deadline=0.2)
    assert time.monotonic() - t0 < 1.5
    healthy, unhealthy = accel.probe_devices(["cpu"], deadline=0.2)
    assert healthy == [] and [d.type for d in unhealthy] == ["cpu"]


def test_a_cuda_service_without_a_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolveService(ServiceConfig(batch=4))


# -- router ---------------------------------------------------------------------


PKG_ROUTER = {"jax": (jrouter, JaxRegistry), "torch": (trouter, MetricsRegistry)}
STUBS = ["http://127.0.0.1:9", "http://127.0.0.1:10"]


def _events(path):
    return [{k: v for k, v in json.loads(ln).items() if k not in ("ts", "t_mono")}
            for ln in open(path) if ln.strip()]


def _breaker_run(pkg, log):
    mod, Registry = PKG_ROUTER[pkg]
    cfg = mod.RouterConfig(breaker_window=8, breaker_min_samples=4, breaker_error_rate=0.5,
                           breaker_hold_base_s=1.0, breaker_hold_cap_s=30.0, eject_after=2,
                           log_jsonl=str(log))
    r = mod.Router(list(STUBS), cfg, metrics=Registry())
    a, b = (r._backends[u] for u in STUBS)
    a.healthy = b.healthy = True
    trail = []
    for ok in (True, False, True, False, False, False):
        r._record_forward_outcome(STUBS[1], ok)
        trail.append((b.breaker, r.pick() is not None))
    b.breaker_until = 0.0  # the hold elapsed: the next pick is the trial
    picks = [r._pick_attributed() for _ in range(2)]
    trail.append([(p[0] if isinstance(p, tuple) else p) for p in picks])
    r._record_forward_outcome(STUBS[1], False, trial=True)  # failed trial: escalated hold
    trail.append((b.breaker, b.breaker_trips, round(b.breaker_hold_s, 6)))
    # Ejection: two failed probes of A, a stale success, then recovery.
    t0 = time.perf_counter()
    r._record_probe(STUBS[0], False, None)
    r._record_probe(STUBS[0], False, None)
    r._record_probe(STUBS[0], True, None, t_start=t0)  # began before the ejection
    trail.append((a.ejected, a.fails, round(a.backoff_s, 6)))
    r._record_probe(STUBS[0], True, {"stats": {"queue_depth": 3, "buckets": [[8, 24, 4]]},
                                     "net": {"inflight": 2}}, t_start=time.perf_counter())
    trail.append((a.ejected, a.queue_depth, a.inflight, a.buckets))
    r._note_forward_failure(STUBS[0])
    trail.append((a.ejected, a.fails))
    for k in range(12):
        r._observe_latency(STUBS[0], 10.0 + 7.0 * k)
    a.forwards = 5
    trail.append(r._hedge_delay_s(STUBS[0]))
    trail.append(r._hedge_delay_s(STUBS[1]))  # under-sampled: no guess
    st = r.statusz()
    trail.append([{k: v for k, v in row.items() if k not in ("last_poll_age_s",)}
                  for row in st["backends"]])
    r.shutdown()
    return trail, _events(log)


def test_router_breaker_ejection_and_hedge_delay_match(tmp_path):
    ref = _breaker_run("jax", tmp_path / "j.jsonl")
    port = _breaker_run("torch", tmp_path / "t.jsonl")
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    kinds = [e["event"] for e in ref[1]]
    assert {"breaker_open", "backend_ejected", "backend_readmitted"} <= set(kinds)


class _Stub(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _send(self, code, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", JSON)
        self.send_header("Content-Length", str(len(body)))
        self.send_header(tproto.PLANE_HEADER, tproto.PLANE_BACKEND)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        st = self.server.state
        if self.path.startswith("/statusz"):
            self._send(200, {"stats": {"queue_depth": 0, "buckets": [[8, 24, 4]]},
                             "net": {"inflight": 0}})
        elif self.path.startswith("/readyz"):
            self._send(200, {"status": "ready"})
        else:
            self._send(200, {"status": "ok" if st["healthy"] else "unhealthy"})

    def do_POST(self):  # noqa: N802
        n = int(self.headers.get("Content-Length", 0))
        self.rfile.read(n)
        st = self.server.state
        if self.path.startswith("/v1/cancel"):
            self._send(409, {"cancelled": False, "state": "dispatched"})
            return
        with st["lock"]:
            st["solves"] += 1
            k = st["solves"]
        delay = st["slow_s"] if st["slow_after"] is not None and k > st["slow_after"] else 0.005
        time.sleep(delay)
        self._send(200, {"id": k, "status": "optimal", "objective": 1.0, "queue_ms": 0.0})


def _stub(slow_after=None, slow_s=0.0):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    srv.daemon_threads = True
    srv.state = {"healthy": True, "solves": 0, "slow_after": slow_after, "slow_s": slow_s,
                 "lock": threading.Lock()}
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _hedge_run(pkg, log):
    mod, Registry = PKG_ROUTER[pkg]
    (sa, ua), (sb, ub) = _stub(slow_after=8, slow_s=1.5), _stub()
    r = mod.Router([ua, ub], mod.RouterConfig(poll_s=60.0, hedge_rate_cap=1.0,
                                              hedge_min_samples=4, log_jsonl=str(log)),
                   metrics=Registry()).start()
    h = mod.RouterHTTPServer(r, metrics=Registry()).start()
    try:
        for k in range(16):  # warm both digests
            code, out = _http(h.url + "/v1/solve", {"m": 8, "n": 24, "seed": k})
            assert code == 200 and out["status"] == "optimal"
        # A is now slow: requests routed to it must hedge to B.
        outcomes = {}
        deadline = time.monotonic() + 30
        while "hedge_won" not in outcomes and time.monotonic() < deadline:
            assert _http(h.url + "/v1/solve", {"m": 8, "n": 24, "seed": 99})[0] == 200
            outcomes = r.statusz()["hedging"]["outcomes"]
        return outcomes
    finally:
        h.shutdown()
        r.shutdown()
        sa.shutdown()
        sb.shutdown()


def test_a_slow_backend_is_hedged_in_both_packages(tmp_path):
    for pkg in ("jax", "torch"):
        outcomes = _hedge_run(pkg, tmp_path / f"{pkg}.jsonl")
        assert outcomes.get("hedge_won", 0) >= 1, (pkg, outcomes)
        ev = [e for e in _events(tmp_path / f"{pkg}.jsonl") if e["event"] == "hedge"]
        assert ev and ev[-1]["outcome"] == "hedge_won", pkg


def test_router_metrics_and_events_twin(tmp_path):
    """The twin of the reference's timing-dependent router test: it
    waits on the ejection event with a deadline instead of assuming one
    forward lands it."""
    log = tmp_path / "router.jsonl"
    svc, front = _torch_front(batch=4, flush_s=0.02, max_queue_depth=64)
    reg = MetricsRegistry()
    router = trouter.Router([front.url], trouter.RouterConfig(poll_s=0.1, log_jsonl=str(log)),
                            metrics=reg).start()
    rhttp = trouter.RouterHTTPServer(router, metrics=reg).start()
    try:
        assert _http(rhttp.url + "/v1/solve", {"m": 8, "n": 24, "seed": 9})[0] == 200
        front.shutdown()
        code, _ = _http(rhttp.url + "/v1/solve", {"m": 8, "n": 24, "seed": 10})
        assert code in (502, 503)
        deadline = time.monotonic() + 20
        while not any(e["event"] == "backend_ejected" for e in _events(log)):
            assert time.monotonic() < deadline, "no ejection event"
            time.sleep(0.05)
        with urllib.request.urlopen(rhttp.url + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "router_backend_healthy" in text and "router_routed_total" in text
    finally:
        rhttp.shutdown()
        router.shutdown()
        svc.shutdown()
    events = [json.loads(ln) for ln in open(log)]
    route = next(e for e in events if e["event"] == "route")
    assert route["m"] == 8 and route["backend"] == front.url
    assert all("ts" in e and "schema_version" in e for e in events)


def test_port_probe_net_passes_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "port_probe_net.py"), "--device", "cpu",
         "--requests", "200", "--budget-s", "150"],
        capture_output=True, text=True, timeout=200, cwd=ROOT,
        env={**os.environ, **SINGLE_THREAD},
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "PASS" in proc.stdout


def test_kernel_launches_are_attributed_to_the_launching_thread():
    """Two services in one process launch K1 from their own threads: each
    dispatch's count is its thread's, the process-wide count their sum."""
    from distributedlpsolver_tpu_torch.ops import kernel_build

    def wrapper():
        pass

    wrapper.launches = 0
    counts = {}

    def work(k):
        before = kernel_build.thread_launches(wrapper)
        for _ in range(200 * k):
            kernel_build.count_launch(wrapper)
        kernel_build.count_launch(wrapper, -k)  # a capture's calls taken back
        counts[k] = kernel_build.thread_launches(wrapper) - before

    threads = [threading.Thread(target=work, args=(k,)) for k in (1, 2, 3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counts == {1: 199, 2: 398, 3: 597}
    assert wrapper.launches == 199 + 398 + 597
    assert kernel_build.thread_launches(wrapper) == 0  # this thread launched none
