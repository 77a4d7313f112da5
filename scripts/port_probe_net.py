"""Network-plane load probe of the torch package: the twin of
``scripts/probe_net.py``. It drives the full router → 2-backend HTTP
serving topology of ``distributedlpsolver_tpu_torch`` in one process, on
``--device`` (the card by default; ``--device cpu`` for the host), and
prints the same verdict lines.

Topology (all on localhost ephemeral ports, all in this process so the
bucket-program cache is shared and warm rebuilds are countable):

    client threads → RouterHTTPServer → Router ──► backend A (SolveHTTPServer → SolveService)
                                              └──► backend B (killed mid-run)

Checks:
  - 200 HTTP requests across 2 tenants ("tight" — deadlined, high
    priority, weight 3; "loose" — an undeadlined flood, weight 1) all
    complete OPTIMAL — including the ones that were in flight toward
    backend B when its front-end is killed (failed over by the router's
    retry-once, never dropped);
  - zero warm recompiles across the whole load wave (bucket programs
    built only by the warm-up wave);
  - the tight-SLO tenant's p99 queue wait lands BELOW the loose
    tenant's under overload (EDF slot assignment + priority-shaded
    flush + weighted-fair admission doing their jobs), with the loose
    flood actually shedding (≥1 structured 429);
  - /metrics parses as Prometheus text on both a backend and the
    router (and carries the net_* / router_* families);
  - /healthz flips 200 → 503 on injected device loss and recovers.

Run: python scripts/port_probe_net.py [--requests N] [--budget-s S] [--device cuda|cpu]
Exit 0 iff every check passes.
"""

import argparse
import json
import os
import re
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distributedlpsolver_tpu_torch.backends.batched import bucket_cache_size  # noqa: E402
from distributedlpsolver_tpu_torch.net import NetConfig, SolveHTTPServer  # noqa: E402
from distributedlpsolver_tpu_torch.net.admission import (  # noqa: E402
    AdmissionConfig,
    TenantQuota,
)
from distributedlpsolver_tpu_torch.net.router import (  # noqa: E402
    Router,
    RouterConfig,
    RouterHTTPServer,
)
from distributedlpsolver_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402
from distributedlpsolver_tpu_torch.obs.stats import percentile  # noqa: E402
from distributedlpsolver_tpu_torch.utils.accel import (  # noqa: E402
    restore_devices,
    simulate_device_loss,
)
from distributedlpsolver_tpu_torch.serve import ServiceConfig, SolveService  # noqa: E402

SHAPES = ((8, 24), (12, 32))  # the standard serve-probe bucket shapes

# Prometheus text exposition: "# HELP/TYPE ..." comments plus
# "name{labels} value" samples.
_PROM_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [-+]?([0-9.eE+-]+|inf|nan)$"
)


def http_json(url, body=None, timeout=60.0):
    """(code, parsed_json) for one request; HTTP errors return their
    code + body instead of raising (the 429/503 paths are data here),
    and transport-level failures come back as a synthetic 599 so the
    caller's retry loop owns the decision instead of a dead thread."""
    req = urllib.request.Request(
        url,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"} if body else {},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read())
        except Exception:
            return e.code, {}
    except (urllib.error.URLError, socket.timeout, OSError,
            ConnectionError, ValueError) as e:
        return 599, {"error": f"{type(e).__name__}: {e}"}


def prom_valid(text):
    """True iff every non-comment, non-blank line is a well-formed
    sample line."""
    lines = [l for l in text.splitlines() if l and not l.startswith("#")]
    return bool(lines) and all(_PROM_SAMPLE.match(l) for l in lines)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument(
        "--budget-s", type=float, default=0.0,
        help="fail if the whole probe exceeds this wall time (0 = none)",
    )
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    t_probe = time.perf_counter()

    # Caps sized so the loose flood both QUEUES (deep enough for queue
    # waits to separate — EDF needs a queue to reorder) and SHEDS
    # (fairness engages at 24 in-system; the loose tenant's fair share
    # is 24 slots, and its 32 unpaced writers run past that).
    admission = AdmissionConfig(
        quotas={
            "tight": TenantQuota(weight=3.0),
            "loose": TenantQuota(weight=1.0),
        },
        fair_start=0.25,
    )
    svcs, fronts, regs = [], [], []
    print(f"device: {args.device}")
    for i in range(2):
        reg = MetricsRegistry()
        svc = SolveService(
            ServiceConfig(
                # batch=4 keeps the dispatch cadence fast: a
                # tight request's floor is the already-committed
                # pipeline (~3-4 batches it cannot preempt), so small
                # fast batches shrink that floor while the loose
                # tenant's 24-slot share still queues 6 batches deep.
                batch=4, flush_s=0.02, max_queue_depth=96,
                admission=admission,
                # SLO-sensitive pipeline setting: depth 1 commits fewer
                # popped batches ahead of the scheduler, so EDF can
                # reorder a late-arriving tight request in front of
                # queued loose work instead of behind two in-flight
                # batches of it.
                pipeline_depth=1,
            ),
            metrics=reg,
            device=args.device,
        )
        front = SolveHTTPServer(
            svc, NetConfig(healthz_cache_s=0.05), metrics=reg
        ).start()
        svcs.append(svc)
        fronts.append(front)
        regs.append(reg)
    router_reg = MetricsRegistry()
    # poll_s outlasts the WHOLE probe on purpose (start() still runs
    # one synchronous sweep, so both backends enter rotation): the
    # router must discover backend B's death through a failed forward
    # (the retry-once failover under test), not through a lucky health
    # poll racing ahead of the traffic — a poll landing between the
    # kill and the next forward to B marks it unhealthy below the
    # eject threshold and no failover is ever exercised. Hedging is off
    # for the same reason: on a loaded host a hedge launched toward A
    # while B's leg is slow wins when B dies, so the kill is absorbed
    # with no failover to count (scripts/port_probe_trace.py probes the
    # hedge).
    router = Router(
        [f.url for f in fronts],
        RouterConfig(poll_s=60.0, eject_after=2, hedge_enabled=False),
        metrics=router_reg,
    ).start()
    rhttp = RouterHTTPServer(router, metrics=router_reg).start()
    print(
        f"backends: {[f.url for f in fronts]}; router: {rhttp.url} "
        f"({router.healthy_count()} healthy)"
    )
    ok = True

    def fail(msg):
        nonlocal ok
        print(f"FAIL: {msg}")
        ok = False

    # -- warm-up: build every (shape, bucket) program once, through
    # both backends, so the load wave is a pure warm-path measurement.
    t0 = time.perf_counter()
    for front in fronts:
        for m, n in SHAPES:
            for seed in range(8):  # two full 4-slot buckets per shape
                code, out = http_json(
                    front.url + "/v1/solve",
                    {"m": m, "n": n, "seed": seed, "tenant": "warmup"},
                )
                if code != 200 or out.get("status") != "optimal":
                    fail(f"warm-up request failed: {code} {out}")
    cache0 = bucket_cache_size()
    print(
        f"warm-up: {len(fronts) * len(SHAPES) * 8} requests in "
        f"{time.perf_counter() - t0:.1f}s, {cache0} bucket programs compiled"
    )

    # -- main wave: a loose flood + a steady tight stream through the
    # router, backend B killed mid-run.
    n_total = args.requests
    n_tight = max(1, n_total * 3 // 10)
    n_loose = n_total - n_tight
    results = []
    rejects = {"tight": 0, "loose": 0}
    res_lock = threading.Lock()
    kill_at = n_total // 3  # responses collected before the kill
    killed = threading.Event()

    def drive(tenant, n, deadline_ms, priority, pace_s, delay_s=0.0):
        # The tight stream starts after the flood has formed real
        # queues: the acceptance scenario is a tight-SLO tenant
        # arriving INTO overload, not sharing the cold thundering-herd
        # surge with it.
        if delay_s:
            time.sleep(delay_s)
        rng_seed = 1000 if tenant == "tight" else 2000
        for k in range(n):
            m, n_ = SHAPES[k % len(SHAPES)]
            body = {
                "m": m, "n": n_, "seed": rng_seed + k,
                "tenant": tenant, "priority": priority,
                "id": f"{tenant}-{k}",
            }
            if deadline_ms:
                body["deadline_ms"] = deadline_ms
            deadline = time.perf_counter() + 120.0
            while True:
                code, out = http_json(rhttp.url + "/v1/solve", body)
                if code == 429:
                    with res_lock:
                        rejects[tenant] += 1
                    retry = float(out.get("retry_after_s", 0.02) or 0.02)
                    if time.perf_counter() + retry > deadline:
                        break
                    time.sleep(min(retry, 1.0))
                    continue
                if code in (502, 503, 599):
                    # Transport blip / no backend in rotation: the
                    # client's half of "no request lost" is to retry.
                    if time.perf_counter() > deadline:
                        break
                    time.sleep(0.05)
                    continue
                break
            with res_lock:
                results.append((tenant, code, out))
                done = len(results)
            if done >= kill_at and not killed.is_set():
                killed.set()
                fronts[1].shutdown()  # the mid-run backend kill
                print(f"  killed backend B after {done} responses")
            if pace_s:
                time.sleep(pace_s)

    t0 = time.perf_counter()
    threads = []
    # 32 unpaced loose writers = the overload (comfortably past the
    # loose tenant's 24-slot fair share); 4 gently paced tight writers
    # = the SLO traffic that must not starve behind it.
    for i in range(32):
        threads.append(threading.Thread(
            target=drive,
            args=("loose", n_loose // 32 + (i < n_loose % 32), 0,
                  "normal", 0.0),
            daemon=True,
        ))
    for i in range(4):
        threads.append(threading.Thread(
            target=drive,
            args=("tight", n_tight // 4 + (i < n_tight % 4), 60_000,
                  "high", 0.02, 0.25),
            daemon=True,
        ))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wave_wall = time.perf_counter() - t0
    recompiles = bucket_cache_size() - cache0

    n_ok = sum(
        1 for _, code, out in results
        if code == 200 and out.get("status") == "optimal"
    )
    print(
        f"load wave: {len(results)}/{n_total} responses in {wave_wall:.1f}s "
        f"({len(results) / max(wave_wall, 1e-9):.1f} rps), {n_ok} OPTIMAL, "
        f"429s: tight={rejects['tight']} loose={rejects['loose']}, "
        f"warm recompiles: {recompiles}"
    )
    if len(results) != n_total:
        fail(f"lost requests: {len(results)} of {n_total} got a response")
    if n_ok != len(results):
        bad = [
            (t, c, o.get("status"), o.get("error"))
            for t, c, o in results
            if c != 200 or o.get("status") != "optimal"
        ][:5]
        fail(f"not all OPTIMAL: {bad}")
    if recompiles != 0:
        fail(f"load wave compiled {recompiles} bucket programs (want 0)")

    # Failover actually exercised: B ejected, the router retried at
    # least one forward, and traffic kept completing afterwards.
    st = router.statusz()
    b_state = next(
        b for b in st["backends"] if b["url"] == fronts[1].url
    )
    print(
        f"  router: failovers={st['failovers']}, "
        f"B ejected={b_state['ejected']} (fails={b_state['fails']})"
    )
    if not b_state["ejected"]:
        fail("backend B was not ejected after the kill")
    if st["failovers"] < 1:
        fail("no forward was failed over (kill happened between requests?)")

    # SLO separation under overload: EDF + priority flush + fairness
    # must keep the tight tenant's queue waits below the flood's.
    tight_q = [
        o["queue_ms"] for t, c, o in results if t == "tight" and c == 200
    ]
    loose_q = [
        o["queue_ms"] for t, c, o in results if t == "loose" and c == 200
    ]
    p99_t, p99_l = percentile(tight_q, 99), percentile(loose_q, 99)
    print(
        f"  queue wait: tight p50={percentile(tight_q, 50):.0f}ms "
        f"p99={p99_t:.0f}ms | loose p50={percentile(loose_q, 50):.0f}ms "
        f"p99={p99_l:.0f}ms"
    )
    if not (p99_t < p99_l):
        fail(
            f"tight-SLO p99 queue wait {p99_t:.1f}ms not below loose "
            f"{p99_l:.1f}ms"
        )
    if rejects["loose"] < 1:
        fail(
            "loose flood never shed a 429 — the overload leg did not "
            "actually overload"
        )

    # -- /metrics validity on a live backend and the router.
    code, _ = http_json(fronts[0].url + "/healthz")
    if code != 200:
        fail(f"backend A healthz {code} while healthy")
    for label, url in (("backend A", fronts[0].url), ("router", rhttp.url)):
        req = urllib.request.Request(url + "/metrics")
        with urllib.request.urlopen(req, timeout=10) as r:
            text = r.read().decode()
        want = "net_requests_total" if label == "backend A" else (
            "router_backend_healthy"
        )
        if not prom_valid(text):
            fail(f"{label} /metrics is not valid Prometheus text")
        elif want not in text:
            fail(f"{label} /metrics lacks {want}")
        else:
            n_samples = sum(
                1 for l in text.splitlines() if l and not l.startswith("#")
            )
            print(f"  {label} /metrics: {n_samples} samples, parses clean")

    # -- /healthz flips on injected device loss, and recovers.
    try:
        simulate_device_loss([svcs[0].device])
        time.sleep(0.1)  # step past the healthz cache window
        code_lost, body_lost = http_json(fronts[0].url + "/healthz")
    finally:
        restore_devices()
    time.sleep(0.1)
    code_back, _ = http_json(fronts[0].url + "/healthz")
    print(
        f"  healthz flip: lost -> {code_lost} "
        f"({body_lost.get('devices_unhealthy')}), restored -> {code_back}"
    )
    if code_lost != 503:
        fail(f"healthz did not flip on device loss (got {code_lost})")
    if code_back != 200:
        fail(f"healthz did not recover after restore (got {code_back})")

    rhttp.shutdown()
    router.shutdown()
    fronts[0].shutdown()
    for svc in svcs:
        svc.shutdown()

    probe_wall = time.perf_counter() - t_probe
    if args.budget_s and probe_wall > args.budget_s:
        fail(f"probe took {probe_wall:.1f}s > budget {args.budget_s:.0f}s")
    print(f"probe wall: {probe_wall:.1f}s")
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
