"""Distributed-tracing acceptance probe of the torch package: the twin of
``scripts/probe_trace.py``, one trace across a plane of
``distributedlpsolver_tpu_torch`` processes, its backends on ``--device``
(the card by default; ``--device cpu`` for the host). It prints the same
verdict lines.

A live 2-backend plane behind a hedging router, every process writing
its own Chrome-trace file. Legs:

  warm      → identical general-form MPS solves (solo path, the
              sparse-iterative CG engine) through the router until
              every backend's latency digest can drive a hedge delay;
  hedge     → SIGSTOP one backend and keep sending: a request routed
              to the frozen primary must hedge to the sibling — both
              legs carry the SAME trace_id as sibling spans;
  reconcile → `cli obs-agg` against the live plane: the router's hedge
              ledger, the backends' request records, and the journals'
              lifecycle counts must line up EXACTLY (checks all ok,
              forwards_total == solves sent);
  merge     → graceful drain (traces flush), then `cli obs-agg --trace`
              merges the three per-process files: the hedged request's
              trace_id must connect >= 4 spans across >= 2 processes —
              router ingress + hedge legs + backend pipeline + solver
              depth (ipm.iter / cg.solve) — in one Perfetto artifact.

Run: python scripts/port_probe_trace.py [--budget-s S] [--device cuda|cpu]
Exit 0 iff every check passes.
"""

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distributedlpsolver_tpu_torch.net.chaos import ChaosPlane  # noqa: E402
from distributedlpsolver_tpu_torch.net.router import RouterConfig  # noqa: E402

# Tiny general-form LP (inequality rows -> the per-request solo path,
# pinned to the sparse-iterative backend so the solve emits CG spans).
MPS_TEXT = """NAME          TRACEPROBE
ROWS
 N  COST
 G  R1
 G  R2
COLUMNS
    X         COST      1.0        R1        1.0
    X         R2        3.0
    Y         COST      1.0        R1        2.0
    Y         R2        1.0
RHS
    RHS       R1        3.0        R2        4.0
ENDATA
"""


def http_json(url, body=None, timeout=60.0):
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
    except (urllib.error.URLError, OSError, ConnectionError, ValueError) as e:
        return 599, {"error": f"{type(e).__name__}: {e}"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget-s", type=float, default=0.0)
    ap.add_argument("--keep-workdir", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    t_probe = time.perf_counter()

    workdir = tempfile.mkdtemp(prefix="dlps-trace-")
    plane = ChaosPlane(workdir, device=args.device)
    registry_path = os.path.join(workdir, "registry.json")
    route_log = os.path.join(workdir, "router.jsonl")
    traces = {
        name: os.path.join(workdir, f"{name}.trace.json")
        for name in ("router-1", "backend-a", "backend-b")
    }

    ok = True

    def fail(msg):
        nonlocal ok
        print(f"FAIL: {msg}")
        ok = False

    # -- plane: 2 solo-path backends + a hedging router ------------------
    for name in ("backend-a", "backend-b"):
        plane.spawn_backend(
            name,
            extra_flags=[
                "--flush-ms", "20", "--batch", "2",
                "--solo-backend", "sparse-iterative",
                "--trace-path", traces[name],
                "--metrics-path",
                os.path.join(workdir, f"{name}.metrics.txt"),
            ],
        )
    for name in ("backend-a", "backend-b"):
        if not plane.wait_ready(plane.procs[name], 180):
            fail(f"{name} did not come up")
            plane.shutdown_all()
            print("FAIL")
            return 1
    router = plane.spawn_router(
        "router-1",
        [plane.procs[n].url for n in ("backend-a", "backend-b")],
        registry_path,
        extra_flags=[
            "--hedge-rate-cap", "0.5",
            "--retry-budget", "50", "--retry-budget-burst", "50",
            "--log-jsonl", route_log,
            "--trace-path", traces["router-1"],
        ],
    )
    if not plane.wait_ready(router, 60):
        fail("router did not come up")
        plane.shutdown_all()
        print("FAIL")
        return 1
    print(f"plane up: 2 backends behind {router.url}")

    def statusz(url=None):
        c, o = http_json((url or router.url) + "/statusz", timeout=5.0)
        return o if c == 200 else {}

    sent = 0

    def wave(n, tenant, conc=2, timeout=90.0):
        nonlocal sent
        base = sent
        lock = threading.Lock()
        resp = []

        def one(k):
            code, out = http_json(
                router.url + "/v1/solve",
                {"mps_text": MPS_TEXT, "tenant": tenant,
                 "id": f"{tenant}-{base + k}", "tol": 1e-6},
                timeout=timeout,
            )
            with lock:
                resp.append((code, out))

        ts = []
        for k in range(n):
            t = threading.Thread(target=one, args=(k,), daemon=True)
            t.start()
            ts.append(t)
            if len(ts) % conc == 0:
                time.sleep(0.02)
        for t in ts:
            t.join(timeout=timeout + 30)
        sent += n
        return resp

    # -- warm leg: every digest must be able to drive a hedge delay ------
    need = RouterConfig().hedge_min_samples
    while sent < 60:
        resp = wave(4, "warm")
        bad = [
            (c, o) for c, o in resp
            if not (c == 200 and o.get("status") == "optimal")
        ]
        if bad:
            fail(f"warm solve failed: {bad[:3]}")
            break
        fwd = [b.get("forwards", 0) for b in statusz().get("backends", [])]
        if fwd and min(fwd) >= need:
            break
    fwd = [b.get("forwards", 0) for b in statusz().get("backends", [])]
    print(f"warm: {sent} solves; per-backend forwards={fwd} (need {need})")
    if not fwd or min(fwd) < need:
        fail(f"digests never warmed: forwards={fwd}")

    # -- hedge leg: freeze one backend, a routed request must hedge ------
    # The router breaks load ties round-robin, and the frozen backend's
    # load stays at its last polled value: freeze it only while it is in
    # rotation and both backends' polled loads agree, or every request may
    # route around it. A freeze lasts until a hedge launches or ~3 s (the
    # router's probes would eject the frozen backend soon after); then the
    # backend thaws, and the leg tries again until its deadline.
    url_a = plane.procs["backend-a"].url

    def ready_to_freeze():
        rows = statusz().get("backends", [])
        a_in = any(b["url"] == url_a and b.get("healthy") and not b.get("ejected")
                   for b in rows)
        return a_in and len({(b.get("queue_depth"), b.get("inflight"), b.get("live"))
                             for b in rows}) == 1

    hedged = 0
    deadline = time.monotonic() + 90.0
    while not hedged and time.monotonic() < deadline:
        t_wait = time.monotonic() + 20.0
        while not ready_to_freeze() and time.monotonic() < t_wait:
            time.sleep(0.05)
        plane.sigstop("backend-a")
        print("[hedge] SIGSTOP backend-a")
        t_thaw = time.monotonic() + 3.0
        while not hedged and time.monotonic() < t_thaw:
            resp = wave(1, "hedge", timeout=60.0)
            c, o = resp[0]
            if not (c == 200 and o.get("status") == "optimal"):
                fail(f"hedge-leg solve without honest verdict: {c} {o}")
                deadline = 0.0
                break
            outcomes = statusz().get("hedging", {}).get("outcomes", {})
            hedged = sum(
                v for k, v in outcomes.items()
                if not k.startswith("suppressed_")
            )
        if not hedged:
            plane.sigcont("backend-a")
    plane.sigcont("backend-a")
    h = statusz().get("hedging", {})
    print(
        f"[hedge] SIGCONT backend-a; launched={h.get('hedges_launched')} "
        f"outcomes={h.get('outcomes')}"
    )
    if not hedged:
        fail("no hedge ever launched against the frozen primary")

    # The thawed primary finishes its stalled leg: wait until backend
    # request records balance the router's attempt ledger.
    expect = h.get("forwards_total", 0) + h.get("hedges_launched", 0)
    deadline = time.monotonic() + 30.0
    records = -1
    while time.monotonic() < deadline:
        records = sum(
            int((statusz(plane.procs[n].url).get("stats") or {})
                .get("requests", 0))
            for n in ("backend-a", "backend-b")
        )
        if records >= expect:
            break
        time.sleep(0.2)
    print(f"[hedge] attempt ledger {expect} vs backend records {records}")

    # -- reconcile leg: obs-agg over the LIVE plane ----------------------
    agg_out = os.path.join(workdir, "agg")
    proc = subprocess.run(
        [sys.executable, "-m", "distributedlpsolver_tpu_torch.cli", "obs-agg",
         "--registry", registry_path, "--router", router.url,
         "--out", agg_out, "--json"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        fail(f"obs-agg (live plane) exited {proc.returncode}: "
             f"{proc.stderr[-500:]}")
        fleet = {}
    else:
        fleet = json.loads(proc.stdout)
    rec = fleet.get("reconciliation", {})
    checks = {c["name"]: c for c in rec.get("checks", [])}
    print(f"[reconcile] checks="
          f"{ {k: v['status'] for k, v in checks.items()} }")
    if not rec.get("consistent"):
        fail(f"reconciliation reports drift: {rec.get('checks')}")
    for name in ("hedge_outcomes_accounted", "attempts_vs_backend_records",
                 "journal_vs_backend_records"):
        if checks.get(name, {}).get("status") != "ok":
            fail(f"reconciliation check {name} not ok: {checks.get(name)}")
    if rec.get("totals", {}).get("forwards_total") != sent:
        fail(
            f"ledger forwards_total {rec.get('totals', {}).get('forwards_total')} "
            f"!= {sent} solves sent"
        )

    # -- the hedged request's trace_id (from the router's hedge event) ---
    hedge_trace_id = None
    try:
        with open(route_log) as fh:
            for line in fh:
                try:
                    e = json.loads(line)
                except ValueError:
                    continue
                if e.get("event") == "hedge" and e.get("trace_id"):
                    hedge_trace_id = e["trace_id"]
    except OSError:
        pass
    if not hedge_trace_id:
        fail("no hedge event carried a trace_id in the router JSONL")

    # -- drain: flush every process's trace artifact ---------------------
    for name in ("backend-a", "backend-b"):
        http_json(plane.procs[name].url + "/quitquitquit", body={},
                  timeout=10.0)
    os.kill(router.pid, signal.SIGINT)
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        if all(os.path.exists(p) for p in traces.values()):
            break
        time.sleep(0.2)
    missing = [n for n, p in traces.items() if not os.path.exists(p)]
    if missing:
        fail(f"trace artifacts never flushed: {missing}")

    # -- merge leg: one connected Perfetto artifact ----------------------
    if not missing and hedge_trace_id:
        merge_out = os.path.join(workdir, "agg-merge")
        proc = subprocess.run(
            [sys.executable, "-m", "distributedlpsolver_tpu_torch.cli",
             "obs-agg", "--out", merge_out, "--json"]
            + [a for n in traces for a in ("--trace", f"{n}={traces[n]}")],
            capture_output=True, text=True, timeout=60,
            )
        if proc.returncode != 0:
            fail(f"obs-agg (merge) exited {proc.returncode}: "
                 f"{proc.stderr[-500:]}")
        else:
            fleet2 = json.loads(proc.stdout)
            summary = (fleet2.get("trace_summary") or {}).get(
                hedge_trace_id, {}
            )
            names = summary.get("names", [])
            print(
                f"[merge] trace {hedge_trace_id}: {summary.get('spans')} "
                f"spans across {summary.get('processes')} processes"
            )
            if summary.get("spans", 0) < 4:
                fail(f"hedged trace has {summary.get('spans')} spans (<4)")
            if summary.get("processes", 0) < 2:
                fail(
                    f"hedged trace crossed {summary.get('processes')} "
                    f"process(es) (<2)"
                )
            if not any(n.startswith("route.") for n in names):
                fail(f"no router span in the hedged trace: {names}")
            if not any(
                n.startswith("ipm.") or n.startswith("cg.") for n in names
            ):
                fail(f"no solver-depth span in the hedged trace: {names}")
            merged_path = os.path.join(merge_out, "trace_merged.json")
            try:
                with open(merged_path) as fh:
                    merged = json.load(fh)
                evs = merged["traceEvents"]
                flows = [
                    e for e in evs
                    if e.get("cat") == "trace_flow"
                    and (e.get("args") or {}).get("trace_id")
                    == hedge_trace_id
                ]
                if not (
                    any(e["ph"] == "s" for e in flows)
                    and any(e["ph"] == "f" for e in flows)
                ):
                    fail(
                        f"hedged trace has no complete flow chain "
                        f"({[e.get('ph') for e in flows]})"
                    )
                else:
                    print(
                        f"[merge] {len(evs)} events, flow chain of "
                        f"{len(flows)} over {merged_path}"
                    )
            except (OSError, ValueError, KeyError) as e:
                fail(f"merged Perfetto artifact unreadable: {e}")

    plane.shutdown_all()
    if not args.keep_workdir and ok:
        shutil.rmtree(workdir, ignore_errors=True)
    elif not ok:
        print(f"workdir kept for post-mortem: {workdir}")

    probe_wall = time.perf_counter() - t_probe
    if args.budget_s and probe_wall > args.budget_s:
        fail(f"probe took {probe_wall:.1f}s > budget {args.budget_s:.0f}s")
    print(f"probe wall: {probe_wall:.1f}s")
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
