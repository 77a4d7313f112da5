"""``cli report``: turn the telemetry we already write into answers.

Ingests any mix of the package's JSONL streams — per-iteration rows
(IterLogger), per-request serve records, per-dispatch batch events,
supervisor fault/resume events — plus JSON metric snapshots, and builds
one merged report: per-phase latency breakdowns (p50/p95/p99),
padding-waste-by-bucket tables, recovery-overhead summaries, and the
iters/sec trajectory (the paper's published metric, now reconstructable
from any crash log).

Backward compatibility is a hard requirement: older files carry no
``schema_version``/``ts``/``t_mono`` stamps, and iteration rows never
carry an ``"event"`` key. The loader classifies records by shape, never
by stamp.

Reconciliation: over a service's own log, ``requests.count`` equals
``SolveService.stats()["requests"]`` and ``dispatches.count`` equals
``stats()["dispatches"]`` exactly — both sides count one record per
finished request and one ``batch`` event per bucket dispatch (solo-path
requests never dispatch a bucket, on either side).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from distributedlpsolver_tpu_torch.obs.stats import summarize

_REQUEST_PHASES = ("queue_ms", "pack_ms", "compile_ms", "solve_ms", "total_ms")


def load_file(path: str) -> Tuple[List[dict], Optional[dict], int]:
    """(jsonl_records, metrics_snapshot, skipped) from one file. A file
    holding a single JSON object (the ``write_snapshot`` output) is a
    snapshot; anything else is treated as newline-delimited records.
    Unparseable lines are SKIPPED AND COUNTED, never fatal — a crash
    log's torn final record (the process died mid-write) is exactly the
    file this loader exists for, and the count surfaces in the report
    so a truncation is a visible warning, not silence."""
    with open(path) as fh:
        text = fh.read()
    stripped = text.strip()
    if stripped.startswith("{"):
        # A whole file that parses as ONE dict (possibly pretty-printed)
        # is a snapshot — unless it looks like a single JSONL record.
        try:
            obj = json.loads(stripped)
            if isinstance(obj, dict) and "event" not in obj and "iter" not in obj:
                return [], obj, 0
        except ValueError:
            pass
    records = []
    skipped = 0
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            skipped += 1
            continue
        if isinstance(rec, dict):
            records.append(rec)
        else:
            skipped += 1
    return records, None, skipped


def build_report(
    records: Sequence[dict], metrics: Optional[dict] = None
) -> dict:
    """Aggregate classified records into the report dict ``render``
    prints (and ``--json`` emits verbatim)."""
    iter_rows = [r for r in records if "event" not in r and "iter" in r]
    events: Dict[str, List[dict]] = {}
    for r in records:
        if "event" in r:
            events.setdefault(r["event"], []).append(r)

    requests = events.get("request", [])
    batches = events.get("batch", [])
    faults = events.get("fault", [])
    resumes = events.get("resume", [])

    report: dict = {
        "records": len(records),
        "events_by_type": {
            k: len(v) for k, v in sorted(events.items())
        },
        "stamped_records": sum(1 for r in records if "schema_version" in r),
    }

    # -- per-phase request latency ---------------------------------------
    by_status: Dict[str, int] = {}
    for r in requests:
        s = r.get("status", "?")
        by_status[s] = by_status.get(s, 0) + 1
    # Warm-vs-cold split (the amortization layer's headline columns):
    # median iterations-per-request and p50/p99 latency by start kind.
    # Legacy records carry no "warm" field and count as cold.
    by_warm: Dict[str, int] = {}
    warm_iters: List[float] = []
    cold_iters: List[float] = []
    warm_lat: List[float] = []
    cold_lat: List[float] = []
    for r in requests:
        wl = r.get("warm") or "cold"
        by_warm[wl] = by_warm.get(wl, 0) + 1
        (warm_iters if wl == "warm" else cold_iters).append(
            float(r.get("iterations", 0))
        )
        (warm_lat if wl == "warm" else cold_lat).append(
            float(r.get("total_ms", 0.0))
        )
    report["requests"] = {
        "count": len(requests),
        "by_status": by_status,
        "solo_retries": sum(1 for r in requests if r.get("retried_solo")),
        "warm": {
            "by_start": by_warm,
            "iterations_warm": summarize(warm_iters, quantiles=(50, 99)),
            "iterations_cold": summarize(cold_iters, quantiles=(50, 99)),
            "latency_ms_warm": summarize(warm_lat, quantiles=(50, 99)),
            "latency_ms_cold": summarize(cold_lat, quantiles=(50, 99)),
        },
        "phases": {
            ph: summarize([r.get(ph, 0.0) for r in requests])
            for ph in _REQUEST_PHASES
        },
    }

    # -- padding waste by bucket -----------------------------------------
    buckets: Dict[str, dict] = {}
    for r in requests:
        b = r.get("bucket")
        key = "solo" if not b else "x".join(str(int(v)) for v in b)
        row = buckets.setdefault(
            key, {"requests": 0, "dispatches": set(), "waste": [],
                  "total_ms": []}
        )
        row["requests"] += 1
        if r.get("dispatch", -1) >= 0:
            row["dispatches"].add(r["dispatch"])
        row["waste"].append(float(r.get("padding_waste", 0.0)))
        row["total_ms"].append(float(r.get("total_ms", 0.0)))
    for b in events.get("batch", []):
        key = "x".join(str(int(v)) for v in b.get("bucket", [])) or "?"
        row = buckets.setdefault(
            key, {"requests": 0, "dispatches": set(), "waste": [],
                  "total_ms": []}
        )
        row["dispatches"].add(b.get("dispatch", -1))
    report["padding_by_bucket"] = {
        key: {
            "requests": row["requests"],
            "dispatches": len(row["dispatches"]),
            "waste_mean": round(
                sum(row["waste"]) / len(row["waste"]), 4
            ) if row["waste"] else 0.0,
            "waste": summarize(row["waste"]),
            "total_ms": summarize(row["total_ms"]),
        }
        for key, row in sorted(buckets.items())
    }

    # -- dispatches ------------------------------------------------------
    solve_tot = sum(float(b.get("solve_ms") or 0.0) for b in batches)
    overlap_tot = sum(float(b.get("overlap_ms") or 0.0) for b in batches)
    report["dispatches"] = {
        "count": len(batches),
        "attempts": sum(int(b.get("attempts", 1)) for b in batches),
        "live_slots": sum(int(b.get("live", 0)) for b in batches),
        "pack_ms": summarize([float(b.get("pack_ms") or 0.0) for b in batches]),
        "solve_ms": summarize(
            [float(b.get("solve_ms") or 0.0) for b in batches]
        ),
        "overlap_ms": summarize(
            [float(b.get("overlap_ms") or 0.0) for b in batches]
        ),
        # Fraction of device-solve wall that had host pack running under
        # it — the pipeline's realized overlap across the whole stream.
        "overlap_ratio": round(overlap_tot / solve_tot, 4)
        if solve_tot > 0 else 0.0,
    }

    # -- faults & recovery -----------------------------------------------
    by_kind: Dict[str, int] = {}
    by_action: Dict[str, int] = {}
    for f in faults:
        by_kind[f.get("kind", "?")] = by_kind.get(f.get("kind", "?"), 0) + 1
        a = f.get("action") or "?"
        by_action[a] = by_action.get(a, 0) + 1
    # world_reinit events (distributed/launcher: coordinator-level
    # world re-initializations) carry recovery_overhead_s exactly like
    # resume events — the multi-host rung joins the same summary.
    overheads = [
        float(r["recovery_overhead_s"])
        for r in resumes + events.get("world_reinit", [])
        if r.get("recovery_overhead_s") is not None
    ]
    report["faults"] = {
        "count": len(faults),
        "by_kind": by_kind,
        "by_action": by_action,
        "rejects": len(events.get("reject", [])),
        "dispatch_errors": len(events.get("dispatch_error", [])),
        "reshards": len(events.get("reshard", [])),
        "ladder_swaps": len(events.get("ladder_swap", [])),
    }
    report["recovery"] = {
        "resumes": len(resumes),
        "world_reinits": len(events.get("world_reinit", [])),
        "overhead_s": summarize(overheads),
        "overhead_s_total": round(sum(overheads), 6),
    }

    # -- scenario tier (stochastic two-stage requests) -------------------
    scen_rs = [r for r in requests if r.get("n_scenarios")]
    scen_buckets: Dict[str, dict] = {}
    for r in scen_rs:
        key = str(int(r.get("scenario_bucket") or 0))
        row = scen_buckets.setdefault(
            key, {"count": 0, "k_max": 0, "total_ms": [], "schur_ms": [],
                  "link_ms": []}
        )
        row["count"] += 1
        row["k_max"] = max(row["k_max"], int(r.get("n_scenarios", 0)))
        row["total_ms"].append(float(r.get("total_ms", 0.0)))
        row["schur_ms"].append(float(r.get("schur_ms", 0.0)))
        row["link_ms"].append(float(r.get("link_ms", 0.0)))
    report["scenario"] = {
        "solves": len(scen_rs),
        "by_bucket": {
            key: {
                "count": row["count"],
                "k_max": row["k_max"],
                "total_ms": summarize(row["total_ms"], quantiles=(50, 99)),
                "schur_ms": summarize(row["schur_ms"], quantiles=(50,)),
                "link_ms": summarize(row["link_ms"], quantiles=(50,)),
            }
            for key, row in sorted(
                scen_buckets.items(), key=lambda kv: int(kv[0])
            )
        },
    }

    # -- durability (crash-safe serving fabric) --------------------------
    replays = events.get("journal_replay", [])
    drains = events.get("drain", [])
    report["durability"] = {
        "journal_replays": len(replays),
        "replayed": sum(int(r.get("replayed", 0)) for r in replays),
        "reenqueued": sum(int(r.get("reenqueued", 0)) for r in replays),
        "expired": sum(int(r.get("expired", 0)) for r in replays),
        "torn_tails": sum(int(r.get("torn", 0)) for r in replays),
        "drains": sum(1 for d in drains if d.get("phase") == "begin"),
        "registry_writes": len(events.get("registry_write", [])),
    }

    # -- iteration trajectory --------------------------------------------
    t_iters = [float(r.get("t_iter", 0.0)) for r in iter_rows]
    total_t = sum(t_iters)
    traj = []
    if iter_rows:
        # Windowed iters/sec over the row sequence (~10 windows): the
        # trajectory that shows a solve slowing down (endgame, faults)
        # rather than one flat average.
        w = max(1, len(iter_rows) // 10)
        for i in range(0, len(iter_rows), w):
            chunk = t_iters[i:i + w]
            tt = sum(chunk)
            traj.append(
                {
                    "rows": [i + 1, i + len(chunk)],
                    "iters_per_sec": round(len(chunk) / tt, 3)
                    if tt > 0 else None,
                    "rel_gap_last": iter_rows[
                        min(i + w, len(iter_rows)) - 1
                    ].get("rel_gap"),
                }
            )
    report["iterations"] = {
        "count": len(iter_rows),
        "time_s": round(total_t, 6),
        "iters_per_sec": round(len(iter_rows) / total_t, 3)
        if total_t > 0 else None,
        "t_iter_s": summarize(t_iters, quantiles=(50, 95, 99)),
        "trajectory": traj,
    }

    if metrics:
        report["metrics"] = metrics
    return report


def _fmt_phase_table(phases: Dict[str, dict]) -> List[str]:
    lines = [
        f"  {'phase':<12} {'count':>6} {'p50':>10} {'p95':>10} "
        f"{'p99':>10} {'max':>10}"
    ]
    for name, s in phases.items():
        lines.append(
            f"  {name:<12} {s['count']:>6} {s['p50']:>10.3f} "
            f"{s['p95']:>10.3f} {s['p99']:>10.3f} {s['max']:>10.3f}"
        )
    return lines


def render(report: dict) -> str:
    """Human-readable rendering of ``build_report``'s dict."""
    out: List[str] = []
    req = report["requests"]
    out.append(
        f"records: {report['records']} "
        f"({report['stamped_records']} stamped, "
        f"{report['records'] - report['stamped_records']} legacy)"
    )
    if report.get("skipped_lines"):
        # A torn final record is the expected crash artifact — counted
        # loudly, parsed around quietly.
        out.append(
            f"warning: {report['skipped_lines']} unparseable line(s) "
            f"skipped (torn/truncated records)"
        )
    if report["events_by_type"]:
        out.append(
            "events: "
            + ", ".join(
                f"{k}={v}" for k, v in report["events_by_type"].items()
            )
        )

    if req["count"]:
        out.append("")
        out.append(
            f"requests: {req['count']} "
            f"(status: "
            + ", ".join(f"{k}={v}" for k, v in sorted(req["by_status"].items()))
            + (f"; solo retries: {req['solo_retries']}"
               if req["solo_retries"] else "")
            + ")"
        )
        out.append("per-phase latency (ms):")
        out.extend(_fmt_phase_table(req["phases"]))
        wm = req.get("warm")
        if wm and wm["by_start"].get("warm"):
            out.append(
                "warm-vs-cold ("
                + ", ".join(
                    f"{k}={v}" for k, v in sorted(wm["by_start"].items())
                )
                + "):"
            )
            out.append(
                f"  {'start':<12} {'count':>6} {'iters_p50':>10} "
                f"{'lat_p50':>10} {'lat_p99':>10}"
            )
            for kind in ("warm", "cold"):
                it_s = wm[f"iterations_{kind}"]
                lat_s = wm[f"latency_ms_{kind}"]
                out.append(
                    f"  {kind:<12} {it_s['count']:>6} {it_s['p50']:>10.1f} "
                    f"{lat_s['p50']:>10.3f} {lat_s['p99']:>10.3f}"
                )

    pb = report["padding_by_bucket"]
    if pb:
        out.append("")
        out.append("padding waste by bucket:")
        out.append(
            f"  {'bucket':<16} {'requests':>8} {'dispatches':>10} "
            f"{'waste_mean':>10} {'waste_p95':>10} {'total_p50ms':>11}"
        )
        for key, row in pb.items():
            out.append(
                f"  {key:<16} {row['requests']:>8} {row['dispatches']:>10} "
                f"{row['waste_mean']:>10.4f} {row['waste']['p95']:>10.4f} "
                f"{row['total_ms']['p50']:>11.3f}"
            )

    scen = report.get("scenario") or {}
    if scen.get("solves"):
        out.append("")
        out.append(f"scenario tier: {scen['solves']} solves")
        out.append(
            f"  {'k_bucket':<10} {'count':>6} {'k_max':>6} "
            f"{'total_p50':>10} {'total_p99':>10} {'schur_p50':>10} "
            f"{'link_p50':>10}"
        )
        for key, row in scen["by_bucket"].items():
            out.append(
                f"  {key:<10} {row['count']:>6} {row['k_max']:>6} "
                f"{row['total_ms']['p50']:>10.3f} "
                f"{row['total_ms']['p99']:>10.3f} "
                f"{row['schur_ms']['p50']:>10.3f} "
                f"{row['link_ms']['p50']:>10.3f}"
            )

    disp = report["dispatches"]
    if disp["count"]:
        out.append("")
        out.append(
            f"dispatches: {disp['count']} ({disp['attempts']} attempts, "
            f"{disp['live_slots']} live slots); "
            f"solve p50={disp['solve_ms']['p50']:.3f}ms "
            f"pack p50={disp['pack_ms']['p50']:.3f}ms "
            f"overlap ratio={disp['overlap_ratio']:.2%}"
        )

    fl = report["faults"]
    if fl["count"] or fl["rejects"] or fl["reshards"] or fl["ladder_swaps"]:
        out.append("")
        out.append(
            f"faults: {fl['count']}"
            + (" by kind: " + ", ".join(
                f"{k}={v}" for k, v in sorted(fl["by_kind"].items())
            ) if fl["by_kind"] else "")
            + (" | actions: " + ", ".join(
                f"{k}={v}" for k, v in sorted(fl["by_action"].items())
            ) if fl["by_action"] else "")
        )
        extras = [
            f"{name}={fl[name]}"
            for name in ("rejects", "dispatch_errors", "reshards",
                         "ladder_swaps")
            if fl[name]
        ]
        if extras:
            out.append("  " + ", ".join(extras))
    rec = report["recovery"]
    if rec["resumes"]:
        o = rec["overhead_s"]
        out.append(
            f"recovery: {rec['resumes']} resumes, overhead "
            f"p50={o['p50']:.3f}s p99={o['p99']:.3f}s "
            f"total={rec['overhead_s_total']:.3f}s"
        )
    dur = report.get("durability") or {}
    if dur.get("journal_replays") or dur.get("drains") or dur.get(
        "registry_writes"
    ):
        out.append(
            f"durability: {dur['journal_replays']} journal replays "
            f"({dur['reenqueued']} re-enqueued, {dur['expired']} expired "
            f"honest-TIMEOUT, {dur['torn_tails']} torn tails), "
            f"{dur['drains']} drains, "
            f"{dur['registry_writes']} registry writes"
        )

    it = report["iterations"]
    if it["count"]:
        out.append("")
        out.append(
            f"iterations: {it['count']} in {it['time_s']:.3f}s"
            + (f" ({it['iters_per_sec']:.2f} iters/sec)"
               if it["iters_per_sec"] else "")
        )
        if it["trajectory"] and len(it["trajectory"]) > 1:
            out.append("iters/sec trajectory:")
            for w in it["trajectory"]:
                ips = w["iters_per_sec"]
                gap = w["rel_gap_last"]
                out.append(
                    f"  rows {w['rows'][0]:>5}-{w['rows'][1]:<5} "
                    + (f"{ips:>9.2f} it/s" if ips is not None
                       else f"{'—':>9}      ")
                    + (f"  rel_gap={gap:.3e}" if gap is not None else "")
                )

    if "metrics" in report:
        out.append("")
        out.append(f"metrics snapshot: {len(report['metrics'])} instruments")
        for name, val in report["metrics"].items():
            if isinstance(val, dict):
                out.append(
                    f"  {name}: count={val.get('count', 0)} "
                    f"sum={val.get('sum', 0.0):g}"
                )
            else:
                out.append(f"  {name}: {val:g}")
    return "\n".join(out)


def report_from_paths(paths: Sequence[str]) -> dict:
    """Load every path (JSONL streams and/or snapshot JSON files) and
    build the merged report."""
    records: List[dict] = []
    metrics: dict = {}
    skipped = 0
    for p in paths:
        recs, snap, skip = load_file(p)
        records.extend(recs)
        skipped += skip
        if snap:
            metrics.update(snap)
    rep = build_report(records, metrics=metrics or None)
    rep["files"] = list(paths)
    rep["skipped_lines"] = skipped
    return rep
