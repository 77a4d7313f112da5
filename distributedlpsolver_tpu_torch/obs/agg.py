"""Plane-level telemetry aggregator: one fleet view from many processes.

The serving plane is a fleet of processes — routers, slice rank-0
front-ends, follower ranks — each exporting its own telemetry (``GET
/statusz`` + ``GET /metrics`` over HTTP; heartbeat + metrics-snapshot
files for followers that serve no HTTP; per-process Chrome-trace JSON
files from obs/trace.py, or ``torch.profiler``'s Chrome traces). This
module — a copy of the JAX package's ``obs/agg.py`` — pulls those
per-process views together into ONE fleet document:

- **Discovery** — backends come from the shared
  :class:`~distributedlpsolver_tpu_torch.net.registry.BackendRegistry` JSON
  (the same document routers coordinate through), follower ranks from
  heartbeat-directory scans (``rank*.hb`` + ``rank*.metrics.json``),
  and routers/extra backends from explicit URLs. Every source is
  best-effort: an unreachable process becomes an ``error`` row, never
  an aggregator crash — observing the fleet must not depend on the
  fleet being healthy.
- **Rollups** — per-backend request/latency/journal rows, per-slice
  rank tables, and fleet totals.
- **Trace merge** — N per-process Perfetto files become one: each
  source gets its own pid (Perfetto renders it as a separate process
  track), and every cross-process trace_id found in span args gets a
  flow-event chain (``ph: s/t/f``) stitching its spans together across
  pids, so one request's router-ingress → hedge-leg → backend-pipeline
  → CG spans render as one connected arc.
- **Exemplars** — histogram snapshots written as JSON (follower
  ``rank*.metrics.json``, ``--metrics-json`` files) carry the slowest
  observation's trace_id (obs/metrics.py exemplar slot); the fleet view
  surfaces them as a "slowest request, and here is its trace" table.
- **Reconciliation** — the router's hedge ledger, the backends' request
  records, and the journals' lifecycle counts are three independent
  counts of the same work; the reconciliation table lines them up and
  flags any drift (lost requests, double counts, unaccounted hedges).

Everything here is host-side, read-only, and out of process: the
aggregator never touches the device path, so the zero-warm-rebuild
invariant is untouched by construction.
"""

from __future__ import annotations

import json
import os
import re
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

# -- best-effort HTTP pulls ------------------------------------------------


def fetch_json(url: str, timeout_s: float = 2.0) -> Tuple[Optional[dict], str]:
    """GET ``url`` and parse JSON; returns ``(doc, "")`` or
    ``(None, error-string)`` — aggregation must degrade, not raise."""
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            doc = json.loads(resp.read().decode("utf-8"))
        return (doc if isinstance(doc, dict) else None), (
            "" if isinstance(doc, dict) else "non-object response"
        )
    except (urllib.error.URLError, OSError, ValueError) as exc:
        return None, str(exc)


def fetch_text(url: str, timeout_s: float = 2.0) -> Tuple[Optional[str], str]:
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return resp.read().decode("utf-8"), ""
    except (urllib.error.URLError, OSError, ValueError) as exc:
        return None, str(exc)


_PROM_LINE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*(?:\{[^}]*\})?)\s+(\S+)$")


def parse_prometheus(text: str) -> Dict[str, float]:
    """Minimal Prometheus text parser: ``{name{labels}: value}`` over
    sample lines (comments and malformed lines skipped). Enough to sum
    counters across the fleet; not a general exposition parser."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if not m:
            continue
        try:
            out[m.group(1)] = float(m.group(2))
        except ValueError:
            continue
    return out


# -- discovery -------------------------------------------------------------


_RANK_HB = re.compile(r"^rank(\d+)\.hb$")
_RANK_METRICS = re.compile(r"^rank(\d+)\.metrics\.json$")


def discover(
    registry_path: Optional[str] = None,
    heartbeat_dirs: Sequence[str] = (),
    routers: Sequence[str] = (),
    backends: Sequence[str] = (),
) -> dict:
    """Build the fleet's source list. Backends = registry entries ∪
    explicit URLs (registry metadata — slice_id, world_size, ejected —
    rides along); slices = one entry per heartbeat dir with every rank
    file found in it."""
    backend_meta: Dict[str, dict] = {}
    registry_doc: Optional[dict] = None
    if registry_path:
        from distributedlpsolver_tpu_torch.net.registry import BackendRegistry

        registry_doc = BackendRegistry(registry_path).load()
        for url, entry in sorted(registry_doc.get("backends", {}).items()):
            backend_meta[url.rstrip("/")] = dict(entry)
    for url in backends:
        backend_meta.setdefault(url.rstrip("/"), {})

    slices: List[dict] = []
    for hb_dir in heartbeat_dirs:
        ranks: Dict[int, dict] = {}
        try:
            names = sorted(os.listdir(hb_dir))
        except OSError as exc:
            slices.append({"dir": hb_dir, "error": str(exc), "ranks": {}})
            continue
        for name in names:
            path = os.path.join(hb_dir, name)
            m_hb = _RANK_HB.match(name)
            m_me = _RANK_METRICS.match(name)
            if not (m_hb or m_me):
                continue
            rank = int((m_hb or m_me).group(1))
            slot = ranks.setdefault(rank, {})
            try:
                with open(path) as fh:
                    doc = json.load(fh)
            except (OSError, ValueError) as exc:
                slot.setdefault("errors", []).append(f"{name}: {exc}")
                continue
            slot["heartbeat" if m_hb else "metrics"] = doc
        slices.append({"dir": hb_dir, "ranks": ranks})

    return {
        "registry": {
            "path": registry_path,
            "generation": (registry_doc or {}).get("generation"),
        },
        "routers": [u.rstrip("/") for u in routers],
        "backends": backend_meta,
        "slices": slices,
    }


def collect(discovery: dict, timeout_s: float = 2.0) -> dict:
    """Pull ``/statusz`` + ``/metrics`` from every discovered router and
    backend. Returns the fleet document skeleton (rollups/reconciliation
    attach to it afterwards)."""
    routers: Dict[str, dict] = {}
    for url in discovery["routers"]:
        stz, err = fetch_json(url + "/statusz", timeout_s)
        routers[url] = {"statusz": stz} if stz else {"error": err}

    backends: Dict[str, dict] = {}
    for url, meta in discovery["backends"].items():
        row: dict = {"registry": meta} if meta else {}
        stz, err = fetch_json(url + "/statusz", timeout_s)
        if stz is None:
            row["error"] = err
        else:
            row["statusz"] = stz
            text, _ = fetch_text(url + "/metrics", timeout_s)
            if text is not None:
                row["metrics"] = parse_prometheus(text)
        backends[url] = row

    return {
        "collected_ts": time.time(),
        "registry": discovery["registry"],
        "routers": routers,
        "backends": backends,
        "slices": discovery["slices"],
    }


# -- rollups ---------------------------------------------------------------


def rollup(fleet: dict) -> dict:
    """Condense the raw pulls into per-backend rows + fleet totals."""
    rows = []
    totals = {
        "backends": 0,
        "reachable": 0,
        "requests": 0,
        "http_requests": 0,
        "journal_pending": 0,
        "journal_results": 0,
        "dispatches": 0,
        "programs_compiled": 0,
    }
    for url, row in sorted(fleet["backends"].items()):
        totals["backends"] += 1
        stz = row.get("statusz")
        reg = row.get("registry", {})
        if stz is None:
            rows.append(
                {"url": url, "reachable": False, "error": row.get("error", "")}
            )
            continue
        totals["reachable"] += 1
        stats = stz.get("stats") or {}
        net = stz.get("net") or {}
        journal = stats.get("journal") or {}
        out = {
            "url": url,
            "reachable": True,
            "slice_id": reg.get("slice_id"),
            "world_size": reg.get("world_size"),
            "ejected": reg.get("ejected", False),
            "uptime_s": round(float(stz.get("uptime_s", 0.0)), 1),
            "http_requests": int(net.get("requests_total", 0)),
            "requests": int(stats.get("requests", 0)),
            "status_breakdown": stats.get("status_breakdown", {}),
            "latency_ms_p50": stats.get("latency_ms_p50"),
            "latency_ms_p99": stats.get("latency_ms_p99"),
            "queue_depth": stats.get("queue_depth"),
            "dispatches": int(stats.get("dispatches", 0)),
            "programs_compiled": int(stats.get("programs_compiled", 0)),
            "journal": journal or None,
        }
        rows.append(out)
        totals["requests"] += out["requests"]
        totals["http_requests"] += out["http_requests"]
        totals["dispatches"] += out["dispatches"]
        totals["programs_compiled"] += out["programs_compiled"]
        totals["journal_pending"] += int(journal.get("pending", 0))
        totals["journal_results"] += int(journal.get("results", 0))

    slice_rows = []
    for sl in fleet["slices"]:
        ranks = []
        for rank in sorted(sl.get("ranks", {})):
            slot = sl["ranks"][rank]
            hb = slot.get("heartbeat") or {}
            ranks.append(
                {
                    "rank": rank,
                    "pid": hb.get("pid"),
                    "generation": hb.get("generation"),
                    "has_metrics": "metrics" in slot,
                }
            )
        slice_rows.append(
            {
                "dir": sl.get("dir"),
                "world_size_seen": len(ranks),
                "ranks": ranks,
                **({"error": sl["error"]} if "error" in sl else {}),
            }
        )
    return {"backends": rows, "totals": totals, "slices": slice_rows}


def exemplars(fleet: dict, metrics_json: Sequence[str] = ()) -> List[dict]:
    """Histogram exemplars across the fleet: every JSON metrics snapshot
    (follower ``rank*.metrics.json`` files + explicit ``--metrics-json``
    paths) whose histograms recorded a slowest-observation trace_id.
    Sorted slowest-first — the fleet's 'worst request, and here is the
    trace to open' table."""
    out: List[dict] = []

    def _scan(source: str, snap: dict) -> None:
        for name, val in snap.items():
            if isinstance(val, dict) and isinstance(
                val.get("exemplar"), dict
            ):
                ex = val["exemplar"]
                out.append(
                    {
                        "source": source,
                        "metric": name,
                        "value": ex.get("value"),
                        "trace_id": ex.get("trace_id"),
                    }
                )

    def _unwrap(snap: dict) -> dict:
        # Follower files wrap the registry snapshot with identity
        # stamps ({"rank": k, ..., "metrics": {...}}); bare snapshots
        # (--metrics-json files) are the registry dict itself.
        inner = snap.get("metrics")
        return inner if isinstance(inner, dict) else snap

    for sl in fleet["slices"]:
        for rank, slot in sorted(sl.get("ranks", {}).items()):
            snap = slot.get("metrics")
            if isinstance(snap, dict):
                _scan(f"{sl.get('dir')}:rank{rank}", _unwrap(snap))
    for path in metrics_json:
        try:
            with open(path) as fh:
                snap = json.load(fh)
        except (OSError, ValueError):
            continue
        if isinstance(snap, dict):
            _scan(path, _unwrap(snap))
    out.sort(key=lambda e: -(e["value"] or 0.0))
    return out


# -- trace merge -----------------------------------------------------------


def _flow_id(trace_id: str) -> int:
    # Chrome flow events key on an integer id; 15 hex digits of the
    # trace_id keep it unique-in-practice and inside int64.
    try:
        return int(trace_id[:15], 16)
    except (TypeError, ValueError):
        return abs(hash(trace_id)) & 0x7FFFFFFF


def merge_traces(sources: Sequence[Tuple[str, str]]) -> dict:
    """Merge per-process Chrome-trace files into one fleet trace.

    ``sources`` is ``[(label, path), ...]``. Each source becomes its own
    pid (process track) with ``label`` as its process_name; every event
    keeps its original tid (thread lanes stay intact inside each
    process). Spans carrying the same ``args.trace_id`` (or listing it
    in ``args.trace_ids``) across sources get a flow chain — ``s`` at
    the first span, ``t`` through the middle, ``f`` at the last — which
    Perfetto renders as connecting arrows: the visual proof that ONE
    request crossed router → backend → pipeline → solver.
    """
    events: List[dict] = []
    errors: List[dict] = []
    # trace_id -> [(ts, pid, tid)] anchor points for flow stitching.
    anchors: Dict[str, List[Tuple[float, int, int]]] = {}

    for idx, (label, path) in enumerate(sources):
        pid = idx + 1
        try:
            with open(path) as fh:
                doc = json.load(fh)
            src_events = doc["traceEvents"]
        except (OSError, ValueError, KeyError, TypeError) as exc:
            errors.append({"source": label, "path": path, "error": str(exc)})
            continue
        named = False
        for ev in src_events:
            if not isinstance(ev, dict):
                continue
            ev = dict(ev)
            ev["pid"] = pid
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                # One process_name per source; prefix with the label so
                # the fleet view says which file each track came from.
                orig = (ev.get("args") or {}).get("name", "")
                ev["args"] = {"name": f"{label} ({orig})" if orig else label}
                named = True
            args = ev.get("args")
            if isinstance(args, dict):
                ids = []
                if isinstance(args.get("trace_id"), str):
                    ids.append(args["trace_id"])
                if isinstance(args.get("trace_ids"), list):
                    ids.extend(
                        t for t in args["trace_ids"] if isinstance(t, str)
                    )
                ts = ev.get("ts")
                if ids and isinstance(ts, (int, float)):
                    for tid_ in dict.fromkeys(ids):
                        anchors.setdefault(tid_, []).append(
                            (float(ts), pid, ev.get("tid", 0))
                        )
            events.append(ev)
        if not named:
            events.append(
                {
                    "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": label},
                }
            )

    # Flow stitching: one chain per trace_id that has ≥2 anchor points.
    traces_connected = 0
    for trace_id, pts in sorted(anchors.items()):
        if len(pts) < 2:
            continue
        pts.sort()
        traces_connected += 1
        fid = _flow_id(trace_id)
        for i, (ts, pid, tid) in enumerate(pts):
            ph = "s" if i == 0 else ("f" if i == len(pts) - 1 else "t")
            ev = {
                "ph": ph, "name": "trace", "cat": "trace_flow", "id": fid,
                "ts": ts, "pid": pid, "tid": tid,
                "args": {"trace_id": trace_id},
            }
            if ph == "f":
                ev["bp"] = "e"  # bind to enclosing slice
            events.append(ev)

    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "clock": "perf_counter_us",
            "sources": [label for label, _ in sources],
            "traces_connected": traces_connected,
            **({"merge_errors": errors} if errors else {}),
        },
    }


def trace_summary(merged: dict) -> dict:
    """Cross-process span census of a merged trace: per-trace_id span
    count and the set of pids it touched — what the probe asserts on
    ('one trace_id, ≥4 spans, ≥2 processes')."""
    spans: Dict[str, dict] = {}
    for ev in merged.get("traceEvents", []):
        if ev.get("ph") not in ("X", "i", "b", "e"):
            continue
        args = ev.get("args")
        if not isinstance(args, dict):
            continue
        ids = []
        if isinstance(args.get("trace_id"), str):
            ids.append(args["trace_id"])
        if isinstance(args.get("trace_ids"), list):
            ids.extend(t for t in args["trace_ids"] if isinstance(t, str))
        for tid_ in dict.fromkeys(ids):
            slot = spans.setdefault(
                tid_, {"spans": 0, "pids": set(), "names": []}
            )
            slot["spans"] += 1
            slot["pids"].add(ev.get("pid", 1))
            if len(slot["names"]) < 64:
                slot["names"].append(ev.get("name", ""))
    return {
        tid_: {
            "spans": slot["spans"],
            "processes": len(slot["pids"]),
            "names": slot["names"],
        }
        for tid_, slot in sorted(spans.items())
    }


# -- reconciliation --------------------------------------------------------


def reconcile(fleet: dict) -> dict:
    """Line up the three independent counts of the same work:

    1. the routers' hedge ledger (forwards launched, hedges launched,
       per-outcome tallies, cancels),
    2. the backends' request records (``stats.requests`` — one per
       completed solve), and
    3. the journals' lifecycle counts (pending + results files).

    Each check reports ``ok`` / ``mismatch`` with the numbers that went
    in, or ``skipped`` with the reason (no routers, unreachable
    backends, journal off) — a reconciliation that silently ignored
    missing data would be worse than none.
    """
    router_rows = []
    forwards = hedges = cancels = outcomes_sum = budget_exhausted = 0
    failovers = 0
    outcomes_total: Dict[str, int] = {}
    routers_ok = 0
    for url, row in sorted(fleet["routers"].items()):
        stz = row.get("statusz")
        if stz is None:
            router_rows.append(
                {"url": url, "reachable": False, "error": row.get("error", "")}
            )
            continue
        routers_ok += 1
        hed = stz.get("hedging") or {}
        out = {k: int(v) for k, v in (hed.get("outcomes") or {}).items()}
        # Suppressed outcomes (rate cap / budget) tally hedge ATTEMPTS
        # that never launched a leg — they must not count against
        # hedges_launched or the backend-record balance.
        launched_out = {
            k: v for k, v in out.items() if not k.startswith("suppressed_")
        }
        router_rows.append(
            {
                "url": url,
                "reachable": True,
                "forwards_total": int(hed.get("forwards_total", 0)),
                "hedges_launched": int(hed.get("hedges_launched", 0)),
                "outcomes": out,
                "cancels": int(hed.get("cancels", 0)),
                "budget_exhausted": int(hed.get("budget_exhausted", 0)),
                "failovers": int(stz.get("failovers", 0)),
            }
        )
        forwards += router_rows[-1]["forwards_total"]
        hedges += router_rows[-1]["hedges_launched"]
        cancels += router_rows[-1]["cancels"]
        budget_exhausted += router_rows[-1]["budget_exhausted"]
        failovers += router_rows[-1]["failovers"]
        outcomes_sum += sum(launched_out.values())
        for k, v in out.items():
            outcomes_total[k] = outcomes_total.get(k, 0) + v

    backend_records = 0
    backends_ok = backends_total = 0
    journal_results = journal_pending = 0
    journal_backends = 0
    journal_records = 0  # records on backends that also report a journal
    for row in fleet["backends"].values():
        backends_total += 1
        stz = row.get("statusz")
        if stz is None:
            continue
        backends_ok += 1
        stats = stz.get("stats") or {}
        n = int(stats.get("requests", 0))
        backend_records += n
        journal = stats.get("journal") or {}
        if journal:
            journal_backends += 1
            journal_results += int(journal.get("results", 0))
            journal_pending += int(journal.get("pending", 0))
            journal_records += n

    checks = []

    def _check(name: str, **kw) -> None:
        checks.append({"name": name, **kw})

    if routers_ok == 0:
        _check("hedge_outcomes_accounted", status="skipped",
               reason="no reachable routers")
    else:
        # Launched (non-suppressed) outcomes must sum to hedges_launched
        # — every launched hedge has exactly one recorded outcome.
        _check(
            "hedge_outcomes_accounted",
            status="ok" if outcomes_sum == hedges else "mismatch",
            hedges_launched=hedges,
            launched_outcomes_sum=outcomes_sum,
            outcomes=outcomes_total,
        )

    # Every routed attempt (primary forward + hedge leg) that was not
    # cancelled before dispatch must have produced exactly one backend
    # request record. delta > 0 = lost work; delta < 0 = double count
    # (or a backend also serving un-routed traffic).
    if routers_ok == 0 or backends_ok < backends_total:
        _check(
            "attempts_vs_backend_records",
            status="skipped",
            reason=(
                "no reachable routers"
                if routers_ok == 0
                else f"{backends_total - backends_ok} backend(s) unreachable"
            ),
        )
    else:
        attempts = forwards + hedges
        delta = attempts - backend_records
        ok = delta == 0 if cancels == 0 else 0 <= delta <= cancels
        # Failover retries blur the balance: a failed attempt may or may
        # not have produced a backend record depending on how it failed.
        # Report indeterminate rather than a false mismatch.
        status = (
            "ok"
            if ok
            else ("indeterminate" if failovers or cancels else "mismatch")
        )
        _check(
            "attempts_vs_backend_records",
            status=status,
            attempts=attempts,
            forwards_total=forwards,
            hedges_launched=hedges,
            backend_records=backend_records,
            cancels=cancels,
            failovers=failovers,
            delta=delta,
        )

    # Journal lifecycle: on journal-enabled backends every recorded
    # request is a completed job (results file) and every admitted-but-
    # unfinished job is pending — records == results when drained.
    if journal_backends == 0:
        _check("journal_vs_backend_records", status="skipped",
               reason="no backend reports a journal")
    else:
        _check(
            "journal_vs_backend_records",
            status="ok" if journal_results == journal_records else "mismatch",
            journal_results=journal_results,
            journal_pending=journal_pending,
            backend_records=journal_records,
            journal_backends=journal_backends,
        )

    return {
        "routers": router_rows,
        "totals": {
            "forwards_total": forwards,
            "hedges_launched": hedges,
            "cancels": cancels,
            "budget_exhausted": budget_exhausted,
            "failovers": failovers,
            "outcomes": outcomes_total,
            "backend_records": backend_records,
            "journal_results": journal_results,
            "journal_pending": journal_pending,
        },
        "checks": checks,
        "consistent": all(c["status"] != "mismatch" for c in checks),
    }


# -- the one-call fleet view ----------------------------------------------


def fleet_view(
    registry_path: Optional[str] = None,
    heartbeat_dirs: Sequence[str] = (),
    routers: Sequence[str] = (),
    backends: Sequence[str] = (),
    traces: Sequence[Tuple[str, str]] = (),
    metrics_json: Sequence[str] = (),
    timeout_s: float = 2.0,
) -> Tuple[dict, Optional[dict]]:
    """Discover → collect → rollup → reconcile (+ optional trace merge).
    Returns ``(fleet_doc, merged_trace_or_None)``."""
    disc = discover(registry_path, heartbeat_dirs, routers, backends)
    fleet = collect(disc, timeout_s=timeout_s)
    fleet["rollup"] = rollup(fleet)
    fleet["exemplars"] = exemplars(fleet, metrics_json)
    fleet["reconciliation"] = reconcile(fleet)
    merged = None
    if traces:
        merged = merge_traces(traces)
        fleet["trace_summary"] = trace_summary(merged)
    return fleet, merged


def render_text(fleet: dict) -> str:
    """Human-readable fleet report (the ``cli obs-agg`` stdout body)."""
    lines: List[str] = []
    roll = fleet.get("rollup", {})
    totals = roll.get("totals", {})
    lines.append(
        f"fleet: {totals.get('reachable', 0)}/{totals.get('backends', 0)} "
        f"backends reachable, {len(fleet.get('routers', {}))} router(s), "
        f"{len(fleet.get('slices', []))} slice dir(s)"
    )
    lines.append("")
    lines.append("backends:")
    for row in roll.get("backends", []):
        if not row.get("reachable"):
            lines.append(f"  {row['url']}  UNREACHABLE ({row.get('error')})")
            continue
        j = row.get("journal") or {}
        lines.append(
            f"  {row['url']}  req={row['requests']} http={row['http_requests']}"
            f" p50={row['latency_ms_p50']}ms p99={row['latency_ms_p99']}ms"
            f" dispatches={row['dispatches']}"
            f" journal={j.get('results', '-')}/{j.get('pending', '-')}"
            + (f" slice={row['slice_id']}" if row.get("slice_id") else "")
            + (" EJECTED" if row.get("ejected") else "")
        )
    for sl in roll.get("slices", []):
        lines.append(
            f"  slice dir {sl['dir']}: {sl['world_size_seen']} rank(s) "
            + ", ".join(
                f"r{r['rank']}(pid={r['pid']}"
                + (",metrics" if r["has_metrics"] else "")
                + ")"
                for r in sl["ranks"]
            )
        )
    ex = fleet.get("exemplars") or []
    if ex:
        lines.append("")
        lines.append("slowest observations (histogram exemplars):")
        for e in ex[:10]:
            lines.append(
                f"  {e['metric']} = {e['value']}  trace={e['trace_id']}"
                f"  [{e['source']}]"
            )
    rec = fleet.get("reconciliation") or {}
    if rec:
        lines.append("")
        t = rec.get("totals", {})
        lines.append(
            "reconciliation: "
            f"forwards={t.get('forwards_total')} "
            f"hedges={t.get('hedges_launched')} "
            f"outcomes={t.get('outcomes')} cancels={t.get('cancels')} | "
            f"backend_records={t.get('backend_records')} | "
            f"journal results={t.get('journal_results')} "
            f"pending={t.get('journal_pending')}"
        )
        for c in rec.get("checks", []):
            status = c["status"].upper()
            extra = {
                k: v for k, v in c.items() if k not in ("name", "status")
            }
            lines.append(f"  [{status}] {c['name']} {extra}")
        lines.append(
            "  => " + ("CONSISTENT" if rec.get("consistent") else "DRIFT")
        )
    ts = fleet.get("trace_summary")
    if ts is not None:
        lines.append("")
        lines.append(f"merged trace: {len(ts)} trace_id(s)")
        for tid_, slot in list(ts.items())[:10]:
            lines.append(
                f"  {tid_}: {slot['spans']} span(s) across "
                f"{slot['processes']} process(es)"
            )
    return "\n".join(lines) + "\n"
