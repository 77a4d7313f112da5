"""Service telemetry records: per-request results and service-level
latency/throughput summaries (the serving analogue of the per-iteration
IterRecord stream — one JSONL record per request, plus batch and summary
events, all through utils/logging.IterLogger.event)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from distributedlpsolver_tpu_torch.ipm.state import FaultRecord, Status
from distributedlpsolver_tpu_torch.obs.stats import percentile as _percentile


@dataclasses.dataclass
class RequestResult:
    """Outcome of one service request, with the per-stage timing split:
    queue (submit → dispatch), pack (host pad + stack + device transfer,
    shared by batch-mates and pipelined against the previous dispatch's
    solve), compile (bucket program build, 0 on a warm bucket), solve
    (device batch wall, shared by batch-mates)."""

    request_id: int
    name: str
    status: Status
    objective: float
    x: Optional[np.ndarray]
    iterations: int
    rel_gap: float
    pinf: float
    dinf: float
    bucket: Optional[Tuple[int, int, int]]  # (m, n, batch); None = solo path
    queue_ms: float
    compile_ms: float
    solve_ms: float
    total_ms: float
    padding_waste: float
    dispatch_index: int = -1
    slot: int = -1
    retried_solo: bool = False
    faults: List[FaultRecord] = dataclasses.field(default_factory=list)
    # perf_counter() stamps at submit and completion — the service span
    # for throughput is first-submit → last-completion, not the slowest
    # single latency (which only matches when all requests arrive at once).
    t_submit: float = 0.0
    t_done: float = 0.0
    # Request shape as submitted — the autotuner's input (padding_waste
    # alone can't say what a tighter bucket should look like).
    m: int = 0
    n: int = 0
    # Pipeline stage split: host pack wall of this request's batch, and
    # how much of that batch's pack ran concurrently with an earlier
    # batch's device solve (nonzero = the pipeline actually overlapped).
    pack_ms: float = 0.0
    overlap_ms: float = 0.0
    # Warm-start outcome: "warm" (a cached prior iterate seeded the
    # solve), "rejected" (a cache hit was offered but the in-program
    # safeguard fell back to the cold start), "cold" otherwise.
    warm: str = "cold"
    # SLO-aware serving plane (net/): the submitting tenant and its
    # priority class — the keys the per-tenant queue-wait attribution
    # (and the starvation probe) split on.
    tenant: str = "default"
    priority: str = "normal"
    # Solve engine of the tolerance-tiered ladder ("ipm" | "pdhg" |
    # "scenario") — which compiled program family served this request.
    engine: str = "ipm"
    # Stochastic scenario tier (None/0 for plain requests): scenario
    # count, padded scenario-count bucket, and the decomposition's
    # per-stage wall split — batched per-scenario Schur programs
    # (schur_ms) vs the first-stage linking factor/solve (link_ms).
    n_scenarios: Optional[int] = None
    scenario_bucket: Optional[int] = None
    schur_ms: float = 0.0
    link_ms: float = 0.0
    # Distributed tracing (obs/context.py): the request's TraceContext
    # or None — stamped in the _finish funnel so the record and the
    # future's result agree on which trace this request belonged to.
    trace: Optional[object] = None

    def record(self) -> dict:
        """The JSONL record for this request (x is elided — solutions go
        back through the future, not the telemetry stream)."""
        rec = {
            "event": "request",
            "id": self.request_id,
            "name": self.name,
            "status": self.status.value,
            "objective": float(self.objective),
            "iterations": int(self.iterations),
            "rel_gap": float(self.rel_gap),
            "pinf": float(self.pinf),
            "dinf": float(self.dinf),
            "bucket": list(self.bucket) if self.bucket else None,
            "m": int(self.m),
            "n": int(self.n),
            "queue_ms": round(self.queue_ms, 3),
            "pack_ms": round(self.pack_ms, 3),
            "compile_ms": round(self.compile_ms, 3),
            "solve_ms": round(self.solve_ms, 3),
            "overlap_ms": round(self.overlap_ms, 3),
            "total_ms": round(self.total_ms, 3),
            "padding_waste": round(self.padding_waste, 4),
            "dispatch": self.dispatch_index,
            "slot": self.slot,
            "retried_solo": self.retried_solo,
            "warm": self.warm,
            "tenant": self.tenant,
            "priority": self.priority,
            "engine": self.engine,
            "faults": [f.asdict() for f in self.faults],
        }
        if self.n_scenarios:
            # Scenario requests only — plain request records stay
            # byte-identical to the pre-scenario schema.
            rec.update(
                n_scenarios=int(self.n_scenarios),
                scenario_bucket=(
                    int(self.scenario_bucket)
                    if self.scenario_bucket
                    else None
                ),
                schur_ms=round(self.schur_ms, 3),
                link_ms=round(self.link_ms, 3),
            )
        if self.trace is not None:
            # Traced requests only — untraced records stay byte-identical
            # to the pre-trace schema.
            rec["trace_id"] = self.trace.trace_id
            rec["span_id"] = self.trace.span_id
            if self.trace.parent_span_id:
                rec["parent_span_id"] = self.trace.parent_span_id
        return rec


def latency_summary(results: List[RequestResult]) -> dict:
    """p50/p95/p99 latency + throughput over completed requests — the
    service-level summary event emitted at drain/shutdown. Percentiles
    come from obs.stats — the one shared implementation (bench and the
    probes use the same one, so two reports of "p99" agree by
    construction)."""
    done = [r for r in results if r.status is not Status.TIMEOUT]
    totals = [r.total_ms for r in done]
    queues = [r.queue_ms for r in results]
    # Wall span from first submit to last completion; results built
    # without stamps (t_done unset) fall back to the burst approximation.
    stamped = [r for r in results if r.t_done > 0.0]
    if stamped:
        span_s = max(r.t_done for r in stamped) - min(
            r.t_submit for r in stamped
        )
    else:
        span_s = max(totals) / 1e3 if totals else 0.0
    by_status: dict = {}
    for r in results:
        by_status[r.status.value] = by_status.get(r.status.value, 0) + 1
    # Warm-vs-cold attribution: iterations-per-request and latency,
    # split by start kind (the amortization layer's headline figures).
    warm_rs = [r for r in done if r.warm == "warm"]
    cold_rs = [r for r in done if r.warm != "warm"]
    warm_split = {
        "requests": len(warm_rs),
        "rejected": sum(1 for r in results if r.warm == "rejected"),
        "iters_p50_warm": _percentile([r.iterations for r in warm_rs], 50),
        "iters_p50_cold": _percentile([r.iterations for r in cold_rs], 50),
        "latency_ms_p50_warm": round(
            _percentile([r.total_ms for r in warm_rs], 50), 3
        ),
        "latency_ms_p99_warm": round(
            _percentile([r.total_ms for r in warm_rs], 99), 3
        ),
        "latency_ms_p50_cold": round(
            _percentile([r.total_ms for r in cold_rs], 50), 3
        ),
        "latency_ms_p99_cold": round(
            _percentile([r.total_ms for r in cold_rs], 99), 3
        ),
    }
    return {
        "requests": len(results),
        "status_breakdown": by_status,
        "warm": warm_split,
        "latency_ms_p50": round(_percentile(totals, 50), 3),
        "latency_ms_p95": round(_percentile(totals, 95), 3),
        "latency_ms_p99": round(_percentile(totals, 99), 3),
        "latency_ms_max": round(max(totals), 3) if totals else 0.0,
        "queue_ms_p50": round(_percentile(queues, 50), 3),
        "queue_ms_p95": round(_percentile(queues, 95), 3),
        # Completed requests over the first-submit → last-completion wall
        # span; the load probe reports throughput over its own clock too.
        "throughput_rps": round(len(done) / span_s, 2) if span_s > 0 else 0.0,
        "mean_padding_waste": round(
            float(np.mean([r.padding_waste for r in results])), 4
        )
        if results
        else 0.0,
        "solo_retries": sum(1 for r in results if r.retried_solo),
        "faults": sum(len(r.faults) for r in results),
    }
