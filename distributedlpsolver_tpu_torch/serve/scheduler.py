"""Micro-batch scheduler: per-bucket queues, flush policy, admission
control, and deadline accounting.

Flush policy (continuous batching): a bucket launches when it holds a
full batch, or when a member's age exceeds its *effective* flush window
``flush_s * flush_scale`` — the knob that trades padding waste (early
flushes dispatch part-full buckets) against tail latency (late flushes
make the first request wait for batch-mates). ``flush_scale`` is the
priority shading the SLO-aware admission layer (net/admission.py)
assigns per request: a high-priority request shrinks its bucket's
flush window, a batch-priority request stretches it.

Slot assignment inside one bucket is earliest-deadline-first: ``pop``
orders the queue by absolute deadline (deadline-less requests sort
last, FIFO among themselves), so a tight-SLO request never waits behind
loose ones that happened to arrive earlier. Deadlines are checked at
pop time: a request whose deadline passed while queued is split out of
the batch and returned TIMEOUT without ever occupying a slot — an
expired request can never poison its batch-mates' dispatch.

Admission control layers: the scheduler keeps the global bounded depth
across all buckets (submit past ``max_depth`` raises
:class:`ServiceOverloaded` — backpressure is the caller's signal to
shed load; queueing unboundedly just converts overload into timeout
storms), and the service consults the per-tenant token-bucket /
weighted-fair :class:`~distributedlpsolver_tpu_torch.net.admission.
AdmissionController` before the depth check when one is configured.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics
from distributedlpsolver_tpu_torch.serve.buckets import BucketSpec, BucketTable


class ServiceOverloaded(RuntimeError):
    """Admission control rejected a submit.

    Carries the structured verdict so callers (the HTTP front-end's 429
    path, the CLI's backoff loop) can act on it instead of blind
    retrying: ``reason`` is ``"depth"`` (global queue bound),
    ``"quota"`` (the tenant's token bucket is empty), ``"fair"`` (the
    tenant is past its weighted fair share under contention) or
    ``"draining"`` (the service is gracefully shutting down — retry on
    a different backend); ``retry_after_s`` is the earliest time a
    retry can plausibly succeed (the HTTP Retry-After header value).
    """

    def __init__(
        self,
        message: str,
        reason: str = "depth",
        retry_after_s: float = 0.0,
        tenant: str = "default",
    ):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.tenant = tenant


@dataclasses.dataclass
class PendingRequest:
    """One queued request (standard form: min cᵀx, Ax=b, x≥0)."""

    request_id: int
    name: str
    c: np.ndarray
    A: np.ndarray
    b: np.ndarray
    tol: float
    future: object  # concurrent.futures.Future
    t_submit: float
    deadline: Optional[float] = None  # absolute perf_counter() time
    problem: object = None  # general-form LPProblem (solo path only)
    # Structural fingerprint (utils/fingerprint.structural_fingerprint):
    # the warm-cache key computed at submit; None = warm start disabled.
    fp: Optional[str] = None
    # SLO-aware serving plane (net/): who submitted this request and in
    # which priority class; flush_scale is the priority's shading of the
    # bucket flush window (1.0 = the plain flush_s).
    tenant: str = "default"
    priority: str = "normal"
    flush_scale: float = 1.0
    # Solve engine of the tolerance-tiered ladder: "ipm" (bucketed
    # batched IPM) or "pdhg" (bucketed batched first-order; requests at
    # tol ≥ ServiceConfig.pdhg_tol). A first-class bucket dimension —
    # engines never mix in one dispatch, each compiles its own program.
    engine: str = "ipm"
    # Durable job journal (serve/journal.py): the job id minted at
    # admit (the restart-stable poll token) and the request content
    # fingerprint (the crash-retry idempotency key). None = no journal.
    jid: Optional[str] = None
    jfp: Optional[str] = None
    # Stochastic scenario tier: fair-share units this request charges
    # against admission (ceil(K / scenario_k_unit) for a K-scenario
    # solve, 1 otherwise), the scenario count, and the padded
    # scenario-count bucket (models/scenario.scenario_k_bucket) — the
    # scheduler's scenario queue dimension and the records' K-bucket.
    units: int = 1
    n_scenarios: Optional[int] = None
    scenario_bucket: Optional[int] = None
    # Distributed tracing (obs/context.py): the TraceContext this
    # request arrived with (the router leg's child span) or None. Pure
    # host-side metadata — it rides spans, JSONL records, and the
    # journal, never the solve itself.
    trace: Optional[object] = None

    @property
    def m(self) -> int:
        return self.A.shape[0] if self.A is not None else self.problem.m

    @property
    def n(self) -> int:
        return self.A.shape[1] if self.A is not None else self.problem.n


# Queue key: the bucket spec plus the request tolerance plus the solve
# ENGINE — tol is part of the compiled program's static params, so mixing
# tolerances in one batch would either recompile per dispatch or solve
# some requests to the wrong tolerance, and the engine (bucketed IPM vs
# bucketed PDHG, the tolerance-tiered routing of the serve ladder) picks
# which compiled program family the dispatch runs. Requests at a novel
# (tol, engine) pay one compile and then share it.
QueueKey = Tuple[BucketSpec, float, str]


class Scheduler:
    """Owns the per-bucket queues; all methods require the service lock."""

    def __init__(
        self,
        table: BucketTable,
        max_depth: int,
        flush_s: float,
        metrics: Optional[obs_metrics.MetricsRegistry] = None,
    ):
        self.table = table
        self.max_depth = max_depth
        self.flush_s = flush_s
        self._queues: Dict[QueueKey, deque] = {}
        self._depth = 0
        # Queue-side instruments (no-ops under the default NULL
        # registry): depth is the serving system's single most-watched
        # gauge, and admission rejections are its overload signal.
        m = metrics if metrics is not None else obs_metrics.get_registry()
        self._m_depth = m.gauge(
            "serve_queue_depth", help="requests queued across all buckets"
        )
        self._m_rejects = m.counter(
            "serve_admission_rejections_total",
            help="submits rejected by admission control",
        )

    def depth(self) -> int:
        return self._depth

    def occupancy(self) -> dict:
        return {
            f"{k[0].m}x{k[0].n}x{k[0].batch}@{k[1]:g}/{k[2]}": len(q)
            for k, q in self._queues.items()
            if q
        }

    def add(self, p: PendingRequest, exempt: bool = False) -> QueueKey:
        # ``exempt`` re-enqueues journal-replayed jobs past the depth
        # bound: they were admitted before the crash and are owed a
        # verdict — the bound gates NEW work, and a replacement backend
        # replaying a dead member's WAL under live load must not
        # resolve that backlog FAILED just because its own queue is
        # busy.
        if not exempt and self._depth >= self.max_depth:
            self._m_rejects.inc()
            raise ServiceOverloaded(
                f"queue depth {self._depth} at max_queue_depth="
                f"{self.max_depth}; shed load or raise the bound",
                reason="depth",
                # One flush window is the natural drain granularity: by
                # then at least one bucket has dispatched (or nothing is
                # moving and the caller should back off harder anyway).
                retry_after_s=self.flush_s,
                tenant=p.tenant,
            )
        if p.A is None:  # general form: solo pseudo-bucket (batch of 1)
            # Scenario requests get a scenario-bucket queue dimension:
            # same padded-K jobs queue (and compile) together, and the
            # occupancy surface shows the K-bucket mix.
            eng = (
                f"scenario:k{p.scenario_bucket}"
                if p.engine == "scenario"
                else "ipm"
            )
            key = (BucketSpec(p.m, p.n, 1), p.tol, eng)
        else:
            key = (self.table.spec_for(p.m, p.n), p.tol, p.engine)
        self._queues.setdefault(key, deque()).append(p)
        self._depth += 1
        self._m_depth.set(self._depth)
        return key

    def ready(self, now: float) -> List[QueueKey]:
        """Keys whose bucket should launch now: full, holding a member
        aged past its effective flush window (``flush_s`` shaded by the
        member's priority ``flush_scale``), or holding a request whose
        deadline already passed (so TIMEOUTs are returned promptly, not
        at the next natural flush)."""
        out = []
        for key, q in self._queues.items():
            if not q:
                continue
            spec = key[0]
            if len(q) >= spec.batch or any(
                now - p.t_submit >= self.flush_s * p.flush_scale
                or (p.deadline is not None and now >= p.deadline)
                for p in q
            ):
                out.append(key)
        return out

    def next_event_in(self, now: float) -> Optional[float]:
        """Seconds until the earliest flush deadline or request deadline —
        the dispatcher's wait bound (None: queues empty, wait for a
        submit)."""
        t = None
        for key, q in self._queues.items():
            for p in q:
                cand = p.t_submit + self.flush_s * p.flush_scale
                if p.deadline is not None:
                    cand = min(cand, p.deadline)
                t = cand if t is None else min(t, cand)
        if t is None:
            return None
        return max(0.0, t - now)

    def remove(self, jid: str) -> Optional[PendingRequest]:
        """Remove and return the queued request journaled as ``jid``, or
        None when no such request is queued (already dispatched, already
        finished, or never admitted here). Cancellation's queue half:
        only QUEUED work is removable — once a request is popped into a
        dispatch its lane runs to completion, so the cancel path refuses
        it rather than tearing a compiled batch mid-program."""
        if not jid:
            return None
        for q in self._queues.values():
            for p in q:
                if p.jid == jid:
                    q.remove(p)
                    self._depth -= 1
                    self._m_depth.set(self._depth)
                    return p
        return None

    def drain_pending(self) -> List[PendingRequest]:
        """Remove and return every queued request (submit order within
        each queue) — the ladder-swap epoch boundary: pending requests
        migrate to the replacement scheduler and re-bucket there."""
        out: List[PendingRequest] = []
        for q in self._queues.values():
            while q:
                out.append(q.popleft())
        self._queues.clear()
        self._depth = 0
        self._m_depth.set(0)
        return out

    def pop(
        self, key: QueueKey, now: float
    ) -> Tuple[List[PendingRequest], List[PendingRequest]]:
        """Take up to one batch off ``key``'s queue, splitting out
        deadline-expired requests: returns (live, expired).

        Slot assignment is earliest-deadline-first: the whole queue is
        ordered by (absolute deadline, arrival) and the batch takes the
        head, so a tight-SLO request admitted after a loose-SLO flood
        still rides the next dispatch. Deadline-less requests sort last
        and stay FIFO among themselves (the sort is stable), so the
        no-deadline workload keeps its arrival order exactly. Every
        already-expired request is split out immediately — not just
        those that would have made this batch — so TIMEOUT verdicts
        never queue behind live work."""
        q = self._queues.get(key)
        live: List[PendingRequest] = []
        expired: List[PendingRequest] = []
        if not q:
            return live, expired
        spec = key[0]
        pending: List[PendingRequest] = []
        while q:
            p = q.popleft()
            if p.deadline is not None and now >= p.deadline:
                expired.append(p)
            else:
                pending.append(p)
        pending.sort(
            key=lambda p: (
                p.deadline if p.deadline is not None else math.inf,
                p.t_submit,
            )
        )
        live = pending[: spec.batch]
        q.extend(pending[spec.batch :])
        self._depth -= len(live) + len(expired)
        self._m_depth.set(self._depth)
        return live, expired
