"""SLO-aware admission control: per-tenant token buckets, weighted-fair
shares, and priority classes.

This replaces the service's one global ``max_queue_depth`` knob as the
*policy* layer (the depth bound itself survives as the last-resort
backstop in the scheduler). Three verdict axes, checked in order:

1. **Token-bucket quota** — each tenant refills ``rate`` tokens/sec up
   to ``burst``; a submit with an empty bucket is rejected
   ``reason="quota"`` with ``retry_after_s`` set to exactly when the
   next token lands (clamped to ``max_retry_after_s`` — a zero-rate
   quota never hints an infinite wait). This bounds a tenant's
   *sustained* rate no matter how idle the service is.
2. **Weighted-fair share** — under contention (total in-system requests
   past ``fair_start`` of the depth bound) a tenant holding more than
   ``weight / Σ active weights`` of the depth bound is rejected
   ``reason="fair"``. An aggressive tenant saturates only its share;
   the 429s it gets are the backpressure that keeps a tight-SLO
   tenant's queue wait flat (the starvation test pins this).
3. The scheduler's global depth bound stays underneath, rejecting
   ``reason="depth"``.

Priority classes don't gate admission; they shade *urgency*: each class
maps to a ``flush_scale`` multiplier on the scheduler's flush window
(high = flush sooner at more padding waste, batch = wait longer for
fuller buckets), and the scheduler's earliest-deadline-first pop orders
slots within the bucket. Rejections are counted per (reason, tenant) on
the obs registry (``net_admission_rejects_total``); unconfigured
tenants past ``max_tenant_labels`` share the ``other`` label, and their
controller state LRU-evicts past ``max_tracked_tenants`` (both caps
exist because tenant strings are client-controlled).

Thread-safety: the controller has its own lock and never calls out of
module scope while holding it; the service calls it from the submit
thread and the finish paths concurrently.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Dict, Iterable, Mapping, Optional

from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics

_INF = float("inf")

# Priority classes and their flush-window shading. "high" flushes a
# part-full bucket 4x sooner (snappier tails, more padding waste);
# "batch" waits 4x longer for batch-mates (throughput over latency).
DEFAULT_PRIORITY_FLUSH_SCALE: Mapping[str, float] = {
    "high": 0.25,
    "normal": 1.0,
    "batch": 4.0,
}


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """One tenant's admission envelope. The defaults are unmetered: a
    tenant without an explicit quota is bounded only by fairness and
    the global depth backstop."""

    rate: float = _INF  # sustained submits/sec the token bucket refills
    burst: float = _INF  # bucket capacity (instantaneous burst headroom)
    weight: float = 1.0  # weighted-fair share under contention


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Policy table for :class:`AdmissionController`."""

    # Per-tenant quotas; tenants not listed get ``default_quota``.
    quotas: Mapping[str, TenantQuota] = dataclasses.field(
        default_factory=dict
    )
    default_quota: TenantQuota = TenantQuota()
    # Fraction of the service's max_queue_depth past which weighted-fair
    # admission engages (below it, any admitted tenant may burst freely
    # — fairness only matters under contention).
    fair_start: float = 0.5
    # Priority class -> flush_scale multiplier; unknown classes fall
    # back to 1.0 (plain flush_s).
    priority_flush_scale: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_PRIORITY_FLUSH_SCALE)
    )
    # Ceiling on any verdict's retry_after_s: a zero-rate quota would
    # otherwise hint "retry in inf seconds", which breaks strict-JSON
    # bodies, the Retry-After header, and client sleep(wait) loops.
    max_retry_after_s: float = 60.0
    # Tenant strings are client-controlled; without a bound every novel
    # tenant would permanently allocate controller state. Unconfigured
    # tenants past this cap LRU-evict idle (zero in-system) states;
    # configured tenants are never evicted.
    max_tracked_tenants: int = 1024
    # Distinct unconfigured tenants that get their own metric label
    # before collapsing into "other" (bounds metric cardinality).
    max_tenant_labels: int = 32


@dataclasses.dataclass(frozen=True)
class Verdict:
    """One admission decision, in the same vocabulary
    :class:`~distributedlpsolver_tpu_torch.serve.ServiceOverloaded` carries."""

    admitted: bool
    reason: str = ""  # "", "quota", "fair" ("depth" comes from the scheduler)
    retry_after_s: float = 0.0
    tenant: str = "default"
    detail: str = ""


class TenantLabeler:
    """Bounded tenant -> metric-label map. Configured tenants always
    keep their own label; the first ``cap`` distinct unconfigured
    tenants do too; every later novel tenant collapses into ``"other"``
    so a client-controlled tenant string cannot grow metric cardinality
    without bound. Shared by the admission reject counters and the HTTP
    front-end's ``net_requests_total`` so both families agree."""

    OTHER = "other"

    def __init__(self, configured: Iterable[str] = (), cap: int = 32):
        self._configured = frozenset(configured)
        self._cap = cap
        self._lock = threading.Lock()
        self._extra: Dict[str, None] = {}  # guarded-by: _lock

    def label(self, tenant: str) -> str:
        if tenant in self._configured:
            return tenant
        with self._lock:
            if tenant in self._extra:
                return tenant
            if len(self._extra) < self._cap:
                self._extra[tenant] = None
                return tenant
        return self.OTHER


class _TenantState:
    """Mutable per-tenant accounting (token bucket + in-system count)."""

    __slots__ = ("tokens", "t_refill", "in_system", "admitted", "rejected")

    def __init__(self, burst: float):
        self.tokens = burst
        self.t_refill: Optional[float] = None
        self.in_system = 0  # admitted - finished (queued + in flight)
        self.admitted = 0
        self.rejected: Dict[str, int] = {}


class AdmissionController:
    """Stateful admission policy over a set of tenants.

    The service calls :meth:`admit` on the submit path (before the
    scheduler's depth check), :meth:`on_admitted` once the request holds
    a queue slot, and :meth:`on_finished` when its result resolves —
    ``in_system`` is the tenant's live footprint the fair-share check
    meters."""

    def __init__(
        self,
        config: Optional[AdmissionConfig] = None,
        max_depth: int = 1024,
        flush_s: float = 0.05,
        metrics: Optional[obs_metrics.MetricsRegistry] = None,
        clock=time.perf_counter,
    ):
        self.config = config or AdmissionConfig()
        self.max_depth = max_depth
        # The fair-share reject's retry hint: one flush window is the
        # natural drain granularity of the batching dispatcher.
        self.flush_s = flush_s
        self._clock = clock
        self._lock = threading.Lock()
        # LRU order (most-recent last) so the unconfigured-tenant cap
        # can evict the coldest idle state first.
        self._tenants: "OrderedDict[str, _TenantState]" = (
            OrderedDict()
        )  # guarded-by: _lock
        m = metrics if metrics is not None else obs_metrics.get_registry()
        self._metrics = m
        self.labeler = TenantLabeler(
            self.config.quotas, cap=self.config.max_tenant_labels
        )
        self._m_rejects: Dict[tuple, object] = {}  # guarded-by: _lock
        self._m_in_system = m.gauge(
            "net_admission_in_system",
            help="admitted-but-unfinished requests across all tenants",
        )

    def quota_for(self, tenant: str) -> TenantQuota:
        return self.config.quotas.get(tenant, self.config.default_quota)

    def flush_scale(self, priority: str) -> float:
        return float(self.config.priority_flush_scale.get(priority, 1.0))

    def _state(self, tenant: str) -> _TenantState:  # holds: _lock
        st = self._tenants.get(tenant)
        if st is not None:
            self._tenants.move_to_end(tenant)
            return st
        st = _TenantState(self.quota_for(tenant).burst)
        self._tenants[tenant] = st
        # Bound client-controlled state: past the cap, drop the coldest
        # idle unconfigured states. Eviction resets a returning
        # tenant's token bucket to full burst — acceptable for the
        # unconfigured (default-unmetered) tenants this applies to;
        # configured quotas never lose accounting.
        configured = self.config.quotas
        extra = sum(1 for name in self._tenants if name not in configured)
        if extra > self.config.max_tracked_tenants:
            for name in list(self._tenants):
                if extra <= self.config.max_tracked_tenants:
                    break
                if name == tenant or name in configured:
                    continue
                if self._tenants[name].in_system == 0:
                    del self._tenants[name]
                    extra -= 1
        return st

    def _refill(self, st: _TenantState, q: TenantQuota, now: float) -> None:
        # holds: _lock
        if q.rate == _INF or q.burst == _INF:
            st.tokens = _INF
            return
        if st.t_refill is None:
            st.t_refill = now
            st.tokens = min(st.tokens, q.burst)
            return
        st.tokens = min(q.burst, st.tokens + (now - st.t_refill) * q.rate)
        st.t_refill = now

    def _reject(
        self, st: _TenantState, tenant: str, reason: str,
        retry_after_s: float, detail: str,
    ) -> Verdict:  # holds: _lock
        retry_after_s = min(retry_after_s, self.config.max_retry_after_s)
        st.rejected[reason] = st.rejected.get(reason, 0) + 1
        label = self.labeler.label(tenant)
        ctr = self._m_rejects.get((reason, label))
        if ctr is None:
            ctr = self._metrics.counter(
                "net_admission_rejects_total",
                labels={"reason": reason, "tenant": label},
                help="admission rejections by verdict reason and tenant",
            )
            self._m_rejects[(reason, label)] = ctr
        ctr.inc()
        return Verdict(
            admitted=False, reason=reason,
            retry_after_s=round(retry_after_s, 6), tenant=tenant,
            detail=detail,
        )

    def admit(
        self, tenant: str, priority: str = "normal",
        now: Optional[float] = None, units: int = 1,
    ) -> Verdict:
        """Decide one submit. Does NOT yet count the request as
        in-system — the service confirms with :meth:`on_admitted` after
        the scheduler's depth check also passes (a depth rejection must
        not leak a token-bucket token... it already spent one; that
        asymmetry is deliberate: a submit that reached the depth wall
        still consumed the tenant's rate budget, which is what keeps a
        depth-storming tenant from turning 429s into a free retry
        loop).

        ``units`` is the request's fair-share weight: a K-scenario
        solve charges ``ceil(K / scenario_k_unit)`` units — more than
        one plain request (its device footprint scales with K), far
        fewer than K requests (the Schur batch amortizes) — against
        both the token bucket and the in-system fair share."""
        now = self._clock() if now is None else now
        units = max(1, int(units))
        q = self.quota_for(tenant)
        with self._lock:
            st = self._state(tenant)
            self._refill(st, q, now)
            if st.tokens < units:
                wait = (
                    (units - st.tokens) / q.rate if q.rate > 0 else _INF
                )
                return self._reject(
                    st, tenant, "quota", wait,
                    f"token bucket empty (rate={q.rate:g}/s, "
                    f"burst={q.burst:g}, units={units})",
                )
            # Weighted-fair share, metered only under contention. The
            # share denominator counts every CONFIGURED tenant plus any
            # unconfigured one with live work: a configured tenant's
            # share is reserved even while it is idle (the flood must
            # not fill the house before the tight-SLO tenant's first
            # request arrives), but an unconfigured tenant only weighs
            # in while it actually holds slots.
            total = sum(t.in_system for t in self._tenants.values())
            if total >= self.config.fair_start * self.max_depth:
                active = set(self.config.quotas)
                active.add(tenant)
                active.update(
                    name
                    for name, t in self._tenants.items()
                    if t.in_system > 0
                )
                wsum = sum(
                    self.quota_for(name).weight for name in active
                ) or 1.0
                share = q.weight / wsum
                cap = max(1.0, share * self.max_depth)
                if st.in_system + units > cap:
                    return self._reject(
                        st, tenant, "fair", self.flush_s,
                        f"{st.in_system} in system + {units} units > "
                        f"fair share {cap:.0f} of {self.max_depth} "
                        f"(weight {q.weight:g}/{wsum:g})",
                    )
            st.tokens -= float(units)
            st.admitted += 1
        return Verdict(admitted=True, tenant=tenant)

    def on_admitted(self, tenant: str, units: int = 1) -> None:
        with self._lock:
            self._state(tenant).in_system += max(1, int(units))
            self._m_in_system.set(
                sum(t.in_system for t in self._tenants.values())
            )

    def on_finished(self, tenant: str, units: int = 1) -> None:
        with self._lock:
            st = self._tenants.get(tenant)
            if st is not None and st.in_system > 0:
                st.in_system = max(0, st.in_system - max(1, int(units)))
            self._m_in_system.set(
                sum(t.in_system for t in self._tenants.values())
            )

    def stats(self) -> dict:
        """Per-tenant admission accounting for ``/statusz`` and the
        service summary event."""
        with self._lock:
            out = {}
            for name, st in sorted(self._tenants.items()):
                q = self.quota_for(name)
                out[name] = {
                    "admitted": st.admitted,
                    "rejected": dict(st.rejected),
                    "in_system": st.in_system,
                    "tokens": (
                        None if st.tokens == _INF else round(st.tokens, 3)
                    ),
                    "weight": q.weight,
                }
            return out


# ---------------------------------------------------------------------------
# Overload brownout ladder
# ---------------------------------------------------------------------------

# Stage semantics (cumulative — stage N applies every rung <= N):
#   0  off           normal service
#   1  shed_batch    batch-priority submits get a structured brownout
#                    verdict with an honest Retry-After
#   2  widen_flush   every admitted request's flush window widens by
#                    ``flush_widen`` (fuller buckets, fewer dispatches)
#   3  pdhg_reroute  tol-eligible traffic (request tol >= the floor)
#                    routes to the cheaper PDHG engine; tight-tol work
#                    stays on IPM untouched
BROWNOUT_STAGES: Mapping[int, str] = {
    0: "off",
    1: "shed_batch",
    2: "widen_flush",
    3: "pdhg_reroute",
}


@dataclasses.dataclass(frozen=True)
class BrownoutConfig:
    """Staged-degradation policy for :class:`BrownoutController`.

    The saturation signal is *sustained* queue depth (as a fraction of
    the scheduler's depth bound) OR a sustained admission-reject rate;
    instantaneous spikes never engage a stage, and release requires the
    complement (below the LOW watermark) to hold just as long — classic
    two-watermark hysteresis, so the ladder cannot flap with the queue.
    """

    # Depth watermarks as fractions of max_queue_depth: saturation at/
    # above ``depth_high``; only depths at/below ``depth_low`` count as
    # calm (between the two the current stage holds).
    depth_high: float = 0.75
    depth_low: float = 0.40
    # Non-brownout rejections (depth/quota/fair) per second that also
    # count as saturation — a service rejecting hard is overloaded even
    # when its queue drains fast. Brownout sheds themselves are
    # excluded from this rate or stage 1 would self-sustain forever.
    reject_rate_high: float = 2.0
    reject_window_s: float = 1.0
    # Signal must hold this long before stage 1 engages; continued
    # saturation escalates one stage per ``escalate_after_s``; sustained
    # calm releases one stage per ``release_after_s``.
    engage_after_s: float = 1.0
    escalate_after_s: float = 2.0
    release_after_s: float = 2.0
    max_stage: int = 3
    # Stage >= 2: flush-window multiplier on every admitted request.
    flush_widen: float = 4.0
    # Stage >= 3: request tols at/above this floor re-route to PDHG.
    # Tighter requests NEVER re-route — the ladder degrades latency and
    # throughput shape, not correctness.
    pdhg_tol_floor: float = 1e-6
    # Honest Retry-After carried by every shed verdict.
    retry_after_s: float = 1.0


class BrownoutController:
    """Closed-loop staged degradation under overload.

    The service calls :meth:`observe` with the current queue depth on
    every submit (and may call it from its poll/stats paths), collects
    the returned transition events into its JSONL stream, and consults
    :meth:`should_shed` / :meth:`flush_widen` / :meth:`reroute_pdhg`
    for the stage's rungs. :meth:`note_reject` feeds the reject-rate
    half of the saturation signal (non-brownout rejections only).

    Thread-safety: own lock; never calls out while holding it.
    """

    def __init__(
        self,
        config: Optional[BrownoutConfig] = None,
        max_depth: int = 1024,
        metrics: Optional[obs_metrics.MetricsRegistry] = None,
        clock=time.perf_counter,
    ):
        self.config = config or BrownoutConfig()
        self.max_depth = max(1, int(max_depth))
        self._clock = clock
        self._lock = threading.Lock()
        self._stage = 0  # guarded-by: _lock
        self._sat_since: Optional[float] = None  # guarded-by: _lock
        self._calm_since: Optional[float] = None  # guarded-by: _lock
        self._stage_since = 0.0  # guarded-by: _lock
        self._entered_at: Optional[float] = None  # guarded-by: _lock
        self._rejects: list = []  # recent reject stamps; guarded-by: _lock
        self._sheds = 0  # guarded-by: _lock
        self._entries = 0  # guarded-by: _lock
        m = metrics if metrics is not None else obs_metrics.get_registry()
        self._m_stage = m.gauge(
            "net_brownout_stage",
            help="current brownout ladder stage (0 = off)",
        )
        self._m_sheds = m.counter(
            "net_brownout_sheds_total",
            help="batch-priority submits shed by the brownout ladder",
        )

    # -- saturation signal -----------------------------------------------

    def note_reject(self, now: Optional[float] = None) -> None:
        """One non-brownout rejection (depth/quota/fair) happened —
        half of the saturation signal."""
        now = self._clock() if now is None else now
        with self._lock:
            self._rejects.append(now)
            self._prune(now)

    def _prune(self, now: float) -> None:  # holds: _lock
        cutoff = now - self.config.reject_window_s
        i = 0
        for i, t in enumerate(self._rejects):
            if t >= cutoff:
                break
        else:
            i = len(self._rejects)
        if i:
            del self._rejects[:i]

    def observe(self, depth: int, now: Optional[float] = None) -> list:
        """Feed the current queue depth; returns the list of transition
        event payloads (``brownout_enter`` per engage/escalation,
        ``brownout_exit`` per release) for the caller to log — the
        controller itself never touches a stream."""
        cfg = self.config
        now = self._clock() if now is None else now
        events = []
        with self._lock:
            self._prune(now)
            rate = len(self._rejects) / max(cfg.reject_window_s, 1e-9)
            frac = depth / float(self.max_depth)
            saturated = frac >= cfg.depth_high or rate >= cfg.reject_rate_high
            calm = frac <= cfg.depth_low and rate < cfg.reject_rate_high
            reason = (
                "reject_rate" if rate >= cfg.reject_rate_high else "queue_depth"
            )
            if saturated:
                self._calm_since = None
                if self._sat_since is None:
                    self._sat_since = now
                held = now - self._sat_since
                if self._stage == 0 and held >= cfg.engage_after_s:
                    events.append(self._shift(+1, reason, depth, now))
                elif (
                    0 < self._stage < cfg.max_stage
                    and now - self._stage_since >= cfg.escalate_after_s
                ):
                    events.append(self._shift(+1, reason, depth, now))
            elif calm:
                self._sat_since = None
                if self._stage > 0:
                    if self._calm_since is None:
                        self._calm_since = now
                    if (
                        now - self._calm_since >= cfg.release_after_s
                        and now - self._stage_since >= cfg.release_after_s
                    ):
                        events.append(self._shift(-1, "recovered", depth, now))
            else:
                # Between the watermarks: hysteresis — hold the stage,
                # restart both sustain clocks.
                self._sat_since = None
                self._calm_since = None
        return events

    def _shift(
        self, delta: int, reason: str, depth: int, now: float
    ) -> dict:  # holds: _lock
        prev = self._stage
        self._stage = max(0, min(self.config.max_stage, prev + delta))
        self._stage_since = now
        self._m_stage.set(float(self._stage))
        if delta > 0:
            if prev == 0:
                self._entered_at = now
                self._entries += 1
            self._sat_since = now  # escalation pacing restarts
            return {
                "event": "brownout_enter",
                "stage": self._stage,
                "reason": reason,
                "queue_depth": depth,
            }
        self._calm_since = now
        ev = {
            "event": "brownout_exit",
            "stage": self._stage,
            "reason": reason,
            "queue_depth": depth,
        }
        if self._stage == 0 and self._entered_at is not None:
            ev["ms"] = round((now - self._entered_at) * 1e3, 3)
            self._entered_at = None
        return ev

    # -- stage rungs ------------------------------------------------------

    def stage(self) -> int:
        with self._lock:
            return self._stage

    def should_shed(self, priority: str) -> bool:
        """Stage >= 1 sheds batch-priority work (and only batch —
        normal/high traffic keeps flowing, just batched differently)."""
        with self._lock:
            if self._stage >= 1 and priority == "batch":
                self._sheds += 1
                self._m_sheds.inc()
                return True
            return False

    def flush_widen(self) -> float:
        with self._lock:
            return self.config.flush_widen if self._stage >= 2 else 1.0

    def reroute_pdhg(self, tol: float) -> bool:
        """Stage >= 3 routes tol-eligible work to PDHG. The floor is a
        hard correctness line: requests tighter than it never re-route."""
        with self._lock:
            return self._stage >= 3 and tol >= self.config.pdhg_tol_floor

    def stats(self) -> dict:
        with self._lock:
            return {
                "stage": self._stage,
                "stage_name": BROWNOUT_STAGES.get(self._stage, "?"),
                "sheds": self._sheds,
                "entries": self._entries,
                "reject_rate": round(
                    len(self._rejects)
                    / max(self.config.reject_window_s, 1e-9),
                    3,
                ),
            }
