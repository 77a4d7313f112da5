"""The solve service: async request multiplexing onto bucketed batched
device programs.

The port of the JAX package's ``serve/service.py``.
``SolveService.submit(problem, deadline=..., tol=...) -> Future`` accepts
independent, asynchronously-arriving LP requests and multiplexes them
onto the card through one cached program per shape bucket
(``backends/batched.solve_bucket``: static buffers and one captured CUDA
graph of the masked batched Mehrotra loop). The dispatcher is a
three-stage pipeline across three threads:

    submit → per-(bucket, tol) queue ─┐ scheduler
    flush (full batch OR oldest age > flush_s) ┘ thread
         │ pop
         ▼
    pack: pad + stack into pinned memory, copy to the card  pack thread
         │ on the pack stream (the pack of batch k+1
         ▼ overlaps the solve of batch k)
    solve: wait on the pack's event, replay → demux          solve thread

Stages communicate over bounded queues. The pack stage copies
host→device from pinned memory on its own CUDA stream and hands an event
to the solve stage, which waits on it on its stream and marks the tensors
as used there (``record_stream``). Each dispatch records ``pack_ms`` /
``solve_ms`` / ``overlap_ms`` (how much of its pack ran under an earlier
dispatch's solve window).

Standard-form requests (min cᵀx, Ax=b, x≥0 — the serving workload) ride
the bucketed fast path; general-form problems take the solo path through
``ipm.solve`` — same futures, same records, batch=1. The bucketed path is
tolerance-tiered, as in the JAX package: a standard-form request at
``tol ≥ pdhg_tol`` (with ``pdhg_routing``, the default) rides the
bucketed PDHG engine (``backends/first_order.solve_pdhg_bucket``), a
tighter one the IPM engine; ``engine`` is a bucket dimension, and a PDHG
lane that does not meet its request's tolerance re-solves solo on the IPM
ladder (the crossover).

Fault tolerance: a dispatch that raises (or blows ``batch_timeout_s``)
is retried whole once, then degrades to per-request solo solves through
``supervisor.supervised_solve``; members the batch leaves unfinished take
the same solo ladder individually. The solo backend is ``"auto"`` for
the service's device, as in the JAX package: on the card that is
``auto(cuda)`` (the port keeps solo solves on the card), on
``device="cpu"`` ``auto(cpu-native)``; each solo record names the
backend that served it.

SLO-aware admission (``ServiceConfig.admission``: per-tenant token-bucket
quotas, weighted-fair shares, priority flush shading) and the overload
brownout ladder (``ServiceConfig.brownout``) sit on the submit path, as
in the JAX package (``net/admission.py``). A two-stage request (the
``two_stage`` hint of a lowered ``ScenarioLP``) takes the solo route pinned
to the ``scenario`` backend and charges ``ceil(K / scenario_k_unit)``
admission units, as in the JAX package.

Mesh data parallelism: with ``ServiceConfig(mesh_devices=K)`` (or
``mesh=``) the pack stage places each bucket's lane blocks over a local
batch mesh (``parallel/mesh.py``: K distinct cards; on the CPU the CPU
device K times) and ``solve_bucket`` runs each block through its own
program; bucket batches must divide by K, and the warm-cache key holds
the mesh, so a re-formed mesh builds once per bucket and then stays warm.
``reshard(exclude)`` re-forms the mesh over the survivors, clamped to the
gcd of the bucket batches. With ``slice_runner=`` (``distributed/
slice.py``) every dispatch is published to a world's follower ranks and
executed on the world's batch mesh; ``reshard`` then raises
``RuntimeError`` (the world supervisor relaunches a lost world).

Telemetry: one JSONL record per request, one per dispatched batch, and a
service summary at shutdown, through utils/logging.IterLogger. The bucket
ladder can be refined offline (serve/autotune.py) and swapped in live via
:meth:`SolveService.apply_ladder` (drain → swap → warm).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading
import time
from concurrent.futures import Future
from queue import Queue
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from distributedlpsolver_tpu_torch.backends.dense import resolve_device
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.ipm.state import (
    FaultKind,
    FaultRecord,
    IPMState,
    Status,
)
from distributedlpsolver_tpu_torch.models.problem import LPProblem
from distributedlpsolver_tpu_torch.obs import context as obs_context
from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics
from distributedlpsolver_tpu_torch.obs import trace as obs_trace
from distributedlpsolver_tpu_torch.serve.buckets import (
    BucketSpec,
    BucketTable,
    pad_standard_form,
    padding_waste,
)
from distributedlpsolver_tpu_torch.serve.records import (
    RequestResult,
    latency_summary,
)
from distributedlpsolver_tpu_torch.serve.scheduler import (
    PendingRequest,
    QueueKey,
    Scheduler,
    ServiceOverloaded,
)
from distributedlpsolver_tpu_torch.supervisor.watchdog import (
    StepDeadlineExceeded,
    run_with_deadline,
)
from distributedlpsolver_tpu_torch.utils.logging import IterLogger

_INF = np.inf


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Tunables of the serving loop (the JAX package's fields; those the
    port refuses are marked)."""

    # Explicit bucket ladder; None = auto power-of-two buckets of ``batch``
    # slots created on demand.
    buckets: Optional[Sequence[BucketSpec]] = None
    batch: int = 16
    # Oldest-request age that forces a part-full bucket to launch.
    flush_s: float = 0.05
    # Admission control: total queued requests across all buckets before
    # submit raises ServiceOverloaded.
    max_queue_depth: int = 1024
    # Default per-request deadline (seconds from submit); None = none. A
    # request past deadline at dispatch time is returned TIMEOUT without
    # occupying a batch slot.
    default_deadline_s: Optional[float] = None
    # Watchdog over one batch dispatch (abandonment, not cancellation).
    batch_timeout_s: Optional[float] = None
    # Whole-batch retries before degrading to per-request solo recovery.
    max_batch_retries: int = 1
    # Route batch-fault survivors and unfinished members through the
    # supervisor's recovery ladder individually (False: plain solve).
    solo_recovery: bool = True
    # Backend of the solo path, for the service's device ("auto" picks by
    # problem structure, backends/auto.py: on the card, "cuda").
    solo_backend: str = "auto"
    # Service telemetry JSONL path (request/batch/fault/summary events).
    log_jsonl: Optional[str] = None
    # Deterministic fault injection (tests): called with (dispatch_index,
    # bucket_key) before each batch launch; raising faults that attempt.
    fault_injector: Optional[Callable[[int, tuple], None]] = None
    # Batch-axis data parallelism: split each bucket dispatch over this
    # many local devices (0/1 = one device; -1 = every local card). Bucket
    # batches are rounded/validated to divide by it (BucketTable).
    mesh_devices: int = 0
    # Dispatch pipeline depth: bound on popped batches between the
    # scheduler and solve stages.
    pipeline_depth: int = 2
    # Prometheus-text metrics snapshot written at shutdown.
    metrics_path: Optional[str] = None
    # Chrome-trace JSON written at shutdown.
    trace_path: Optional[str] = None
    # Warm-start & amortization layer (serve/warmcache.py).
    warm_start: bool = True
    warm_cache_entries: int = 512
    # SLO-aware admission (net/admission.AdmissionConfig): per-tenant
    # token-bucket quotas + weighted-fair shares + priority flush
    # shading, layered above max_queue_depth (the global backstop).
    # None = the classic depth-only admission.
    admission: Optional[object] = None
    # Tolerance-tiered engine routing: standard-form requests at
    # tol ≥ pdhg_tol dispatch to the bucketed batched PDHG engine
    # (backends/first_order.solve_pdhg_bucket); a lane that misses its
    # tolerance re-solves solo on the IPM ladder. pdhg_routing=False pins
    # every request to the IPM engine.
    pdhg_routing: bool = True
    pdhg_tol: float = 1e-4
    # Durable job journal (serve/journal.py).
    journal_dir: Optional[str] = None
    journal_fsync: str = "flush"
    journal_compact_every: int = 4096
    journal_results_cap: int = 4096
    # Stochastic scenario tier: scenarios per admission fair-share unit. A
    # K-scenario request charges ceil(K / scenario_k_unit) units against
    # its tenant's token bucket and fair share — more than one plain
    # request, far fewer than K (the batched decomposition amortizes the
    # per-scenario work).
    scenario_k_unit: int = 16
    # Overload brownout ladder (net/admission.BrownoutConfig): staged
    # degradation under sustained saturation — stage 1 sheds batch
    # priority with a structured verdict and Retry-After, stage 2 widens
    # every flush window, stage 3 re-routes tol-eligible work to the PDHG
    # engine. Auto-releases on recovery; None = no brownout.
    brownout: Optional[object] = None


def standard_form(problem: LPProblem):
    """(c, A, b) when ``problem`` is a pure standard-form LP the bucketed
    path consumes directly (dense A, all-equality rows, x ≥ 0, no upper
    bounds, no constant, minimized); None routes it to the solo path."""
    A = problem.A
    if not isinstance(A, np.ndarray):
        return None
    if problem.maximize or problem.c0 != 0.0:
        return None
    if not (
        np.array_equal(problem.rlb, problem.rub)
        and np.all(np.isfinite(problem.rlb))
        and np.all(problem.lb == 0.0)
        and np.all(problem.ub == _INF)
    ):
        return None
    return (
        np.asarray(problem.c, dtype=np.float64),
        np.asarray(A, dtype=np.float64),
        np.asarray(problem.rlb, dtype=np.float64),
    )


@dataclasses.dataclass
class _Packed:
    """Output of the pack stage: a device-resident padded bucket."""

    batch: object  # BatchedLP of device tensors
    active: object  # (B,) device bool mask
    waste: float
    pack_ms: float
    # Warm-start lanes (backends/batched.place_warm output); None = warm
    # start disabled.
    warm: object = None  # IPMState of (B, ·) device tensors
    warm_mask: object = None  # (B,) device bool mask of offered slots
    warm_hits: object = None  # host list: cache hit per live slot
    # Host lanes kept for the solve stage's LATE lookup (see
    # _late_warm_lookup): IPMState of (B, ·) numpy arrays.
    warm_host: object = None
    # Event recorded on the pack stream after the copies (None on the CPU).
    ready: object = None
    # PDHG lanes' start-vector indices (first_order.pdhg_seed of each
    # member's name, each padding slot its own index); None on the IPM.
    seeds: object = None
    # The batch mesh the bucket was placed on (None: one device). Under a
    # mesh every placed field is a tuple of lane blocks; in slice mode the
    # batch, mask and warm lanes stay on the host.
    mesh: object = None

    def tensors(self):
        lanes = tuple(self.warm) if self.warm is not None else ()
        out = (self.batch.A, self.batch.b, self.batch.c, self.active, *lanes)
        out += (self.warm_mask,) if self.warm_mask is not None else ()
        flat = []
        for t in out:
            flat.extend(t if isinstance(t, tuple) else (t,))
        return [t for t in flat if isinstance(t, torch.Tensor)]


@dataclasses.dataclass
class _PackJob:
    """One popped batch travelling through the pipeline queues."""

    key: QueueKey
    live: List[PendingRequest]
    expired: List[PendingRequest]
    packed: Optional[_Packed] = None
    pack_error: Optional[Exception] = None


class SolveService:
    """In-process async batching front-end over the bucket engine, on one
    device: the first CUDA card unless ``device`` names another
    (``"cpu"``); without a card it raises."""

    def __init__(
        self,
        config: Optional[ServiceConfig] = None,
        solver_config: Optional[SolverConfig] = None,
        auto_start: bool = True,
        metrics: Optional[obs_metrics.MetricsRegistry] = None,
        tracer=None,
        mesh=None,
        slice_runner=None,
        device=None,
    ):
        self.config = config or ServiceConfig()
        # Multi-host slice mode (distributed/slice.py): an explicit
        # slice_runner routes every bucket dispatch through the slice
        # control plane so follower ranks execute the same programs; its
        # world mesh stands in for mesh_devices. Bucket batch divisibility
        # is enforced against the whole mesh.
        self._slice = slice_runner
        if slice_runner is not None and mesh is None:
            mesh = slice_runner.mesh
        if slice_runner is not None and self.config.solo_backend == "auto":
            # Solo fallbacks run on rank 0 ONLY (no follower mirrors a solo
            # solve): pinned to the one-device dense backend, as in the JAX
            # package.
            self.config = dataclasses.replace(self.config, solo_backend="dense")
        from distributedlpsolver_tpu_torch.backends.base import check_backend_name

        check_backend_name(self.config.solo_backend)
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        self._mesh = (  # guarded-by: _lock
            mesh if mesh is not None else self._build_mesh(self.config.mesh_devices, self.device)
        )
        # The bucket path solves raw standard form — presolve/scaling and
        # per-iteration diagnostics are general-form driver concerns.
        self.solver_config = (solver_config or SolverConfig()).replace(
            verbose=False, log_jsonl=None, checkpoint_path=None,
            checkpoint_every=0, profile_dir=None,
        )
        if metrics is not None:
            self.metrics = metrics
        elif self.config.metrics_path:
            self.metrics = obs_metrics.MetricsRegistry()
        else:
            self.metrics = obs_metrics.get_registry()
        if tracer is not None:
            self.tracer = tracer
            self._owns_tracer = False
        elif self.config.trace_path:
            self.tracer = obs_trace.Tracer(self.config.trace_path, process_name="dlps-serve")
            self._owns_tracer = True
        else:
            self.tracer = obs_trace.get_tracer()
            self._owns_tracer = False
        m = self.metrics
        self._m_requests_by_status: dict = {}
        self._m_dispatches = m.counter("serve_dispatches_total", help="bucket batch dispatches")
        self._m_compiles = m.counter(
            "serve_bucket_compiles_total",
            help="bucket programs built (warm paths must not grow this)",
        )
        self._m_solo = m.counter(
            "serve_solo_fallbacks_total",
            help="requests routed through the per-request solo ladder",
        )
        self._m_queue_ms = m.histogram("serve_queue_ms", help="submit -> dispatch wait per request")
        self._m_total_ms = m.histogram("serve_total_ms", help="submit -> result latency per request")
        self._m_pack_ms = m.histogram("serve_pack_ms", help="host pack wall per dispatch")
        self._m_solve_ms = m.histogram("serve_solve_ms", help="device solve wall per dispatch")
        self._m_overlap_ms = m.histogram(
            "serve_overlap_ms",
            help="host pack time under an earlier dispatch's solve window",
        )
        self._m_waste = m.histogram(
            "serve_padding_waste", buckets=obs_metrics.RATIO_BUCKETS,
            help="padded-entries fraction wasted per dispatch",
        )
        self._m_phase_iters: dict = {}  # engine -> counter (created lazily)
        self._m_engine_dispatches: dict = {}  # engine -> counter (lazy)
        # Stochastic scenario tier: solves by terminal engine (the ladder
        # may finish one on sparse-iterative), the K distribution, and the
        # decomposition's stage split.
        self._m_scenario_solves: dict = {}  # engine -> counter (lazy)
        self._m_scenario_k = m.histogram(
            "scenario_k", buckets=obs_metrics.SCENARIO_K_BUCKETS,
            help="scenario count per scenario-tier request",
        )
        self._m_scenario_schur_ms = m.histogram(
            "scenario_schur_ms", help="batched per-scenario Schur program wall per solve",
        )
        self._m_scenario_link_ms = m.histogram(
            "scenario_link_ms", help="first-stage linking factor/solve wall per solve",
        )
        self._m_phase_switches = m.counter(
            "serve_phase_switches_total",
            help="precision-phase transitions across bucket dispatches",
        )
        self._m_fused = m.gauge(
            "serve_fused_iters", help="IPM iterations fused per device loop body"
        )
        if self.config.warm_start:
            from distributedlpsolver_tpu_torch.serve.warmcache import WarmCache

            self._warm_cache: Optional[object] = WarmCache(
                self.config.warm_cache_entries, metrics=m
            )
        else:
            self._warm_cache = None
        self._m_warm_rejected = m.counter(
            "warm_start_rejected_total",
            help="safeguard fallbacks: offered warm starts rejected for the cold start",
        )
        self._m_iters_by_start: dict = {}  # start label -> histogram
        # SLO-aware admission (net/admission.py): consulted on the submit
        # path before the scheduler's depth backstop; priorities shade
        # flush windows. ``admission`` is the HTTP front-end's read-only
        # surface (its tenant labeler); None without the SLO layer.
        self._admission: Optional[object] = None
        self._brownout: Optional[object] = None
        if self.config.admission is not None:
            from distributedlpsolver_tpu_torch.net.admission import AdmissionController

            self._admission = AdmissionController(
                self.config.admission, max_depth=self.config.max_queue_depth,
                flush_s=self.config.flush_s, metrics=m,
            )
        self.admission = self._admission
        if self.config.brownout is not None:
            from distributedlpsolver_tpu_torch.net.admission import BrownoutController

            self._brownout = BrownoutController(
                self.config.brownout, max_depth=self.config.max_queue_depth, metrics=m,
            )
        self.scheduler = Scheduler(  # guarded-by: _lock
            BucketTable(self.config.buckets, batch=self.config.batch,
                        devices=self._mesh.size if self._mesh is not None else 1),
            self.config.max_queue_depth,
            self.config.flush_s,
            metrics=m,
        )
        self._logger = IterLogger(verbose=False, jsonl_path=self.config.log_jsonl)
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._results: List[RequestResult] = []  # guarded-by: _lock
        self._next_id = 0  # guarded-by: _lock
        self._dispatch_seq = 0  # guarded-by: _lock
        self._inflight = 0  # guarded-by: _lock
        self._stopping = False  # guarded-by: _lock
        self._warm: set = set()  # guarded-by: _lock
        self._compiles = 0  # guarded-by: _lock
        depth = max(1, self.config.pipeline_depth)
        self._pack_q: Queue = Queue(maxsize=depth)
        self._solve_q: Queue = Queue(maxsize=max(1, depth - 1))
        # The pack stage's own CUDA stream: its host→device copies overlap
        # the solve stream's work.
        self._pack_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        self._pack_spans: List[tuple] = []  # guarded-by: _span_lock
        self._pack_current: Optional[float] = None  # guarded-by: _span_lock
        self._span_lock = threading.Lock()
        self._dispatch_rows: List[dict] = []  # guarded-by: _lock
        # Running sums of the dispatch rows' device-loop counts (bodies,
        # replays, captures, K1 launches, and their warm-up twins).
        self._dispatch_totals: dict = {}  # guarded-by: _lock
        self._overlap_ms_total = 0.0  # guarded-by: _lock
        self._pack_ms_total = 0.0  # guarded-by: _lock
        self._phase_iters: dict = {}  # engine -> total iters; guarded-by: _lock
        self._engine_dispatches: dict = {}  # guarded-by: _lock
        self._idle_waits = 0  # guarded-by: _lock
        self._idle_sleep_s = 0.0  # guarded-by: _lock
        self._last_idle_timeout: Optional[float] = None  # guarded-by: _lock
        self._thread: Optional[threading.Thread] = None
        self._pack_thread: Optional[threading.Thread] = None
        self._solve_thread: Optional[threading.Thread] = None
        self._draining = False  # guarded-by: _lock
        self._m_draining = m.gauge("serve_draining", help="1 while the service is draining")
        # Durable job journal: replay happens BEFORE the pipeline threads
        # start so recovered work is queued ahead of any new traffic.
        self._jobs: dict = {}  # jid -> Future of pending jobs; guarded-by: _lock
        self._replayed_by_fp: dict = {}  # jfp -> jid; guarded-by: _lock
        if self.config.journal_dir:
            from distributedlpsolver_tpu_torch.serve.journal import JobJournal

            self._journal: Optional[object] = JobJournal(
                self.config.journal_dir,
                fsync=self.config.journal_fsync,
                compact_every=self.config.journal_compact_every,
                results_cap=self.config.journal_results_cap,
                metrics=m,
            )
            self._replay_journal()
        else:
            self._journal = None
        if auto_start:
            self.start()

    @staticmethod
    def _build_mesh(mesh_devices: int, device):
        """The local batch mesh of ``ServiceConfig.mesh_devices`` on the
        service's device kind: None at 0/1; -1 = every local device; more
        devices than the process has raises (``parallel.mesh.local_devices``;
        on the CPU the CPU device repeats)."""
        from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib

        if mesh_devices in (0, 1):
            return None
        k = mesh_devices
        if k == -1:
            k = torch.cuda.device_count() if device.type == "cuda" else 1
        if k <= 1:
            return None
        return mesh_lib.make_mesh((k,), axis_names=("batch",),
                                  devices=mesh_lib.local_devices(k, device))

    @property
    def mesh_devices(self) -> int:
        """Devices the batch axis is currently sharded over (1 = unsharded)."""
        with self._lock:
            mesh = self._mesh
        return mesh.size if mesh is not None else 1

    @staticmethod
    def _mesh_key(mesh):
        return None if mesh is None else mesh.key

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "SolveService":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True, name="dlps-serve-sched")
            self._pack_thread = threading.Thread(
                target=self._run_pack, daemon=True, name="dlps-serve-pack"
            )
            self._solve_thread = threading.Thread(
                target=self._run_solve, daemon=True, name="dlps-serve-solve"
            )
            self._solve_thread.start()
            self._pack_thread.start()
            self._thread.start()
        return self

    def __enter__(self) -> "SolveService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def _is_idle(self) -> bool:  # holds: _lock
        return self.scheduler.depth() == 0 and self._inflight == 0

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every accepted request has a result. False iff
        ``timeout`` expired first."""
        with self._idle:
            return self._idle.wait_for(self._is_idle, timeout)

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop accepting work; by default finish what was accepted
        (drain), then stop the pipeline threads and emit the summary
        record."""
        with self._wake:
            self._stopping = True
            self._wake.notify_all()
        if drain:
            self.drain(timeout)
        with self._wake:
            self._wake.notify_all()
        for t in (self._thread, self._pack_thread, self._solve_thread):
            if t is not None:
                t.join(timeout=10.0)
        self._thread = self._pack_thread = self._solve_thread = None
        summary = {"event": "service", **self.stats()}
        if self.metrics.enabled:
            summary["metrics"] = self.metrics.snapshot()
        self._logger.event(summary)
        self._logger.close()
        if self._journal is not None:
            self._journal.close()
        if self.config.metrics_path and self.metrics.enabled:
            self.metrics.write_prometheus(self.config.metrics_path)
        if self._owns_tracer:
            self.tracer.close()

    # -- graceful drain ---------------------------------------------------

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def begin_draining(self) -> None:
        """Flip the draining flag synchronously: admission closes the
        moment this returns, while accepted work keeps running."""
        with self._wake:
            first = not self._draining
            self._draining = True
            depth = self.scheduler.depth()
            inflight = self._inflight
            self._wake.notify_all()
        if first:
            self._m_draining.set(1)
            self.tracer.instant("serve.drain", args={"queue_depth": depth}, cat="serve")
            self._logger.event(
                {"event": "drain", "phase": "begin", "queue_depth": depth, "inflight": inflight}
            )

    def drain_for_shutdown(self, timeout: Optional[float] = None) -> bool:
        """Graceful drain: stop admission (submit raises a structured
        ``"draining"`` :class:`ServiceOverloaded`), finish every in-flight
        and queued request, then flush the journal. Returns True iff the
        service fully drained within ``timeout``."""
        self.begin_draining()
        drained = self.drain(timeout)
        if self._journal is not None:
            self._journal.flush()
        with self._lock:
            depth_end = self.scheduler.depth()
        self._logger.event(
            {"event": "drain", "phase": "end", "drained": drained, "queue_depth": depth_end}
        )
        return drained

    # -- durable-journal recovery ----------------------------------------

    def _replay_journal(self) -> None:
        """Crash recovery: re-enqueue every admitted-but-unfinished job the
        WAL holds (in admit order), resolving ones whose wall-clock
        deadline died with the previous process to an honest TIMEOUT."""
        rep = self._journal.replay()
        now_ts = time.time()
        reenqueued = expired = failed = 0
        for job in rep.unfinished:
            if job.deadline_ts is not None and job.deadline_ts <= now_ts:
                self._finish_replayed(
                    job, Status.TIMEOUT, "deadline expired while the service was down"
                )
                expired += 1
                continue
            try:
                problem = LPProblem.from_dict(job.spec["problem"])
                remaining = (
                    None if job.deadline_ts is None else max(0.001, job.deadline_ts - now_ts)
                )
                self.submit(
                    problem,
                    deadline=remaining,
                    tol=job.spec.get("tol"),
                    name=job.spec.get("name"),
                    tenant=job.tenant,
                    priority=job.priority,
                    _replay_job=job,
                )
                reenqueued += 1
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                # Malformed spec or overflow: the job still resolves.
                self._finish_replayed(job, Status.FAILED, f"{type(e).__name__}: {e}")
                failed += 1
        self._logger.event(
            {
                "event": "journal_replay",
                "replayed": len(rep.unfinished),
                "reenqueued": reenqueued,
                "expired": expired,
                "failed": failed,
                "torn": rep.torn,
                "skipped": rep.skipped,
                "results": rep.results,
            }
        )

    def _finish_replayed(self, job, status: Status, detail: str) -> None:
        """Resolve one replayed job without re-running it, through the
        normal finish funnel."""
        now = time.perf_counter()
        p = PendingRequest(
            request_id=-1,
            name=str(job.spec.get("name") or "replayed"),
            c=None, A=None, b=None,
            tol=self.solver_config.tol,
            future=Future(),
            t_submit=now,
            problem=None,
            tenant=job.tenant,
            priority=job.priority,
            jid=job.jid,
            jfp=job.fp,
        )
        with self._lock:
            p.request_id = self._next_id
            self._next_id += 1
        fault = FaultRecord(FaultKind.CRASH, -1, "journal", detail, action="give_up")
        fault.at_time = time.time()
        self._finish(
            p,
            RequestResult(
                request_id=p.request_id, name=p.name, status=status,
                objective=float("nan"), x=None, iterations=0, rel_gap=_INF, pinf=_INF,
                dinf=_INF, bucket=None, queue_ms=0.0, compile_ms=0.0, solve_ms=0.0,
                total_ms=0.0, padding_waste=0.0, faults=[fault], t_submit=now, t_done=now,
            ),
        )

    def job_result(self, jid: str) -> tuple:
        """Poll surface for durable job ids: ``("done", record)``,
        ``("pending", None)`` while queued or in flight, or ``("unknown",
        None)``."""
        if self._journal is None or not jid:
            return ("unknown", None)
        rec = self._journal.result(jid)
        if rec is not None:
            return ("done", rec)
        with self._lock:
            fut = self._jobs.get(jid)
        if (fut is not None and not fut.done()) or self._journal.is_pending(jid):
            return ("pending", None)
        return ("unknown", None)

    def cancel(self, jid: str) -> tuple:
        """Cancel the queued-but-not-dispatched job ``jid``. Returns
        ``(cancelled, state)`` with state ``"cancelled"``,
        ``"dispatched"`` (already riding a batch; it runs to completion),
        ``"finished"`` or ``"unknown"``."""
        if not jid:
            return False, "unknown"
        with self._wake:
            p = self.scheduler.remove(jid)
            fut = None if p is not None else self._jobs.get(jid)
        if p is None:
            if fut is not None and not fut.done():
                return False, "dispatched"
            if self._journal is not None:
                if self._journal.result(jid) is not None:
                    return False, "finished"
                if self._journal.is_pending(jid):
                    return False, "dispatched"
            return False, "unknown"
        now = time.perf_counter()
        waited_ms = (now - p.t_submit) * 1e3
        self._finish(
            p,
            RequestResult(
                request_id=p.request_id, name=p.name, status=Status.CANCELLED,
                objective=float("nan"), x=None, iterations=0, rel_gap=_INF, pinf=_INF,
                dinf=_INF, bucket=None, queue_ms=waited_ms, compile_ms=0.0, solve_ms=0.0,
                total_ms=waited_ms, padding_waste=0.0, m=p.m, n=p.n, t_submit=p.t_submit,
                t_done=now,
            ),
        )
        self._logger.event(
            {
                "event": "cancel", "jid": jid, "id": p.request_id, "name": p.name,
                "tenant": p.tenant, "state": "cancelled", "queue_ms": round(waited_ms, 3),
            }
        )
        return True, "cancelled"

    # -- submission ------------------------------------------------------

    def submit(
        self,
        problem: LPProblem,
        deadline: Optional[float] = None,
        tol: Optional[float] = None,
        name: Optional[str] = None,
        tenant: str = "default",
        priority: str = "normal",
        trace=None,
        _replay_job=None,
    ) -> Future:
        """Enqueue one LP; the Future resolves to a RequestResult.

        ``deadline`` is seconds from now: a request still queued when it
        expires is returned ``Status.TIMEOUT``. ``tol`` defaults to the
        service solver config's tolerance; a novel tol builds its own
        bucket program once, then shares it. With a durable journal the
        request is write-ahead logged before it is queued and the Future
        carries the job id as ``fut.jid``. ``_replay_job`` is the
        journal's own re-enqueue path — never pass it.

        Tolerance-tiered routing: a standard-form request at ``tol ≥
        pdhg_tol`` with ``pdhg_routing`` on takes the PDHG engine, any
        other the IPM engine. A two-stage request (``two_stage`` hint) takes
        the scenario engine on the solo route and charges ``ceil(K /
        scenario_k_unit)`` admission units."""
        sf = standard_form(problem)
        req_tol = tol if tol is not None else self.solver_config.tol
        hint = problem.block_structure or {}
        n_scen = scen_bucket = None
        units = 1
        if hint.get("kind") == "two_stage":
            from distributedlpsolver_tpu_torch.models.scenario import scenario_k_bucket

            n_scen = int(hint.get("num_blocks", 1))
            scen_bucket = scenario_k_bucket(n_scen)
            units = max(1, -(-n_scen // max(1, self.config.scenario_k_unit)))
            engine = "scenario"
            # Always the solo route: a dense-stored lowered form would
            # otherwise pass the standard-form gate and ride a bucket
            # program labelled scenario.
            sf = None
        else:
            engine = (
                "pdhg"
                if self.config.pdhg_routing and sf is not None and req_tol >= self.config.pdhg_tol
                else "ipm"
            )
        fp = None
        if self._warm_cache is not None:
            from distributedlpsolver_tpu_torch.utils.fingerprint import structural_fingerprint

            # Structural identity: correlated requests (same A, new b/c)
            # land on one cache key.
            fp = structural_fingerprint(problem.A, problem.m, problem.n, problem.lb, problem.ub)
        now = time.perf_counter()
        if deadline is None:
            deadline = self.config.default_deadline_s
        job_spec = jfp = None
        if self._journal is not None and _replay_job is None:
            from distributedlpsolver_tpu_torch.serve import journal as journal_mod

            job_spec = journal_mod.request_spec(
                problem, tol=tol, tenant=tenant, priority=priority, name=name,
            )
            jfp = journal_mod.request_fingerprint(job_spec)
        p = PendingRequest(
            request_id=-1,
            name=name or problem.name,
            c=sf[0] if sf else None,
            A=sf[1] if sf else None,
            b=sf[2] if sf else None,
            tol=req_tol,
            future=Future(),
            t_submit=now,
            deadline=None if deadline is None else now + deadline,
            problem=None if sf else problem,
            fp=fp,
            tenant=tenant,
            priority=priority,
            flush_scale=(
                self._admission.flush_scale(priority) if self._admission is not None else 1.0
            ),
            engine=engine,
            jid=_replay_job.jid if _replay_job is not None else None,
            jfp=_replay_job.fp if _replay_job is not None else jfp,
            units=units,
            n_scenarios=n_scen,
            scenario_bucket=scen_bucket,
            trace=(
                _replay_job.trace_context()
                if _replay_job is not None and trace is None
                else trace
            ),
        )
        # Overload brownout ladder: observe saturation (logging stage
        # transitions), then apply the current stage — shed batch
        # priority, widen the flush window, re-route tol-eligible work to
        # PDHG. Replays are exempt: the journal owes them a verdict.
        if self._brownout is not None and _replay_job is None:
            with self._lock:
                depth_now = self.scheduler.depth()
            for ev in self._brownout.observe(depth_now, now):
                self._logger.event(ev)
            if self._brownout.should_shed(priority):
                retry = self._brownout.config.retry_after_s
                self._log_reject(p, "brownout", retry)
                raise ServiceOverloaded(
                    "brownout: batch-priority work shed under overload "
                    f"(stage {self._brownout.stage()})",
                    reason="brownout", retry_after_s=retry, tenant=tenant,
                )
            p.flush_scale *= self._brownout.flush_widen()
            if (p.engine == "ipm" and sf is not None and self.config.pdhg_routing
                    and self._brownout.reroute_pdhg(req_tol)):
                # Stage 3: the PDHG engine takes tol-eligible traffic; a
                # lane short of its tol still crosses over to the solo IPM.
                p.engine = "pdhg"
        with self._wake:
            if self._stopping:
                raise RuntimeError("SolveService is shut down")
            if self._draining and _replay_job is None:
                raise ServiceOverloaded(
                    "service is draining for shutdown",
                    reason="draining",
                    retry_after_s=max(1.0, self.config.flush_s * 10),
                    tenant=tenant,
                )
            if jfp is not None:
                # Crash-retry idempotency: a resubmit of a replayed
                # pending job rides the existing Future.
                existing = self._replayed_by_fp.get(jfp)
                if existing is not None:
                    fut = self._jobs.get(existing)
                    if fut is not None and not fut.done():
                        return fut
                    self._replayed_by_fp.pop(jfp, None)
            p.request_id = self._next_id
            self._next_id += 1
            if self._admission is not None and _replay_job is None:
                v = self._admission.admit(tenant, priority, now, units=p.units)
                if not v.admitted:
                    self._log_reject(p, v.reason, v.retry_after_s)
                    raise ServiceOverloaded(
                        f"admission rejected tenant {tenant!r}: {v.reason} — {v.detail}",
                        reason=v.reason, retry_after_s=v.retry_after_s, tenant=tenant,
                    )
            try:
                # Replays are depth- and admission-exempt: the journal
                # owes them a verdict.
                key = self.scheduler.add(p, exempt=_replay_job is not None)
            except ServiceOverloaded as e:
                self._log_reject(p, e.reason, e.retry_after_s)
                raise
            if self._admission is not None:
                self._admission.on_admitted(tenant, units=p.units)
            if self._journal is not None:
                if _replay_job is not None:
                    self._journal.readmit(_replay_job)
                    self._replayed_by_fp[_replay_job.fp] = _replay_job.jid
                else:
                    p.jid = self._journal.admit(
                        job_spec, jfp, tenant, priority,
                        deadline_ts=None if deadline is None else time.time() + deadline,
                        trace=p.trace.to_header() if p.trace is not None else None,
                    )
                self._jobs[p.jid] = p.future
            req_args = {
                "id": p.request_id, "name": p.name, "m": p.m, "n": p.n,
                "bucket": list(key[0].key()), "tol": key[1], "engine": key[2],
            }
            if p.trace is not None:
                req_args.update(p.trace.span_args())
            self.tracer.async_begin("request", p.request_id, args=req_args)
            self.tracer.async_begin("queue", p.request_id)
            self._wake.notify_all()
        p.future.jid = p.jid
        return p.future

    def _log_reject(self, p: PendingRequest, reason: str, retry_after_s: float) -> None:  # holds: _lock
        """One reject record per shed request."""
        if self._brownout is not None and reason != "brownout":
            # Non-brownout rejections feed the saturation signal's
            # reject-rate half; brownout's own sheds are excluded or
            # stage 1 would sustain itself.
            self._brownout.note_reject()
        self.tracer.instant(
            "serve.reject",
            args={"id": p.request_id, "name": p.name, "reason": reason},
            cat="serve",
        )
        self._logger.event(
            {
                "event": "reject", "id": p.request_id, "name": p.name, "tenant": p.tenant,
                "priority": p.priority, "reason": reason,
                "retry_after_s": round(retry_after_s, 6),
                "queue_depth": self.scheduler.depth(),
            }
        )

    # -- pipeline stage 1: scheduler -------------------------------------

    def _run(self) -> None:
        while True:
            with self._wake:
                now = time.perf_counter()
                ready = self.scheduler.ready(now)
                if not ready:
                    if self._stopping and self.scheduler.depth() == 0:
                        break
                    # Sleep for exactly the earliest flush/request deadline
                    # (or until a submit notifies).
                    timeout = self.scheduler.next_event_in(now)
                    self._idle_waits += 1
                    self._last_idle_timeout = timeout
                    t_w = time.perf_counter()
                    self._wake.wait(timeout=timeout)
                    self._idle_sleep_s += time.perf_counter() - t_w
                    continue
                jobs = []
                for key in ready:
                    live, expired = self.scheduler.pop(key, now)
                    jobs.append(_PackJob(key, live, expired))
                    self._inflight += len(live) + len(expired)
                    for p in live:
                        self.tracer.async_end("queue", p.request_id)
                    for p in expired:
                        self.tracer.async_end("queue", p.request_id, args={"expired": True})
            for job in jobs:  # bounded put: pipeline backpressure
                self._pack_q.put(job)
        self._pack_q.put(None)  # sentinel flows sched → pack → solve

    # -- pipeline stage 2: pack ------------------------------------------

    def _run_pack(self) -> None:
        while True:
            job = self._pack_q.get()
            if job is None:
                self._solve_q.put(None)
                return
            if job.live:
                # Second expiry gate, at slot assignment: the last honest
                # moment to split TIMEOUT verdicts out.
                t_gate = time.perf_counter()
                still, late = [], []
                for p in job.live:
                    dst = late if p.deadline is not None and p.deadline <= t_gate else still
                    dst.append(p)
                if late:
                    job.live = still
                    job.expired.extend(late)
            if job.live and job.live[0].A is not None:
                spec = job.key[0]
                for p in job.live:
                    self.tracer.async_begin("pack", p.request_id)
                t0 = time.perf_counter()
                with self._span_lock:
                    self._pack_current = t0
                pack_args = {"live": len(job.live)}
                if self.tracer.enabled:
                    tids = [p.trace.trace_id for p in job.live if p.trace is not None]
                    if tids:
                        pack_args["trace_ids"] = tids
                try:
                    with self.tracer.span(
                        f"pack {spec.m}x{spec.n}x{spec.batch}", cat="pipeline", args=pack_args,
                    ):
                        job.packed = self._pack_bucket(job.key, job.live)
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception as e:
                    # The solve stage fails the batch's futures; the pack
                    # thread must survive whatever a request throws at it.
                    job.pack_error = e
                t1 = time.perf_counter()
                with self._span_lock:
                    self._pack_current = None
                    self._pack_spans.append((t0, t1))
                    del self._pack_spans[:-128]
                for p in job.live:
                    self.tracer.async_end("pack", p.request_id)
            if self._journal is not None and job.pack_error is None:
                for p in job.live:
                    if p.jid is not None:
                        self._journal.mark(p.jid, "packed")
            self._solve_q.put(job)

    def _on_pack_stream(self):
        """The pack stage's device work goes to its own stream on a card."""
        if self._pack_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._pack_stream)

    def _pack_bucket(self, key: QueueKey, live: List[PendingRequest]) -> _Packed:
        """Host work of one dispatch: pad each member onto the bucket
        shape and stack, straight into pinned host memory, then copy to
        the card on the pack stream and record an event. Runs in the pack
        thread, concurrently with the previous dispatch's solve."""
        from distributedlpsolver_tpu_torch.backends.batched import place_bucket, place_warm
        from distributedlpsolver_tpu_torch.models.generators import BatchedLP

        spec, tol, engine = key
        B = spec.batch
        t0 = time.perf_counter()
        pin = self.device.type == "cuda"
        host = lambda *shape: torch.zeros(shape, dtype=torch.float64, pin_memory=pin)
        A_t, b_t, c_t = host(B, spec.m, spec.n), host(B, spec.m), host(B, spec.n)
        A, b, c = A_t.numpy(), b_t.numpy(), c_t.numpy()
        active = np.zeros(B, dtype=bool)
        for k, p in enumerate(live):
            c[k], A[k], b[k] = pad_standard_form(p.c, p.A, p.b, spec.m, spec.n)
            active[k] = True
        for k in range(len(live), B):  # inactive slots: well-posed copies
            A[k], b[k], c[k] = A[0], b[0], c[0]
        batch = BatchedLP(c=c_t, A=A_t, b=b_t, name=f"bucket_{spec.m}x{spec.n}")
        seeds = None
        if engine == "pdhg":
            from distributedlpsolver_tpu_torch.backends.first_order import pdhg_seed

            # The first-order engine neither consumes nor produces warm
            # iterates (a tol-loose PDHG point must not seed the IPM warm
            # cache); its lanes stay cold by design. Each lane's step size
            # follows its request, not its slot.
            warm_states, warm_mask, warm_hits = None, None, None
            seeds = np.arange(B)
            for k, p in enumerate(live):
                seeds[k] = pdhg_seed(p.name, B)
        else:
            warm_states, warm_mask, warm_hits = self._build_warm_lanes(spec, live)
        cfg = self.solver_config.replace(tol=tol)
        # Snapshot: a reshard mid-pipeline only affects later packs; this
        # bucket solves on the mesh it was placed on.
        with self._lock:
            mesh = self._mesh
        if self._slice is not None:
            # Slice mode: the batch stays on the host — the dispatch seam
            # publishes it to the follower ranks and every rank (0
            # included) places its own lane block at execute time.
            return _Packed(
                batch=BatchedLP(c=c, A=A, b=b, name=batch.name), active=active,
                waste=padding_waste(sum(p.m * p.n for p in live), spec),
                pack_ms=(time.perf_counter() - t0) * 1e3, warm=None, warm_mask=warm_mask,
                warm_hits=warm_hits, warm_host=warm_states, seeds=seeds, mesh=mesh,
            )
        ready = None
        with self._on_pack_stream():
            placed, act = place_bucket(batch, active, cfg, mesh=mesh, device=self.device)
            warm_placed = mask_placed = None
            if warm_states is not None:
                warm_placed, mask_placed = place_warm(
                    warm_states, warm_mask, (B, spec.m, spec.n), cfg, mesh=mesh,
                    device=self.device,
                )
            if self._pack_stream is not None:
                ready = torch.cuda.Event()
                ready.record(self._pack_stream)
        return _Packed(
            batch=placed,
            active=act,
            waste=padding_waste(sum(p.m * p.n for p in live), spec),
            pack_ms=(time.perf_counter() - t0) * 1e3,
            warm=warm_placed,
            warm_mask=mask_placed,
            warm_hits=warm_hits,
            warm_host=warm_states,
            ready=ready,
            seeds=seeds,
            mesh=mesh,
        )

    def _await_packed(self, packed: _Packed) -> None:
        """Make the solve stream wait for the pack's copies, and mark the
        packed tensors as used on it (the allocator then keeps them until
        the solve stream is past them)."""
        if packed.ready is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(packed.ready)
        for t in packed.tensors():
            if t.device == self.device:  # a local mesh's other cards copy on their own streams
                t.record_stream(stream)

    def _build_warm_lanes(self, spec, live: List[PendingRequest]):
        """Warm lanes for one bucket: look each member's fingerprint up in
        the cache and pad its prior iterate onto the bucket shape. The
        pad block's fill (x=1, y=0, s=1) is exactly feasible for the
        padding scheme's trivial 1x1 sub-LPs. Cache misses leave the slot
        cold. Returns (host IPMState, mask, hits) or (None, None, None)
        when the warm layer is disabled."""
        if self._warm_cache is None:
            return None, None, None
        B = spec.batch
        wx = np.ones((B, spec.n))
        wy = np.zeros((B, spec.m))
        ws_ = np.ones((B, spec.n))
        ww = np.ones((B, spec.n))
        wz = np.zeros((B, spec.n))
        wm = np.zeros(B, dtype=bool)
        hits = []
        for k, p in enumerate(live):
            entry = self._warm_cache.lookup(p.fp, p.m, p.n) if p.fp else None
            if entry is not None and entry.state is not None:
                st = entry.state
                wx[k, : p.n] = st.x
                wy[k, : p.m] = st.y
                ws_[k, : p.n] = st.s
                ww[k, : p.n] = st.w
                wz[k, : p.n] = st.z
                wm[k] = True
            hits.append(bool(wm[k]))
        return IPMState(x=wx, y=wy, s=ws_, w=ww, z=wz), wm, hits

    def _late_warm_lookup(self, spec, tol, live, packed) -> None:
        """Solve-stage re-lookup for slots that missed the cache at pack
        time: the pack stage runs ahead of the demux that stores entries,
        so back-to-back same-fingerprint requests would otherwise never
        warm. A new hit patches the retained host lanes and re-places
        them."""
        from distributedlpsolver_tpu_torch.backends.batched import place_warm

        if self._warm_cache is None or packed.warm_host is None or packed.warm_hits is None:
            return
        hits = packed.warm_hits
        if all(h or not p.fp for p, h in zip(live, hits)):
            return
        st = packed.warm_host
        new_hit = False
        for k, p in enumerate(live):
            if hits[k] or not p.fp:
                continue
            entry = self._warm_cache.lookup(p.fp, p.m, p.n)
            if entry is not None and entry.state is not None:
                e = entry.state
                st.x[k, : p.n] = e.x
                st.y[k, : p.m] = e.y
                st.s[k, : p.n] = e.s
                st.w[k, : p.n] = e.w
                st.z[k, : p.n] = e.z
                hits[k] = True
                new_hit = True
        if not new_hit:
            return
        wm = np.zeros(spec.batch, dtype=bool)
        wm[: len(hits)] = hits
        if self._slice is not None:
            # Slice mode keeps host lanes: the dispatch seam publishes the
            # patched lanes and mask, and every rank places its block.
            packed.warm_mask = wm
            return
        packed.warm, packed.warm_mask = place_warm(
            st, wm, (spec.batch, spec.m, spec.n), self.solver_config.replace(tol=tol),
            mesh=packed.mesh, device=self.device,
        )

    def _overlap_ms(self, t1: float, t2: float) -> float:
        """How much host pack time fell inside the solve window [t1, t2]."""
        with self._span_lock:
            spans = list(self._pack_spans)
            current = self._pack_current
        o = 0.0
        for ps, pe in spans:
            o += max(0.0, min(t2, pe) - max(t1, ps))
        if current is not None:  # a pack still in flight at solve end
            o += max(0.0, t2 - max(t1, current))
        return o * 1e3

    # -- pipeline stage 3: solve -----------------------------------------

    def _run_solve(self) -> None:
        while True:
            job = self._solve_q.get()
            if job is None:
                return
            key, live, expired = job.key, job.live, job.expired
            try:
                if job.pack_error is not None:
                    raise job.pack_error
                self._dispatch(key, live, expired, job.packed)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                # Last-ditch guard: fail the batch's unresolved members
                # instead of killing the solve stage.
                self._fail_batch(key, live + expired, e)
            finally:
                with self._lock:
                    self._inflight -= len(live) + len(expired)
                    if self._is_idle():
                        self._idle.notify_all()

    def _dispatch(
        self,
        key: QueueKey,
        live: List[PendingRequest],
        expired: List[PendingRequest],
        packed: Optional[_Packed] = None,
    ) -> None:
        now = time.perf_counter()
        for p in expired:
            self._finish(
                p,
                RequestResult(
                    request_id=p.request_id, name=p.name, status=Status.TIMEOUT,
                    objective=float("nan"), x=None, iterations=0, rel_gap=_INF, pinf=_INF,
                    dinf=_INF, bucket=key[0].key(), queue_ms=(now - p.t_submit) * 1e3,
                    compile_ms=0.0, solve_ms=0.0, total_ms=(now - p.t_submit) * 1e3,
                    padding_waste=0.0, t_submit=p.t_submit, t_done=now, m=p.m, n=p.n,
                    engine=p.engine,
                ),
            )
        if not live:
            return
        if self._journal is not None:
            for p in live:
                if p.jid is not None:
                    self._journal.mark(p.jid, "dispatched")
        if live[0].A is None:  # general-form solo pseudo-bucket
            for p in live:
                self._solo(p, key, now, [], retried=False)
            return
        self._dispatch_bucket(key, live, now, packed)

    def _dispatch_bucket(
        self,
        key: QueueKey,
        live: List[PendingRequest],
        t_dispatch: float,
        packed: Optional[_Packed] = None,
    ) -> None:
        from distributedlpsolver_tpu_torch.backends.batched import (
            bucket_cache_size,
            solve_bucket,
        )
        from distributedlpsolver_tpu_torch.backends.first_order import solve_pdhg_bucket

        spec, tol, engine = key
        if packed is None:
            # Direct-call path (tests): pack inline.
            packed = self._pack_bucket(key, live)
        self._await_packed(packed)
        batch, active = packed.batch, packed.active
        cfg = self.solver_config.replace(tol=tol)
        waste = packed.waste
        if engine != "pdhg":
            self._late_warm_lookup(spec, tol, live, packed)
        solve_engine_fn = solve_pdhg_bucket if engine == "pdhg" else solve_bucket
        with self._lock:
            seq = self._dispatch_seq
            self._dispatch_seq += 1

        mesh = packed.mesh
        warm_key = (spec.key(), tol, cfg.dtype, self._mesh_key(mesh), engine)
        compile_ms = 0.0
        warmup = None
        faults: List[FaultRecord] = []
        res = None
        for p in live:
            self.tracer.async_begin("solve", p.request_id)
        t_sol0 = time.perf_counter()
        for attempt in range(1 + self.config.max_batch_retries):
            try:
                if self.config.fault_injector is not None:
                    self.config.fault_injector(seq, key)
                # Cold bucket: one max_iter=1 dispatch builds the bucket's
                # program — the kernel build, one eager body and the
                # capture of its graph — so that cost is stamped as
                # compile_ms on this batch's requests; the real solve
                # then only replays. Inside the fault loop so a build
                # failure degrades like any other dispatch fault.
                with self._lock:
                    cold = warm_key not in self._warm
                if cold:
                    size0 = bucket_cache_size()
                    t0 = time.perf_counter()
                    with self.tracer.span(
                        f"compile {spec.m}x{spec.n}x{spec.batch}/{engine}", cat="pipeline",
                    ):
                        if self._slice is not None:
                            # Every rank of the slice builds the program:
                            # the warm-up rides the dispatch seam.
                            warmup = self._slice.dispatch(
                                spec, tol, engine, batch, active, max_iter=1,
                                seeds=packed.seeds)
                        else:
                            extra = {"seeds": packed.seeds} if engine == "pdhg" else {}
                            warmup = solve_engine_fn(batch, active, cfg, mesh=mesh, max_iter=1,
                                                     device=self.device, **extra)
                    compile_ms = (time.perf_counter() - t0) * 1e3
                    new_programs = bucket_cache_size() - size0
                    self._m_compiles.inc(new_programs)
                    with self._lock:
                        self._warm.add(warm_key)
                        self._compiles += new_programs

                def _solve():
                    if self._slice is not None:
                        # Rank 0 publishes the members' trace headers in
                        # the dispatch journal's meta (host JSON, never a
                        # program key); followers join them.
                        return self._slice.dispatch(
                            spec, tol, engine, batch, active,
                            warm_host=None if engine == "pdhg" else packed.warm_host,
                            warm_mask=packed.warm_mask, seeds=packed.seeds,
                            trace=[p.trace.to_header() for p in live
                                   if p.trace is not None] or None,
                        )
                    if engine == "pdhg":
                        return solve_pdhg_bucket(batch, active, cfg, mesh=mesh,
                                                 device=self.device, seeds=packed.seeds)
                    return solve_bucket(
                        batch, active, cfg, mesh=mesh, warm=packed.warm,
                        warm_mask=packed.warm_mask, device=self.device,
                    )

                res = run_with_deadline(_solve, self.config.batch_timeout_s, seq)
                break
            except (KeyboardInterrupt, SystemExit):
                raise
            except StepDeadlineExceeded as e:
                fault = FaultRecord(
                    FaultKind.HANG, -1, "batched", str(e),
                    action="retry_batch"
                    if attempt < self.config.max_batch_retries
                    else "solo_fallback",
                )
            except Exception as e:
                fault = FaultRecord(
                    FaultKind.CRASH, -1, "batched", f"{type(e).__name__}: {e}",
                    action="retry_batch"
                    if attempt < self.config.max_batch_retries
                    else "solo_fallback",
                )
            fault.at_time = time.time()
            faults.append(fault)
            self.tracer.instant(
                "serve.fault",
                args={"dispatch": seq, "kind": fault.kind.value, "action": fault.action},
                cat="serve",
            )
            self._logger.event(
                {
                    "event": "fault", "dispatch": seq, "bucket": list(spec.key()),
                    "kind": fault.kind.value, "action": fault.action,
                    "detail": fault.detail[:300],
                }
            )
        t_sol1 = time.perf_counter()
        for p in live:
            self.tracer.async_end("solve", p.request_id)
        solve_args = {"dispatch": seq, "live": len(live),
                      "attempts": len(faults) + (1 if res is not None else 0)}
        if self.tracer.enabled:
            tids = [p.trace.trace_id for p in live if p.trace is not None]
            if tids:
                solve_args["trace_ids"] = tids
        self.tracer.complete(
            f"solve {spec.m}x{spec.n}x{spec.batch} #{seq}", t_sol1 - t_sol0, cat="pipeline",
            args=solve_args, end_us=t_sol1 * 1e6,
        )
        # Pack work (for LATER batches) that ran inside this dispatch's
        # solve window — the pipeline's realized overlap.
        overlap_ms = self._overlap_ms(t_sol0, t_sol1)
        self._m_dispatches.inc()
        ctr = self._m_engine_dispatches.get(engine)
        if ctr is None:
            ctr = self.metrics.counter(
                "serve_engine_dispatches_total", labels={"engine": engine},
                help="bucket dispatches by solve engine (ipm/pdhg)",
            )
            self._m_engine_dispatches[engine] = ctr
        ctr.inc()
        self._m_pack_ms.observe(packed.pack_ms)
        self._m_solve_ms.observe((t_sol1 - t_sol0) * 1e3)
        self._m_overlap_ms.observe(overlap_ms)
        self._m_waste.observe(waste)
        sched_rows = (res.phase_report or []) if res is not None else []
        schedule_str = "→".join(f"{r['engine']}@{r['tol']:g}" for r in sched_rows) or None
        fused_k = res.fused_iters if res is not None else None
        n_warm = (
            int(np.sum(res.warm_used[: len(live)]))
            if res is not None and res.warm_used is not None
            else 0
        )
        for r in sched_rows:
            ctr = self._m_phase_iters.get(r["engine"])
            if ctr is None:
                ctr = self.metrics.counter(
                    "serve_phase_iters_total", labels={"engine": r["engine"]},
                    help="bucket IPM iterations by precision engine",
                )
                self._m_phase_iters[r["engine"]] = ctr
            ctr.inc(r["iters"])
        if len(sched_rows) > 1:
            self._m_phase_switches.inc(len(sched_rows) - 1)
        if fused_k is not None:
            self._m_fused.set(fused_k)
        # The device loop's accounting of this dispatch (and of its
        # cold-bucket warm-up): bodies, replays, captures, K1 launches, and
        # the host-clock ms from the first replay to the exit's read.
        loop = lambda r, k: sum(row.get(k, 0) for row in (r.phase_report or [])) if r else 0
        device_rows = {
            k: loop(res, k) for k in ("bodies", "replays", "captures", "launches", "replay_ms")
        }
        device_rows.update({
            f"warmup_{k}": loop(warmup, k) for k in ("bodies", "captures", "launches")
        })
        first = (res.phase_report or [{}])[0] if res is not None else {}
        n_mesh = mesh.size if mesh is not None else 1

        with self._lock:
            depth = self.scheduler.depth()
            occupancy = self.scheduler.occupancy()
            self._overlap_ms_total += overlap_ms
            self._pack_ms_total += packed.pack_ms
            for r in sched_rows:
                self._phase_iters[r["engine"]] = self._phase_iters.get(r["engine"], 0) + r["iters"]
            self._engine_dispatches[engine] = self._engine_dispatches.get(engine, 0) + 1
            for k, v in device_rows.items():
                if k != "replay_ms":
                    self._dispatch_totals[k] = self._dispatch_totals.get(k, 0) + v
            self._dispatch_rows.append(
                {
                    "dispatch": seq,
                    "bucket": list(spec.key()),
                    "engine": engine,
                    "live": len(live),
                    "pack_ms": round(packed.pack_ms, 3),
                    "compile_ms": round(compile_ms, 3),
                    "solve_ms": round((t_sol1 - t_sol0) * 1e3, 3),
                    "overlap_ms": round(overlap_ms, 3),
                    "schedule": schedule_str,
                    "fused_iters": fused_k,
                    "warm": n_warm,
                    "mesh_devices": n_mesh,
                    "captured": first.get("captured"),
                    **device_rows,
                }
            )
            del self._dispatch_rows[:-2048]
        self._logger.event(
            {
                "event": "batch",
                "dispatch": seq,
                "bucket": list(spec.key()),
                "tol": tol,
                "engine": engine,
                "live": len(live),
                "padding_waste": round(waste, 4),
                "pack_ms": round(packed.pack_ms, 3),
                "compile_ms": round(compile_ms, 3),
                "solve_ms": round(res.solve_time * 1e3, 3) if res else None,
                "overlap_ms": round(overlap_ms, 3),
                "schedule": schedule_str,
                "fused_iters": fused_k,
                "warm": n_warm,
                "mesh_devices": n_mesh,
                "captured": first.get("captured"),
                "attempts": len(faults) + (1 if res is not None else 0),
                "queue_depth": depth,
                "occupancy": occupancy,
                **device_rows,
            }
        )

        if res is None:
            # Batch recovery exhausted: every member goes through the
            # supervisor's ladder individually.
            for p in live:
                self._solo(p, key, t_dispatch, list(faults), retried=True)
            return

        solve_ms = res.solve_time * 1e3
        hits = packed.warm_hits or []
        for k, p in enumerate(live):
            status = res.status[k]
            # Warm-start outcome per member: offered (cache hit at pack) ×
            # accepted (the safeguard's verdict).
            offered = bool(hits[k]) if k < len(hits) else False
            used = bool(res.warm_used[k]) if res.warm_used is not None else False
            warm_label = "warm" if used else ("rejected" if offered else "cold")
            if offered and not used:
                self._m_warm_rejected.inc()
            start = "warm" if used else "cold"
            hist = self._m_iters_by_start.get(start)
            if hist is None:
                hist = self.metrics.histogram(
                    "ipm_iterations", buckets=obs_metrics.ITER_BUCKETS,
                    labels={"start": start},
                    help="IPM iterations per finished solve, by start kind",
                )
                self._m_iters_by_start[start] = hist
            hist.observe(int(res.iterations[k]))
            if status is not Status.OPTIMAL and self.config.solo_recovery:
                member_fault = FaultRecord(
                    FaultKind.NUMERICAL, int(res.iterations[k]), "batched",
                    f"batched member finished {status.value}", action="solo_fallback",
                )
                self._solo(p, key, t_dispatch, faults + [member_fault], retried=True)
                continue
            if p.fp and self._warm_cache is not None and res.y is not None:
                # Amortize: this member's full iterate (real slice only —
                # pads are re-synthesized at pack time) seeds the next
                # same-fingerprint request.
                self._warm_cache.store(
                    p.fp, m=p.m, n=p.n,
                    state=IPMState(
                        x=res.x[k, : p.n].copy(),
                        y=res.y[k, : p.m].copy(),
                        s=res.s[k, : p.n].copy(),
                        w=res.w[k, : p.n].copy(),
                        z=res.z[k, : p.n].copy(),
                    ),
                    tol=tol,
                )
            x_real = res.x[k, : p.n]
            duals = res.y if res.y is not None else res.dual
            done = time.perf_counter()
            self._finish(
                p,
                RequestResult(
                    request_id=p.request_id,
                    name=p.name,
                    status=status,
                    # Real-column objective: pad rows pin their pad columns
                    # at cost 1 each, so recompute on the request's own c.
                    objective=float(p.c @ x_real),  # graftcheck: disable=host-sync (demux, host value)
                    x=x_real,
                    iterations=int(res.iterations[k]),
                    rel_gap=float(res.rel_gap[k]),  # graftcheck: disable=host-sync (demux, host value)
                    pinf=float(res.pinf[k]),  # graftcheck: disable=host-sync (demux, host value)
                    dinf=float(res.dinf[k]),  # graftcheck: disable=host-sync (demux, host value)
                    bucket=spec.key(),
                    queue_ms=(t_dispatch - p.t_submit) * 1e3,
                    compile_ms=compile_ms,
                    solve_ms=solve_ms,
                    total_ms=(done - p.t_submit) * 1e3,
                    padding_waste=waste,
                    dispatch_index=seq,
                    slot=k,
                    faults=list(faults),
                    t_submit=p.t_submit,
                    t_done=done,
                    m=p.m,
                    n=p.n,
                    pack_ms=packed.pack_ms,
                    overlap_ms=overlap_ms,
                    warm=warm_label,
                    engine=engine,
                    lane=None if duals is None else (res.x[k], duals[k]),
                ),
            )

    def _solo(
        self,
        p: PendingRequest,
        key: QueueKey,
        t_dispatch: float,
        faults: List[FaultRecord],
        retried: bool,
    ) -> None:
        """Per-request path: general-form requests, and bucket members
        whose batch (or own verdict) failed — through the supervisor's
        recovery ladder on the service's device."""
        from distributedlpsolver_tpu_torch.backends.base import get_backend
        from distributedlpsolver_tpu_torch.ipm.driver import solve
        from distributedlpsolver_tpu_torch.parallel import runtime
        from distributedlpsolver_tpu_torch.supervisor import (
            SolveFailure,
            SupervisorConfig,
            supervised_solve,
        )

        problem = p.problem
        if problem is None:
            n = p.A.shape[1]
            problem = LPProblem(
                c=p.c, A=p.A, rlb=p.b, rub=p.b,
                lb=np.zeros(n), ub=np.full(n, _INF), name=p.name,
            )
        cfg = self.solver_config.replace(tol=p.tol)
        # Scenario-tier requests pin the scenario-decomposed engine (the
        # supervisor's ladder degrades it onto sparse-iterative on the same
        # lowered form); everything else takes the configured solo backend.
        backend_name = "scenario" if p.engine == "scenario" else self.config.solo_backend
        self._m_solo.inc()
        solo_args = {"retried": retried}
        if p.trace is not None:
            solo_args.update(p.trace.span_args())
        self.tracer.async_begin("solo", p.request_id, args=solo_args)
        t0 = time.perf_counter()
        try:
            backend = get_backend(backend_name, device=self.device)
            # This rank solves the request alone: on a serving slice the
            # followers replay only the bucket dispatches, so the solve
            # must enter none of the world's collectives.
            with obs_context.use(p.trace), runtime.rank_local():
                if self.config.solo_recovery:
                    r = supervised_solve(
                        problem,
                        backend=backend,
                        config=cfg,
                        supervisor=SupervisorConfig(backoff_base=0.01),
                        warm_cache=self._warm_cache,
                    )
                else:
                    r = solve(problem, backend=backend, config=cfg, warm_cache=self._warm_cache)
            status, faults = r.status, faults + list(r.faults)
        except (KeyboardInterrupt, SystemExit):
            raise
        except SolveFailure as e:
            r, status, faults = None, Status.FAILED, faults + list(e.faults)
        except Exception as e:
            r, status = None, Status.FAILED
            faults = faults + [
                FaultRecord(
                    FaultKind.CRASH, -1, backend_name, f"{type(e).__name__}: {e}",
                    action="give_up",
                )
            ]
        done = time.perf_counter()
        self.tracer.async_end("solo", p.request_id)
        schur_ms = link_ms = 0.0
        if p.engine == "scenario":
            # Per-solve decomposition telemetry: the solo path runs solves
            # one at a time on this thread, so the module's last-solve
            # report is this request's (a degraded solve that never entered
            # the scenario backend reports zeros).
            from distributedlpsolver_tpu_torch.backends.scenario import last_solve_report

            rep = last_solve_report()
            if rep.get("n_scenarios") == p.n_scenarios:
                schur_ms = float(rep.get("schur_ms", 0.0))
                link_ms = float(rep.get("link_ms", 0.0))
            term_engine = (r.backend if r is not None else backend_name) or "?"
            ctr = self._m_scenario_solves.get(term_engine)
            if ctr is None:
                ctr = self.metrics.counter(
                    "scenario_solves_total", labels={"engine": term_engine},
                    help="scenario-tier solves by terminal engine "
                    "(degradations land on their actual rung)",
                )
                self._m_scenario_solves[term_engine] = ctr
            ctr.inc()
            self._m_scenario_k.observe(p.n_scenarios or 0)
            self._m_scenario_schur_ms.observe(schur_ms)
            self._m_scenario_link_ms.observe(link_ms)
        self._finish(
            p,
            RequestResult(
                request_id=p.request_id,
                name=p.name,
                status=status,
                objective=r.objective if r else float("nan"),
                x=r.x if r else None,
                iterations=r.iterations if r else 0,
                rel_gap=r.rel_gap if r else _INF,
                pinf=r.pinf if r else _INF,
                dinf=r.dinf if r else _INF,
                bucket=None if p.A is None else key[0].key(),
                queue_ms=(t_dispatch - p.t_submit) * 1e3,
                compile_ms=0.0,
                solve_ms=(done - t0) * 1e3,
                total_ms=(done - p.t_submit) * 1e3,
                padding_waste=0.0,
                retried_solo=retried,
                faults=faults,
                t_submit=p.t_submit,
                t_done=done,
                m=p.m,
                n=p.n,
                warm=r.warm if r is not None else "cold",
                engine=p.engine,
                backend=r.backend if r is not None else None,
                n_scenarios=p.n_scenarios,
                scenario_bucket=p.scenario_bucket,
                schur_ms=schur_ms,
                link_ms=link_ms,
            ),
        )

    def _fail_batch(self, key: QueueKey, members: List[PendingRequest], exc: Exception) -> None:
        """Fail every unresolved member of a batch whose dispatch raised
        past the per-attempt fault handling."""
        fault = FaultRecord(
            FaultKind.CRASH, -1, "dispatcher", f"{type(exc).__name__}: {exc}", action="give_up",
        )
        fault.at_time = time.time()
        self._logger.event(
            {"event": "dispatch_error", "bucket": list(key[0].key()), "detail": fault.detail[:300]}
        )
        now = time.perf_counter()
        for p in members:
            if p.future.done():
                continue
            self._finish(
                p,
                RequestResult(
                    request_id=p.request_id, name=p.name, status=Status.FAILED,
                    objective=float("nan"), x=None, iterations=0, rel_gap=_INF, pinf=_INF,
                    dinf=_INF, bucket=key[0].key(), queue_ms=(now - p.t_submit) * 1e3,
                    compile_ms=0.0, solve_ms=0.0, total_ms=(now - p.t_submit) * 1e3,
                    padding_waste=0.0, faults=[fault], t_submit=p.t_submit, t_done=now,
                    m=p.m, n=p.n,
                ),
            )

    def _finish(self, p: PendingRequest, result: RequestResult) -> None:
        # Tenant/priority attribution is stamped here — the one funnel
        # every result path flows through.
        result = dataclasses.replace(result, tenant=p.tenant, priority=p.priority, trace=p.trace)
        if self._admission is not None:
            self._admission.on_finished(p.tenant, units=p.units)
        if self._journal is not None and p.jid is not None:
            # Persist the verdict BEFORE resolving the future.
            rec = result.record()
            if result.x is not None:
                rec["x"] = [float(v) for v in result.x]
            self._journal.finish(p.jid, rec, status=result.status.value)
            with self._lock:
                self._jobs.pop(p.jid, None)
                if p.jfp is not None:
                    self._replayed_by_fp.pop(p.jfp, None)
        with self._lock:
            # Stats only need the scalar fields.
            self._results.append(dataclasses.replace(result, x=None))
        status = result.status.value
        ctr = self._m_requests_by_status.get(status)
        if ctr is None:
            ctr = self.metrics.counter(
                "serve_requests_total", labels={"status": status},
                help="finished requests by terminal status",
            )
            self._m_requests_by_status[status] = ctr
        ctr.inc()
        self._m_queue_ms.observe(result.queue_ms)
        self._m_total_ms.observe(result.total_ms)
        end_args = {"status": status, "total_ms": round(result.total_ms, 3)}
        if p.trace is not None:
            end_args.update(p.trace.span_args())
        self.tracer.async_end("request", p.request_id, args=end_args)
        self._logger.event(result.record())
        # A caller may have cancelled its still-pending future; claiming
        # it first makes set_result safe.
        if p.future.set_running_or_notify_cancel():
            p.future.set_result(result)

    # -- ladder management ------------------------------------------------

    def reshard(self, exclude: Sequence = ()) -> int:
        """Elastic recovery: re-form the serving mesh over the surviving
        devices (``parallel.mesh.reform_mesh`` semantics — ``exclude``
        lists lost device ids). The survivor count is clamped DOWN to the
        largest count that still divides every bucket's batch, so in-flight
        and future dispatches stay shardable; at 1 the mesh is dropped and
        dispatch continues unsharded. Batches already packed on the old
        mesh finish there. Returns the new device count."""
        if self._slice is not None:
            # A slice's mesh spans PROCESSES: losing part of it kills the
            # world as a unit (distributed/world.py), and recovery is the
            # launcher's world re-initialization.
            raise RuntimeError(
                "reshard() is not available in slice mode — multi-host device loss is "
                "recovered by the world supervisor (it relaunches a smaller world; see "
                "README 'Multi-host')"
            )
        with self._lock:
            mesh = self._mesh
        if mesh is None:
            return 1
        from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib

        new = mesh_lib.reform_mesh(mesh, exclude=exclude, axis_name="batch")
        with self._lock:
            table = self.scheduler.table
            g = table.batch
            for spec in table.specs():
                g = math.gcd(g, spec.batch)
            k = max(d for d in range(1, new.size + 1) if g % d == 0)
            if k <= 1:
                self._mesh = None
            elif k == new.size:
                self._mesh = new
            else:
                self._mesh = mesh_lib.make_mesh(
                    (k,), axis_names=("batch",), devices=new.devices[:k])
            n_dev = max(1, k)
        self.metrics.gauge("serve_mesh_devices", help="devices under the batch axis").set(n_dev)
        self.tracer.instant("serve.reshard", args={"devices": n_dev}, cat="serve")
        self._logger.event({
            "event": "reshard", "devices": n_dev,
            "excluded": [int(getattr(d, "id", d)) for d in exclude],
        })
        return n_dev

    def apply_ladder(
        self,
        buckets: Sequence[BucketSpec],
        warm: bool = True,
        drain_timeout: Optional[float] = None,
        batch: Optional[int] = None,
    ) -> int:
        """Swap the bucket ladder at a safe epoch boundary: drain → replace
        the scheduler's BucketTable (pending requests migrate) → build
        every new bucket program so the first post-swap dispatches pay no
        build. Returns the number of bucket programs warmed."""
        self.drain(drain_timeout)
        table = BucketTable(list(buckets), batch=batch or self.config.batch,
                            devices=self.mesh_devices)
        with self._wake:
            pending = self.scheduler.drain_pending()
            self.scheduler = Scheduler(
                table, self.config.max_queue_depth, self.config.flush_s, metrics=self.metrics,
            )
            misfits = []
            for p in pending:
                try:
                    self.scheduler.add(p)
                except ValueError as e:  # new ladder can't hold this shape
                    misfits.append((p, e))
            self._wake.notify_all()
        for p, e in misfits:
            self._fail_batch((BucketSpec(p.m, p.n, 1), p.tol, p.engine), [p], e)
        self.tracer.instant(
            "serve.ladder_swap",
            args={"buckets": len(table.specs()), "migrated": len(pending),
                  "misfits": len(misfits)},
            cat="serve",
        )
        self._logger.event(
            {
                "event": "ladder_swap",
                "buckets": [list(s.key()) for s in table.specs()],
                "migrated": len(pending),
                "misfits": len(misfits),
            }
        )
        if warm:
            return self.warm_buckets(table.specs())
        return 0

    @staticmethod
    def _cache_dir_snapshot():
        """(dir, entries) of the kernel build directory — what a bucket
        build may write (the K1 library, built once per source)."""
        import importlib

        # The module (the package's ``ops.normal_eq`` attribute is the function).
        d = importlib.import_module("distributedlpsolver_tpu_torch.ops.normal_eq").BUILD_DIR
        if not os.path.isdir(d):
            return d, None
        try:
            return d, set(os.listdir(d))
        except OSError:
            return d, None

    def warm_buckets(
        self,
        specs: Sequence[BucketSpec],
        tol: Optional[float] = None,
        engines: Optional[Sequence[str]] = None,
    ) -> int:
        """Build the bucket programs for ``specs`` at ``tol`` (default: the
        service tolerance) — on a card, capture their graphs — so live
        traffic never pays that. Idempotent per warm key. ``engines``
        defaults to the IPM engine, plus the PDHG engine when ``tol`` is in
        its tier (``pdhg_routing`` and ``tol ≥ pdhg_tol``). Every warmed
        bucket logs a ``cache: hit|miss`` line: ``miss`` when the build
        wrote a new kernel library into the build directory."""
        from distributedlpsolver_tpu_torch.backends.batched import (
            bucket_cache_size,
            place_bucket,
            solve_bucket,
        )
        from distributedlpsolver_tpu_torch.backends.first_order import solve_pdhg_bucket
        from distributedlpsolver_tpu_torch.models.generators import random_batched_lp

        tol = self.solver_config.tol if tol is None else tol
        if engines is None:
            # The PDHG engine only ever serves its tolerance tier — warming
            # it below pdhg_tol would build programs no request can reach.
            engines = ["ipm"]
            if self.config.pdhg_routing and tol >= self.config.pdhg_tol:
                engines.append("pdhg")
        cfg = self.solver_config.replace(tol=tol)
        with self._lock:
            mesh = self._mesh
        warmed = 0
        for spec in specs:
            for engine in engines:
                wk = (spec.key(), tol, cfg.dtype, self._mesh_key(mesh), engine)
                with self._lock:
                    already = wk in self._warm
                if already:
                    continue
                dummy = random_batched_lp(spec.batch, spec.m, spec.n, seed=0)
                size0 = bucket_cache_size()
                cache_dir, entries0 = self._cache_dir_snapshot()
                t0 = time.perf_counter()
                act_host = np.ones(spec.batch, dtype=bool)
                try:
                    if self._slice is not None:
                        # Warm every RANK of the slice: the warm-up is a
                        # published dispatch.
                        self._slice.dispatch(spec, tol, engine, dummy, act_host, max_iter=1)
                    else:
                        placed, act = place_bucket(dummy, act_host, cfg, mesh=mesh,
                                                   device=self.device)
                        fn = solve_pdhg_bucket if engine == "pdhg" else solve_bucket
                        fn(placed, act, cfg, mesh=mesh, max_iter=1, device=self.device)
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception as e:  # warm-up failure: traffic pays later
                    self._logger.event(
                        {
                            "event": "warmup_error", "bucket": list(spec.key()),
                            "engine": engine, "detail": f"{type(e).__name__}: {e}"[:300],
                        }
                    )
                    continue
                warmed += 1
                new_programs = bucket_cache_size() - size0
                self._m_compiles.inc(new_programs)
                with self._lock:
                    self._warm.add(wk)
                    self._compiles += new_programs
                _, entries1 = self._cache_dir_snapshot()
                wrote = entries0 is None or (entries1 is not None and bool(entries1 - entries0))
                self._logger.event(
                    {
                        "event": "warmup", "bucket": list(spec.key()), "tol": tol,
                        "engine": engine, "cache": "miss" if wrote else "hit",
                        "cache_dir": cache_dir,
                        "compile_ms": round((time.perf_counter() - t0) * 1e3, 3),
                    }
                )
        return warmed

    # -- introspection ---------------------------------------------------

    def pipeline_alive(self) -> bool:
        """True iff all three dispatcher pipeline threads are running."""
        threads = (self._thread, self._pack_thread, self._solve_thread)
        return all(t is not None and t.is_alive() for t in threads)

    def progress(self) -> tuple:
        """(dispatch count, queue depth)."""
        with self._lock:
            return self._dispatch_seq, self.scheduler.depth()

    def dispatch_report(self) -> List[dict]:
        """Per-dispatch rows (pack/compile/solve/overlap ms, and the
        device loop's bodies, replays, captures and K1 launches of the
        dispatch and of its cold-bucket warm-up); the most recent 2048."""
        with self._lock:
            return list(self._dispatch_rows)

    def _brownout_stats(self) -> Optional[dict]:
        """Brownout state for stats()/statusz, observing on the way so
        status polls drive stage release when traffic is idle."""
        if self._brownout is None:
            return None
        with self._lock:
            depth = self.scheduler.depth()
        for ev in self._brownout.observe(depth):
            self._logger.event(ev)
        return self._brownout.stats()

    def stats(self) -> dict:
        platform = self.device.type
        with self._lock:
            results = list(self._results)
            depth = self.scheduler.depth()
            occupancy = self.scheduler.occupancy()
            dispatches = self._dispatch_seq
            compiles = self._compiles
            overlap_total = self._overlap_ms_total
            pack_total = self._pack_ms_total
            phase_iters = dict(self._phase_iters)
            engine_dispatches = dict(self._engine_dispatches)
            dispatch_totals = dict(self._dispatch_totals)
            buckets = [list(s.key()) for s in self.scheduler.table.specs()]
            idle = {
                "waits": self._idle_waits,
                "sleep_s": round(self._idle_sleep_s, 3),
                "last_timeout_ms": (
                    None
                    if self._last_idle_timeout is None
                    else round(self._last_idle_timeout * 1e3, 3)
                ),
            }
        # Scenario-tier aggregate: per-K-bucket latency percentiles — the
        # table ``cli report`` reconciles against (same source records,
        # same percentile implementation).
        from distributedlpsolver_tpu_torch.obs.stats import percentile as _pct

        scen_rs = [r for r in results if r.n_scenarios]
        by_bucket: dict = {}
        for r in scen_rs:
            by_bucket.setdefault(r.scenario_bucket or 0, []).append(r)
        scenario = {
            "solves": len(scen_rs),
            "by_bucket": {
                str(b): {
                    "count": len(rs),
                    "k_max": max(r.n_scenarios for r in rs),
                    "total_ms_p50": round(_pct([r.total_ms for r in rs], 50), 3),
                    "total_ms_p99": round(_pct([r.total_ms for r in rs], 99), 3),
                    "schur_ms_p50": round(_pct([r.schur_ms for r in rs], 50), 3),
                    "link_ms_p50": round(_pct([r.link_ms for r in rs], 50), 3),
                }
                for b, rs in sorted(by_bucket.items())
            },
        }
        return {
            **latency_summary(results),
            "queue_depth": depth,
            "occupancy": occupancy,
            "dispatches": dispatches,
            "programs_compiled": compiles,
            "warm_cache": self._warm_cache.stats() if self._warm_cache is not None else None,
            "mesh_devices": self.mesh_devices,
            "device": str(self.device),
            "pack_ms_total": round(pack_total, 3),
            "overlap_ms_total": round(overlap_total, 3),
            "schedule": self.solver_config.bucket_schedule_resolved(platform),
            "fused_iters": self.solver_config.fused_iters_resolved(platform),
            "phase_iters": phase_iters,
            "engine_dispatches": engine_dispatches,
            # Every dispatch's device-loop counts summed (launches: K1 by
            # the bucket programs; warmup_*: their cold-bucket warm-ups).
            "dispatch_totals": dispatch_totals,
            "scenario": scenario,
            "idle": idle,
            "buckets": buckets,
            # Per-tenant admission accounting and the brownout ladder's
            # state (None without them).
            "admission": self._admission.stats() if self._admission is not None else None,
            "brownout": self._brownout_stats(),
            "draining": self.draining,
            "journal": self._journal.stats() if self._journal is not None else None,
        }
