"""Solve supervisor: watchdog + health guards + rollback-and-degrade +
elastic mesh recovery.

Wraps ``ipm.driver.solve`` in a fault-tolerance loop so a solve survives
the failure classes a benchmark artifact can ignore but a serving system
cannot (ROUND5_NOTES.md: a hung dispatch wedging a worker for ≥1h two
iterations from optimal; program classes that crash the worker outright;
a mesh participant dropping out of a pod mid-solve):

1. **Dispatch watchdog** — every device step runs under a deadline
   (supervisor/watchdog.py); a step that blows it is ``FaultKind.HANG``.
   The deadline is either the static ``step_timeout`` or, with
   ``adaptive_timeout``, 10× the trailing median of observed step times
   (supervisor/adaptive.py: floor/ceiling clamped, with warm-up grace for
   compilation) — the only sizing that distinguishes "slow step on a big
   problem" from "wedged device" across problem scales.
2. **Iterate health guards** — the host-side convergence scalars are
   checked every iteration; non-finite values or exploding μ are
   ``FaultKind.NUMERICAL`` before the driver grinds on a poisoned iterate.
3. **Recovery ladder** — on any fault the supervisor rolls back to the
   last good checkpoint and retries with exponential backoff, escalating
   per backend: plain rollback → rollback + regularization bump →
   re-center (fresh well-centered starting point) → **shrink the mesh**
   (mesh backends: probe device health, re-form a smaller mesh over the
   survivors, re-shard, resume — see below) → degrade to the next backend
   in ``backends.auto.DEGRADATION_CHAIN``. When the ladder and the retry
   budget are both exhausted it raises a structured :class:`SolveFailure`
   carrying the ordered fault history — never a silent wedge, never a
   bare traceback.

**Elastic mesh recovery** (the SHRINK rung): when a fault is classified
as ``FaultKind.DEVICE_LOST`` — a raised device-loss error, or repeated
``HANG`` faults the per-device health probe (parallel/runtime.py)
attributes to the same shard (``hang_shard_threshold``) — and the active
backend runs on a mesh with more than ``min_devices`` healthy
participants, the supervisor re-probes the device set, re-forms a smaller
``Mesh`` over the survivors (parallel.mesh.reform_mesh), re-places the
backend on it (``backend.reshard``), and resumes the IPM from the last
host-canonical checkpoint — the problem data and iterate are re-sharded
onto the new layout by the backend's normal ``setup``/``from_host``
(checkpoints are sharding-layout independent, utils/checkpoint.py v3).
Losing one participant of a healthy pod costs one shard's throughput, not
the pod. Device loss never walks the rollback rungs first — a lost device
does not come back on retry — and only falls through to backend
degradation when no shrinkable mesh remains.

Rollback reuses the existing checkpoint machinery (utils/checkpoint.py):
the supervisor forces per-iteration checkpointing to a (temp, unless
configured) path, and each retry resumes through the driver's normal
checkpoint-resume path — fingerprint-guarded, so a rollback can never
resume into a different problem's iterate.

In the torch package: the degradation chain is the JAX package's with
``cuda`` in place of ``tpu`` (:data:`DEGRADATION_CHAIN`), and a rung is
taken only when the port registers its backend. On the card the chain is
``cuda`` → ``sparse-iterative`` (the matrix-free tier, on the same card);
the host rungs (``cpu-sparse``, then ``cpu``) serve only a backend the
caller placed on the CPU, as the reference degrades there. A backend on
the card never degrades to the host. Two faults end the solve instead of
moving it to another backend: a hand-written kernel that fails to build,
load or launch (``ops.kernel_build.KernelError``, re-raised as it is —
another backend would only hide it), and a lost card (no rung runs on a
lost device; :class:`SolveFailure` at once). A degradation is recorded in
the fault history (``action="degrade:<rung>"``) and in the result's
backend name. A mesh backend (``sharded``) is attributed by its mesh's
ranks, and its health probe pings the device of this rank (another
rank's device gives no evidence here, as in the reference's
multi-process guard): a healthy probe goes on up the ladder as the
reference does, and an unhealthy one, which would SHRINK the mesh,
raises ``NotImplementedError`` (ROADMAP Queue 1 item 13b).

Telemetry: with ``config.log_jsonl`` set, fault classifications and
resume completions are appended to the same JSONL stream as the
iteration records (``{"event": "fault"|"resume", ...}``); each resume
event — and the corresponding ``FaultRecord.recovery_overhead_s`` —
carries the wall-clock from fault classification to the first completed
post-resume iteration, so a post-mortem can attribute wall-clock loss to
the recovery path itself.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
from typing import List, Optional, Union

import numpy as np
import torch

# The degradation order lives in backends/auto.py, as in the JAX package.
from distributedlpsolver_tpu_torch.backends.auto import (  # noqa: F401
    DEGRADATION_CHAIN,
    HOST_BACKENDS,
    degradation_chain,
)
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.ipm.driver import SolveHooks, solve
from distributedlpsolver_tpu_torch.ipm.state import (
    FaultKind,
    FaultRecord,
    IPMResult,
    Status,
)
from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics
from distributedlpsolver_tpu_torch.obs import trace as obs_trace
from distributedlpsolver_tpu_torch.ops.kernel_build import KernelError
from distributedlpsolver_tpu_torch.supervisor.adaptive import AdaptiveDeadline
from distributedlpsolver_tpu_torch.supervisor.faults import (
    FaultInjector,
    InjectedDeviceLoss,
    InjectedFault,
)
from distributedlpsolver_tpu_torch.supervisor.watchdog import (
    StepDeadlineExceeded,
    run_with_deadline,
)
from distributedlpsolver_tpu_torch.utils.logging import IterLogger


class IterateHealthFault(RuntimeError):
    """An iterate's host-side scalars failed the health guard."""

    def __init__(self, iteration: int, detail: str):
        self.iteration = iteration
        super().__init__(f"iteration {iteration}: {detail}")


class SolveFailure(RuntimeError):
    """Terminal supervisor outcome: recovery exhausted.

    Carries the full ordered fault history (``faults``) so a post-mortem
    reads what happened and what was tried without log spelunking.
    """

    def __init__(self, faults: List[FaultRecord], detail: str):
        self.faults = list(faults)
        self.status = Status.FAILED
        trail = " -> ".join(
            f"{f.kind.value}@it{f.iteration}[{f.backend}]" for f in faults
        )
        super().__init__(f"{detail}; fault history: {trail or '(none)'}")


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Tunables of the fault-tolerance loop (CLI: --supervise flags)."""

    # Watchdog deadline per device step, seconds. None/0 disables the
    # watchdog (guards and crash recovery still run). Size it ~10× the
    # expected step time: a 15 s/iter 10k endgame wants ~180 s, a CPU test
    # problem 0.5 s. With adaptive_timeout this is only the warm-up
    # fallback — the live deadline tracks the observed step times.
    step_timeout: Optional[float] = None
    # Adaptive watchdog deadline (supervisor/adaptive.py): 10× the
    # trailing median of observed step times, clamped to
    # [timeout_floor, timeout_ceiling], with warm-up grace (step_timeout,
    # or no deadline when unset) during the first timeout_warmup steps
    # and after every recovery that recompiles.
    adaptive_timeout: bool = False
    timeout_multiplier: float = 10.0
    timeout_floor: float = 0.25  # seconds; never deadline below this
    timeout_ceiling: float = 900.0  # seconds; never deadline above this
    timeout_window: int = 32  # trailing step times the median sees
    timeout_warmup: int = 3  # deadline-grace steps (compile headroom)
    max_retries: int = 6  # total recovery attempts before SolveFailure
    snapshot_every: int = 1  # rollback checkpoint cadence (iterations)
    backoff_base: float = 0.05  # seconds; doubles per fault
    backoff_max: float = 5.0
    mu_limit: float = 1e30  # exploding-μ guard threshold
    reg_bump: float = 1e4  # regularization multiplier on the bump rung
    degrade: bool = True  # allow backend degradation
    # Elastic mesh recovery: smallest mesh the SHRINK rung may re-form
    # (below it the supervisor degrades instead). 0/1 = shrink down to a
    # single device before degrading.
    min_devices: int = 1
    # HANG faults the health probe attributes to the same device before
    # that device is treated as lost (shrink it out of the mesh).
    hang_shard_threshold: int = 2
    # Per-device wall-clock budget of the post-fault health probe.
    probe_deadline: float = 2.0
    # Rollback checkpoint path; None = a temp file, removed on success.
    checkpoint_path: Optional[str] = None
    # Deterministic fault injection (tests): a list of InjectedFault.
    fault_plan: Optional[List[InjectedFault]] = None


# Ladder rungs per backend, in escalation order. The SHRINK rung is not a
# counter value: it triggers on classification (DEVICE_LOST / attributed
# hangs) or on rung overflow of a mesh backend with probed-unhealthy
# devices, and resets the rung counter for the re-formed mesh.
_RUNG_ROLLBACK, _RUNG_REG_BUMP, _RUNG_RECENTER = 0, 1, 2

_GUARDED_SCALARS = ("mu", "gap", "rel_gap", "pinf", "dinf", "pobj", "dobj")

# Substrings (lowercased) of runtime errors that mean a device dropped
# out rather than the program being at fault. Conservative: a mismatch
# only costs the fault a trip through the generic CRASH ladder before
# the rung-overflow probe still catches a genuinely dead device.
_DEVICE_LOSS_PATTERNS = (
    "device_lost",
    "device lost",
    "device is lost",
    "device unavailable",
    "failed to connect to device",
    "hardware failure",
)


def _mesh_unported(where: str):
    return NotImplementedError(
        f"{where} of a mesh backend is not ported to the torch package yet "
        "(ROADMAP Queue 1 item 13b)"
    )


def _mesh_unhealthy(be, deadline: float) -> set:
    """The mesh participants of ``be`` whose probe fails: this rank's
    device is the only one probed (a peer rank's device gives no
    evidence from here)."""
    from distributedlpsolver_tpu_torch.utils.accel import probe_device

    mesh = be.mesh
    return set() if probe_device(be.device, deadline) else {mesh.rank}


def _looks_like_device_loss(e: BaseException) -> bool:
    msg = f"{type(e).__name__}: {e}".lower()
    return any(p in msg for p in _DEVICE_LOSS_PATTERNS)


class _SupervisorHooks(SolveHooks):
    """Watchdog + health guard + injection at the driver's step seam."""

    def __init__(
        self,
        backend: str,
        step_timeout: Optional[float],
        mu_limit: float,
        injector: Optional[FaultInjector],
        adaptive: Optional[AdaptiveDeadline] = None,
        mesh_ids_fn=None,
        pending_fault: Optional[FaultRecord] = None,
        events: Optional[IterLogger] = None,
    ):
        self.backend = backend
        self.step_timeout = step_timeout
        self.mu_limit = mu_limit
        self.injector = injector
        self.adaptive = adaptive
        # Lazy: the mesh exists only after the backend's setup ran inside
        # solve(), which is after this hooks object was constructed.
        self.mesh_ids_fn = mesh_ids_fn or (lambda: None)
        # The fault this attempt is recovering from; cleared (and its
        # recovery overhead recorded) when the first iteration lands.
        self.pending_fault = pending_fault
        self.events = events

    def _deadline(self) -> Optional[float]:
        if self.adaptive is not None:
            return self.adaptive.current()
        return self.step_timeout

    def run_step(self, step_fn, iteration: int):
        if self.injector is not None:
            step_fn = self.injector.wrap_step(
                step_fn, iteration, self.backend, self.mesh_ids_fn()
            )
        t0 = time.perf_counter()
        out = run_with_deadline(step_fn, self._deadline(), iteration)
        if self.adaptive is not None:
            # Only completed steps feed the estimate — see
            # AdaptiveDeadline.observe on why timeouts must not.
            self.adaptive.observe(time.perf_counter() - t0)
        return out

    def on_iterate(self, iteration: int, scalars: dict) -> None:
        if self.pending_fault is not None:
            # First completed post-resume iteration: the recovery path's
            # wall-clock cost is now known — record it on the fault and
            # in the telemetry stream (satellite: post-mortems attribute
            # wall-clock loss without diffing timestamps by hand).
            overhead = time.time() - self.pending_fault.at_time
            self.pending_fault.recovery_overhead_s = overhead
            obs_metrics.get_registry().histogram(
                "supervisor_recovery_overhead_seconds",
                buckets=obs_metrics.SECONDS_BUCKETS,
                help="fault classification to first post-resume iteration",
            ).observe(overhead)
            obs_trace.get_tracer().instant(
                "supervisor.resume",
                args={
                    "backend": self.backend,
                    "action": self.pending_fault.action,
                    "recovery_overhead_s": round(overhead, 6),
                },
                cat="supervisor",
            )
            if self.events is not None:
                self.events.event(
                    {
                        "event": "resume",
                        "iteration": iteration,
                        "backend": self.backend,
                        "action": self.pending_fault.action,
                        "recovery_overhead_s": round(overhead, 6),
                    }
                )
            self.pending_fault = None
        bad = [
            k
            for k in _GUARDED_SCALARS
            if not np.isfinite(scalars.get(k, np.nan))
        ]
        if bad:
            raise IterateHealthFault(
                iteration,
                f"non-finite scalars {bad} "
                f"(mu={scalars.get('mu')!r})",
            )
        if scalars["mu"] > self.mu_limit:
            raise IterateHealthFault(
                iteration, f"mu={scalars['mu']:.3e} exceeds {self.mu_limit:g}"
            )


def supervised_solve(
    problem,
    backend: Union[str, object] = "auto",
    config: Optional[SolverConfig] = None,
    supervisor: Optional[SupervisorConfig] = None,
    warm_start=None,
    warm_cache=None,
    **config_overrides,
) -> IPMResult:
    """Solve under the supervisor; same contract as ``ipm.solve`` plus
    fault tolerance. Returns an :class:`IPMResult` whose ``faults`` lists
    every fault survived, or raises :class:`SolveFailure` when the
    recovery ladder and retry budget are exhausted. Terminal non-OPTIMAL
    statuses that are *answers* (infeasible, unbounded, iteration limit)
    return as-is — only faults trigger recovery.

    ``warm_start``/``warm_cache`` thread straight through to
    ``ipm.solve`` (ipm/warm.py): the first attempt may start from a
    safeguarded prior iterate; retries always resume via the rollback
    checkpoint instead (a warm start implicated in a numerical fault
    must not be re-offered).
    """
    from distributedlpsolver_tpu_torch.backends.base import get_backend

    sup = supervisor or SupervisorConfig()
    base_cfg = config or SolverConfig()
    if config_overrides:
        base_cfg = base_cfg.replace(**config_overrides)
    from distributedlpsolver_tpu_torch.parallel import runtime

    if runtime.world()["num_processes"] > 1:
        # Rank 0 alone writes a world's checkpoint, and each rank's
        # rollback would read its own: the ladder over a world of
        # processes is the elastic world's.
        raise NotImplementedError(
            "supervised solves over a world of several processes are not ported to the "
            "torch package yet (ROADMAP Queue 1 item 13b)")

    tmpdir = None
    ckpt_path = sup.checkpoint_path or base_cfg.checkpoint_path
    if not ckpt_path:
        tmpdir = tempfile.mkdtemp(prefix="dlps-supervisor-")
        ckpt_path = os.path.join(tmpdir, "rollback.npz")
    base_cfg = base_cfg.replace(
        checkpoint_path=ckpt_path,
        checkpoint_every=base_cfg.checkpoint_every or sup.snapshot_every,
        fused_loop=False,  # supervision needs per-iteration boundaries
        # Attempts append to the telemetry stream; the supervisor
        # truncated it once below, so retries (and the supervisor's own
        # fault/resume events) extend one post-mortem-readable file.
        log_append=bool(base_cfg.log_jsonl),
    )

    events: Optional[IterLogger] = None
    if base_cfg.log_jsonl:
        open(base_cfg.log_jsonl, "w").close()  # one truncation, up front
        events = IterLogger(
            verbose=False,
            jsonl_path=base_cfg.log_jsonl,
            fsync=base_cfg.log_fsync,
            append=True,
        )

    if isinstance(backend, str):
        current_name = backend
        be = get_backend(backend)
    else:
        be = backend
        current_name = getattr(backend, "name", "custom")
    injector = FaultInjector(sup.fault_plan) if sup.fault_plan else None
    adaptive = (
        AdaptiveDeadline(
            multiplier=sup.timeout_multiplier,
            floor=sup.timeout_floor,
            ceiling=sup.timeout_ceiling,
            window=sup.timeout_window,
            warmup=sup.timeout_warmup,
            static_hint=sup.step_timeout or None,
        )
        if sup.adaptive_timeout
        else None
    )
    faults: List[FaultRecord] = []
    attempt_cfg = base_cfg
    rung = 0
    pending: Optional[FaultRecord] = None  # fault being recovered from

    try:
        while True:
            hooks = _SupervisorHooks(
                current_name,
                sup.step_timeout,
                sup.mu_limit,
                injector,
                adaptive=adaptive,
                mesh_ids_fn=lambda: _mesh_ids(be),
                pending_fault=pending,
                events=events,
            )
            # The hooks object owns the pending fault now (it records the
            # recovery overhead when the first iteration lands); a fault
            # in THIS attempt supersedes it below.
            pending = None
            fault = None
            lost_ids: set = set()
            try:
                result = solve(
                    problem,
                    backend=be,
                    config=attempt_cfg,
                    warm_start=warm_start,
                    hooks=hooks,
                    warm_cache=warm_cache,
                )
                if result.status is not Status.NUMERICAL_ERROR:
                    result.faults = faults
                    return result
                fault = FaultRecord(
                    FaultKind.NUMERICAL,
                    result.iterations,
                    current_name,
                    "driver returned numerical_error "
                    "(regularization headroom exhausted)",
                )
            except StepDeadlineExceeded as e:
                fault = FaultRecord(
                    FaultKind.HANG, e.iteration, current_name, str(e)
                )
            except InjectedDeviceLoss as e:
                fault = FaultRecord(
                    FaultKind.DEVICE_LOST,
                    e.iteration,
                    current_name,
                    str(e),
                    devices=tuple(e.device_ids),
                )
                lost_ids.update(e.device_ids)
            except IterateHealthFault as e:
                fault = FaultRecord(
                    FaultKind.NUMERICAL, e.iteration, current_name, str(e)
                )
            except (KeyboardInterrupt, SystemExit, KernelError):
                raise
            except Exception as e:
                kind = (
                    FaultKind.DEVICE_LOST
                    if _looks_like_device_loss(e)
                    else FaultKind.CRASH
                )
                fault = FaultRecord(
                    kind,
                    getattr(e, "iteration", -1),
                    current_name,
                    f"{type(e).__name__}: {e}",
                )
            fault.at_time = time.time()
            faults.append(fault)
            pending = fault
            warm_start = None  # retries resume via the rollback checkpoint
            warm_cache = None  # and never re-offer a fault-implicated warm start

            if len(faults) > sup.max_retries:
                fault.action = "give_up"
                _emit_fault(events, fault)
                raise SolveFailure(
                    faults, f"retry budget ({sup.max_retries}) exhausted"
                )

            # ---- elastic attribution: who (if anyone) is to blame? -----
            mesh = getattr(be, "mesh", None)
            if mesh is not None and fault.kind in (
                FaultKind.DEVICE_LOST,
                FaultKind.HANG,
            ) and _mesh_unhealthy(be, sup.probe_deadline):
                raise _mesh_unported("the shrink after a failed health probe")

            # ---- recovery ladder ---------------------------------------
            if fault.kind is FaultKind.DEVICE_LOST or lost_ids:
                # A lost device does not come back on retry: a mesh backend
                # would SHRINK (not ported); anything else degrades, never
                # rollback-and-hope.
                _shrunk_backend(be, lost_ids, sup.min_devices)
                rung = _RUNG_RECENTER + 1  # force the degrade rung

            if rung == _RUNG_ROLLBACK:
                fault.action = "rollback"
            elif rung == _RUNG_REG_BUMP:
                fault.action = "rollback+reg_bump"
                attempt_cfg = attempt_cfg.replace(
                    reg_primal=attempt_cfg.reg_primal * sup.reg_bump,
                    reg_dual=attempt_cfg.reg_dual * sup.reg_bump,
                )
            elif rung == _RUNG_RECENTER:
                fault.action = "recenter"
                _remove_quiet(ckpt_path)  # fresh, well-centered start
            else:
                # Rung overflow. SHRINK sits above degradation: a mesh
                # backend gets one health probe first (an unhealthy
                # participant would be shrunk out: not ported).
                if getattr(be, "mesh", None) is not None and _mesh_unhealthy(
                        be, sup.probe_deadline):
                    raise _mesh_unported("the mesh-shrink rung")
                # A lost card takes every rung on it along.
                lost_card = fault.kind is FaultKind.DEVICE_LOST and not _on_host(be)
                nxt = (
                    _next_backend(current_name, faults, _on_host(be))
                    if sup.degrade and not lost_card
                    else None
                )
                if nxt is None:
                    fault.action = "give_up"
                    _emit_fault(events, fault)
                    raise SolveFailure(
                        faults,
                        f"recovery ladder exhausted on backend "
                        f"{current_name!r} and no degradation "
                        "target remains"
                        + (" (the card is lost)" if lost_card else "" if _on_host(be) else
                           " (the host rungs serve only backends placed on the CPU)"),
                    )
                fault.action = f"degrade:{nxt}"
                current_name = nxt
                be = get_backend(nxt, **_device_kw(be))
                attempt_cfg = base_cfg  # reset reg escalation
                rung = -1  # += 1 below: fresh ladder, new backend
                if adaptive is not None:
                    # New backend = new step-time regime: the old
                    # cadence would mis-size the first deadlines.
                    adaptive.reset()
            rung += 1
            _emit_fault(events, fault)
            _backoff(sup, len(faults))
    finally:
        if events is not None:
            events.close()
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)


def _emit_fault(events: Optional[IterLogger], fault: FaultRecord) -> None:
    # Metrics/trace first: faults must be counted (and visible on the
    # trace timeline) even when no JSONL stream is configured.
    obs_metrics.get_registry().counter(
        "supervisor_faults_total", labels={"kind": fault.kind.value},
        help="faults classified by the solve supervisor",
    ).inc()
    obs_metrics.get_registry().counter(
        "supervisor_recoveries_total",
        labels={"action": fault.action.split(":")[0] or "none"},
        help="recovery-ladder actions taken (rung family)",
    ).inc()
    obs_trace.get_tracer().instant(
        "supervisor.fault",
        args={
            "kind": fault.kind.value,
            "backend": fault.backend,
            "action": fault.action,
            "iteration": fault.iteration,
        },
        cat="supervisor",
    )
    if events is None:
        return
    events.event(
        {
            "event": "fault",
            "kind": fault.kind.value,
            "iteration": fault.iteration,
            "backend": fault.backend,
            "action": fault.action,
            "devices": list(fault.devices),
            "detail": fault.detail[:300],
            "t": fault.at_time,
            # Which PROCESS observed the fault (one process until the
            # multi-process runtime is ported).
            "rank": 0,
        }
    )


def _mesh_ids(be) -> Optional[tuple]:
    mesh = getattr(be, "mesh", None)
    return None if mesh is None else mesh.device_ids


def _shrunk_backend(be, exclude_ids, min_devices: int):
    """(new_backend, old_count, new_count) for the SHRINK rung, or
    (None, 0, 0) when there is nothing to shrink (no mesh, nothing to
    exclude); a shrink itself raises (not ported)."""
    if getattr(be, "mesh", None) is None or not exclude_ids:
        return None, 0, 0
    raise _mesh_unported("the mesh-shrink rung")


def _device_kw(be) -> dict:
    """The device a degradation target inherits from the backend it
    replaces (the card unless the caller placed it elsewhere)."""
    dev = getattr(be, "device", None)
    return {} if dev is None else {"device": dev}


def _on_host(be) -> bool:
    """Whether the caller placed ``be`` on the CPU (a backend that names no
    device is taken to be on the card)."""
    dev = getattr(be, "device", None)
    return dev is not None and torch.device(dev).type == "cpu"


def _next_backend(
    current: str, faults: List[FaultRecord], on_host: bool = True
) -> Optional[str]:
    """The next rung of the degradation chain that this package registers
    and that has not faulted yet — a host rung only ``on_host``; None when
    none remains."""
    from distributedlpsolver_tpu_torch.backends.base import _REGISTRY

    tried = {f.backend for f in faults} | {current}
    for name in degradation_chain(current):
        if name in tried or name not in _REGISTRY:
            continue
        if on_host or name not in HOST_BACKENDS:
            return name
    return None


def _backoff(sup: SupervisorConfig, n_faults: int) -> None:
    if sup.backoff_base > 0:
        time.sleep(
            min(sup.backoff_max, sup.backoff_base * 2 ** (n_faults - 1))
        )


def _remove_quiet(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass
