"""IPM iterate state, per-iteration stats, and solve results.

SURVEY.md §1 notes every IPM solver has a "solution/status" layer shared
between the algorithm driver and the CLI; this is ours. The fields mirror
the reference's published metric surface — iteration count, duality-gap
trajectory, primal/dual infeasibility, wall-clock (BASELINE.json:2).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, NamedTuple, Optional

import numpy as np


class IPMState(NamedTuple):
    """Primal-dual iterate for ``min cᵀx s.t. Ax=b, 0≤x, x+w=u (bounded set)``.

    ``w``/``z`` are the upper-bound slack and its dual; on columns without a
    finite upper bound they are pinned to (1, 0) so masked arithmetic stays
    finite (see ipm/core.py).
    """

    x: Any  # (n,) primal
    y: Any  # (m,) equality duals
    s: Any  # (n,) reduced costs (duals of x ≥ 0)
    w: Any  # (n,) upper-bound slack u - x (1 where no ub)
    z: Any  # (n,) duals of x ≤ u (0 where no ub)


class StepStats(NamedTuple):
    """Scalars returned to the host after each device step."""

    mu: Any  # complementarity measure
    gap: Any  # absolute duality gap |pobj - dobj|
    rel_gap: Any
    pinf: Any  # relative primal infeasibility
    dinf: Any  # relative dual infeasibility
    pobj: Any
    dobj: Any
    alpha_p: Any
    alpha_d: Any
    sigma: Any
    bad: Any  # bool: factorization/solve produced non-finite direction


class Status(enum.Enum):
    OPTIMAL = "optimal"
    ITERATION_LIMIT = "iteration_limit"
    NUMERICAL_ERROR = "numerical_error"
    PRIMAL_INFEASIBLE = "primal_infeasible"
    DUAL_INFEASIBLE = "dual_infeasible"  # == primal unbounded
    STALLED = "stalled"  # no progress over the stall window (fused loop)
    FAILED = "failed"  # supervisor exhausted its recovery ladder (supervisor/)
    TIMEOUT = "timeout"  # serve/: request deadline expired before a result
    CANCELLED = "cancelled"  # serve/: queued work cancelled before dispatch


class FaultKind(enum.Enum):
    """Classification of a solve fault observed by the supervisor.

    The taxonomy mirrors the production failure classes: a device dispatch
    that never returns (``HANG``, the watchdog's deadline fired), an
    iterate whose host-side convergence scalars went non-finite or μ
    exploded (``NUMERICAL``), a backend step that raised outright
    (``CRASH``), and a mesh participant dropping out of the runtime
    (``DEVICE_LOST`` — a raised device-loss error, or repeated hangs the
    health probe attributes to the same shard). ``DEVICE_LOST`` is the
    fault class the elastic mesh-shrink rung recovers from: the surviving
    devices re-form a smaller mesh instead of abandoning the pod.
    """

    HANG = "hang"
    NUMERICAL = "numerical"
    CRASH = "crash"
    DEVICE_LOST = "device_lost"


@dataclasses.dataclass
class FaultRecord:
    """One observed fault plus the recovery action the supervisor took."""

    kind: FaultKind
    iteration: int  # driver iteration at which the fault surfaced (-1 unknown)
    backend: str  # backend name active when the fault occurred
    detail: str  # human-readable cause (exception text / guard values)
    action: str = ""  # recovery applied: rollback / reg_bump / recenter / shrink:<K>-><K'> / degrade:<name> / give_up
    at_time: float = 0.0  # unix timestamp when classified
    # Device ids implicated in this fault (DEVICE_LOST, or hangs the
    # health probe attributed to specific shards); empty when unknown.
    devices: tuple = ()
    # Wall-clock seconds from fault classification to the completion of
    # the first post-resume iteration (0.0 until the resume lands) — the
    # recovery-path overhead a post-mortem attributes wall-clock loss to.
    recovery_overhead_s: float = 0.0

    def asdict(self):
        d = dataclasses.asdict(self)
        d["kind"] = self.kind.value
        d["devices"] = list(self.devices)
        return d


@dataclasses.dataclass
class IterRecord:
    """One row of the per-iteration log (SURVEY.md §5.5)."""

    iter: int
    mu: float
    gap: float
    rel_gap: float
    pinf: float
    dinf: float
    alpha_p: float
    alpha_d: float
    sigma: float
    pobj: float
    dobj: float
    t_iter: float  # seconds, device-synchronized

    def asdict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class IPMResult:
    """Solve outcome in the *original* problem space."""

    status: Status
    x: Optional[np.ndarray]  # original-variable primal solution
    objective: float  # original objective (sense-corrected)
    iterations: int
    rel_gap: float
    pinf: float
    dinf: float
    solve_time: float  # seconds, excludes setup/compile
    setup_time: float  # seconds (includes jit compile)
    history: List[IterRecord] = dataclasses.field(default_factory=list)
    backend: str = ""
    name: str = ""
    # Dual solution (minimized sense). For an LPProblem input these are in
    # the ORIGINAL problem space regardless of presolve: y has one entry
    # per original row (0 for presolve-removed rows except singleton rows,
    # which receive their absorbed bound multiplier) and s = c - Aᵀy.
    # For a raw InteriorForm input they are the interior-form duals.
    y: Optional[np.ndarray] = None
    s: Optional[np.ndarray] = None
    # Farkas certificate for non-optimal outcomes (ipm/certificates.py),
    # stated in the solved interior-form space; None when no candidate
    # ray was extractable. ``certificate.certified`` distinguishes a
    # checkable proof from the divergence heuristic alone.
    certificate: Optional[object] = None
    # Faults survived en route to this result (supervised solves only —
    # supervisor/supervisor.py appends one FaultRecord per recovery).
    faults: List["FaultRecord"] = dataclasses.field(default_factory=list)
    # How the solve started: "cold" (Mehrotra start / checkpoint resume),
    # "warm" (a safeguarded WarmStart was accepted), or "rejected" (a
    # WarmStart was offered but its initial residuals regressed past the
    # safeguard and the solve fell back to the cold start). See ipm/warm.
    warm: str = "cold"

    @property
    def iters_per_sec(self) -> float:
        return self.iterations / self.solve_time if self.solve_time > 0 else 0.0

    def summary(self) -> str:
        s = (
            f"{self.name or 'LP'}: {self.status.value} obj={self.objective:.10g} "
            f"iters={self.iterations} gap={self.rel_gap:.2e} pinf={self.pinf:.2e} "
            f"dinf={self.dinf:.2e} time={self.solve_time:.3f}s "
            f"({self.iters_per_sec:.1f} it/s) backend={self.backend}"
        )
        if self.faults:
            s += f" faults={len(self.faults)}"
        return s
