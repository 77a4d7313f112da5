"""Deterministic fault injection for the solve supervisor.

Every recovery path in supervisor/supervisor.py must be testable on CPU in
tier-1 — a recovery ladder that is only exercised when a real TPU wedges
is untested code on the critical path. The injector sits at the
supervisor's step boundary (it wraps the same ``step_fn`` the watchdog
deadlines), so injection needs no backend cooperation and works with any
backend:

- ``FaultKind.HANG``: the wrapped step sleeps ``hang_seconds`` before
  dispatching, so the watchdog's deadline fires exactly as it would on a
  wedged device (the abandoned thread finishes its nap and runs the real
  step into the void — same as an eventually-completing hung dispatch).
  With ``shard=<device id>`` the injected hang also marks that device
  unhealthy in the runtime's simulated-loss registry, so the supervisor's
  post-hang health probe attributes the hang to that shard — the "shard 3
  always hangs" scenario the mesh-shrink rung exists for. A shard-keyed
  hang only fires while its device is still part of the active mesh: once
  the supervisor shrinks the wedged shard out, the fault stops matching,
  exactly like the real wedge it stands in for.
- ``FaultKind.NUMERICAL``: the real step runs, then its host-bound scalars
  are poisoned to NaN — what a silently-diverged factorization looks like
  from the host.
- ``FaultKind.CRASH``: the step raises :class:`InjectedCrash` — the
  "whole program class crashes the worker" failure (ROUND5_NOTES.md:
  batched PCG chunk≥256, storm ≥100k).
- ``FaultKind.DEVICE_LOST``: the step marks ``device_ids`` lost in the
  runtime registry (parallel/runtime.py — the health probe then reports
  them unhealthy, as a really-dead device would) and raises
  :class:`InjectedDeviceLoss` carrying the ids, the way a real device
  loss surfaces as a runtime error out of the dispatch.

In the torch package a device id is a mesh member's id
(``parallel/mesh.py``): a world's rank, or a local mesh's device id. Every
rank of a world runs the same plan, so every rank marks the same ids and
takes the same branch of the supervisor's ladder.

Injection is keyed on the driver iteration number (1-based, as logged) and
optionally on the backend name, and each fault fires a bounded number of
``times`` — counts persist across the supervisor's retries, which is what
makes "NaN at iteration 5, once" produce exactly one fault and a clean
re-solve, while ``times=None`` models a persistently broken backend.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

from distributedlpsolver_tpu_torch.ipm.state import FaultKind
from distributedlpsolver_tpu_torch.parallel import runtime as _runtime


class InjectedCrash(RuntimeError):
    """Raised by an injected CRASH fault (stands in for a worker crash)."""


class InjectedDeviceLoss(RuntimeError):
    """Raised by an injected DEVICE_LOST fault — the stand-in for the
    runtime error a dispatch raises when a mesh participant drops out.
    Carries ``device_ids`` so the supervisor's classifier sees the same
    information a real device-loss error message encodes."""

    def __init__(self, iteration: int, device_ids: Tuple[int, ...]):
        self.iteration = iteration
        self.device_ids = tuple(device_ids)
        super().__init__(
            f"injected device loss of devices {list(self.device_ids)} at "
            f"iteration {iteration}"
        )


@dataclasses.dataclass
class InjectedFault:
    """One scheduled fault."""

    kind: FaultKind
    iteration: int  # driver iteration (1-based) at which to fire
    backend: Optional[str] = None  # only fire when this backend is active
    times: Optional[int] = 1  # firings allowed; None = every time it matches
    hang_seconds: float = 30.0  # HANG: how long the dispatch blocks
    # DEVICE_LOST: which device ids drop out of the runtime.
    device_ids: Optional[Sequence[int]] = None
    # HANG: blame this device id — the injected hang marks it unhealthy so
    # the supervisor's health probe attributes the hang to that shard. The
    # fault only matches while the id is in the active backend's mesh.
    shard: Optional[int] = None


class FaultInjector:
    """Stateful executor of a fault plan (the plan is just the list).

    One injector instance lives for the whole supervised solve, so
    ``times`` budgets span retries and backend degradations.
    """

    def __init__(self, plan: List[InjectedFault]):
        self._plan = list(plan)
        self._fired: List[int] = [0] * len(self._plan)

    def _match(
        self,
        iteration: int,
        backend: str,
        mesh_device_ids: Optional[Tuple[int, ...]],
    ) -> Optional[int]:
        for i, f in enumerate(self._plan):
            if f.iteration != iteration:
                continue
            if f.backend is not None and f.backend != backend:
                continue
            if (
                f.shard is not None
                and mesh_device_ids is not None
                and f.shard not in mesh_device_ids
            ):
                continue  # the blamed shard was shrunk out of the mesh
            if f.times is not None and self._fired[i] >= f.times:
                continue
            return i
        return None

    def wrap_step(
        self,
        step_fn: Callable,
        iteration: int,
        backend: str,
        mesh_device_ids: Optional[Tuple[int, ...]] = None,
    ) -> Callable:
        """Return ``step_fn`` or a faulting wrapper of it, and consume one
        firing from the matched fault's budget."""
        i = self._match(iteration, backend, mesh_device_ids)
        if i is None:
            return step_fn
        self._fired[i] += 1
        fault = self._plan[i]
        if fault.kind is FaultKind.CRASH:

            def _crash():
                err = InjectedCrash(
                    f"injected step crash at iteration {iteration} "
                    f"on backend {backend!r}"
                )
                err.iteration = iteration  # supervisor reads it for FaultRecord
                raise err

            return _crash
        if fault.kind is FaultKind.DEVICE_LOST:

            def _lose():
                ids = tuple(int(d) for d in (fault.device_ids or ()))
                _runtime.simulate_device_loss(ids)
                raise InjectedDeviceLoss(iteration, ids)

            return _lose
        if fault.kind is FaultKind.HANG:

            def _hang():
                if fault.shard is not None:
                    # The wedged shard also fails the health probe, so the
                    # supervisor can attribute this hang to it.
                    _runtime.simulate_device_loss([fault.shard])
                time.sleep(fault.hang_seconds)
                return step_fn()

            return _hang

        def _poison():
            new_state, stats = step_fn()
            nan = math.nan
            return new_state, stats._replace(mu=nan, gap=nan, rel_gap=nan)

        return _poison
