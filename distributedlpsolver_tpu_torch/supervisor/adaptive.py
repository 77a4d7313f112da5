"""Adaptive watchdog deadlines: 10× the trailing median step time.

A static ``--step-timeout`` cannot serve a mesh-shrink decision: the same
flag value that catches a wedged device on a small problem false-fires on
a big one (a 10k endgame iteration legitimately takes ~15 s; a CPU test
step 50 ms), and mis-sizing it either wedges the worker or mis-classifies
a slow step as a hang — which the elastic ladder would then "recover"
from by shrinking a healthy mesh. The robust deadline is relative to the
solve's own observed cadence:

    deadline = clamp(multiplier × median(last ``window`` step times),
                     floor, ceiling)

The *median* (not mean/max) is deliberate: one slow outlier step — a GC
pause, a host hiccup, the occasional re-factorization retry — must not
ratchet the deadline up and blind the watchdog, and one fast step must
not tighten it into false-positive territory.

Warm-up grace: the first steps of a solve (and the first steps after any
recovery that changes compiled shapes — a mesh shrink, a backend
degradation) include XLA compilation, which is 10–1000× a warm step. For
``warmup`` observed steps the deadline falls back to the static hint
(None = unlimited) instead of a median that does not exist yet, and
:meth:`grant_grace` re-opens that window after a recovery.
"""

from __future__ import annotations

import collections
import statistics
from typing import Optional


class AdaptiveDeadline:
    """Trailing-median step-time tracker producing watchdog deadlines."""

    def __init__(
        self,
        multiplier: float = 10.0,
        floor: float = 0.25,
        ceiling: float = 900.0,
        window: int = 32,
        warmup: int = 3,
        static_hint: Optional[float] = None,
    ):
        if multiplier <= 1.0:
            raise ValueError(f"multiplier must exceed 1 (got {multiplier})")
        if floor > ceiling:
            raise ValueError(f"floor {floor} exceeds ceiling {ceiling}")
        self.multiplier = multiplier
        self.floor = floor
        self.ceiling = ceiling
        self.warmup = warmup
        # The static --step-timeout (None = no deadline): used verbatim
        # while no adaptive estimate exists (warm-up / post-recovery
        # grace), so a user-supplied bound still applies from step one.
        self.static_hint = static_hint
        self._obs = collections.deque(maxlen=window)
        self._grace = warmup

    def observe(self, seconds: float) -> None:
        """Record one *successful* step's duration. Timed-out steps are
        never observed — feeding them back would drag the median toward
        the deadline itself and lock in a false-positive loop."""
        self._obs.append(float(seconds))
        if self._grace > 0:
            self._grace -= 1

    def current(self) -> Optional[float]:
        """Deadline for the next step, or None for no deadline."""
        if self._grace > 0 or not self._obs:
            return self.static_hint
        est = self.multiplier * statistics.median(self._obs)
        return min(self.ceiling, max(self.floor, est))

    def grant_grace(self, steps: Optional[int] = None) -> None:
        """Re-open the warm-up window (post-recovery recompile headroom)
        without discarding the step-time history."""
        self._grace = max(self._grace, self.warmup if steps is None else steps)

    def reset(self) -> None:
        """Forget the history AND re-enter warm-up — the step-time regime
        changed wholesale (backend degradation, mesh shrink)."""
        self._obs.clear()
        self._grace = self.warmup

    @property
    def observations(self) -> int:
        return len(self._obs)
