"""`SolverBackend` plugin interface and registry.

A copy of the JAX package's ``backends/base.py``; this package keeps its
own registry. Backends subclass :class:`SolverBackend`, register under
one or more names with :func:`register_backend`, and ``ipm/driver.py``/the CLI
resolve them with :func:`get_backend` (keyword arguments go to the
backend's constructor, e.g. ``get_backend("cuda", device="cpu")``).

The interface is deliberately coarse — ``iterate`` performs one *full*
Mehrotra iteration — so only convergence scalars cross back to the host
each iteration, not per-factorize/per-solve round trips.
"""

from __future__ import annotations

import abc
from typing import Callable, Dict, List, Tuple, Type

import numpy as np

from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.ipm.state import IPMState, StepStats
from distributedlpsolver_tpu_torch.models.problem import InteriorForm


class SolverBackend(abc.ABC):
    """Executes the per-iteration linear algebra of the IPM.

    Lifecycle: ``setup(interior_form, config)`` once, then
    ``starting_point()`` and repeated ``iterate(state)`` calls from the
    host driver (ipm/driver.py), finally ``to_host(state)``.
    """

    name: str = "abstract"

    # Device mesh this backend executes over, or None for single-device /
    # host backends. Mesh-placed backends expose theirs so the supervisor
    # can probe participants and re-form a smaller mesh on device loss.
    mesh = None

    @abc.abstractmethod
    def setup(self, inf: InteriorForm, config: SolverConfig) -> None:
        """Move problem data to the execution target; build/compile kernels."""

    def reshard(self, mesh) -> "SolverBackend | None":
        """Return a FRESH backend of this kind placed on ``mesh`` (elastic
        recovery: the supervisor re-forms a smaller mesh after device loss
        and resumes on the survivors), or None when this backend cannot be
        re-placed — the supervisor then falls through to backend
        degradation. The returned instance is un-setup; the driver's
        normal ``setup`` re-shards the problem data onto the new layout
        and ``from_host`` re-places the checkpointed iterate."""
        return None

    @abc.abstractmethod
    def starting_point(self) -> IPMState:
        """Initial strictly interior iterate (Mehrotra heuristic)."""

    @abc.abstractmethod
    def iterate(self, state: IPMState) -> Tuple[IPMState, StepStats]:
        """One predictor-corrector iteration. Must not raise on numerical
        failure — set ``stats.bad`` and return the incoming state instead,
        so the host can escalate regularization deterministically."""

    def bump_regularization(self) -> bool:
        """Increase regularization after a bad step. Returns False when out
        of headroom (driver then reports NUMERICAL_ERROR)."""
        return False

    def solve_full(self, state: IPMState):
        """Optional fused path: run the WHOLE solve as one device program
        (lax.while_loop). Returns (state, iterations, status_code,
        stats_buffer) or None when unsupported — the driver then falls back
        to its per-iteration host loop. Status codes are
        ipm.core.STATUS_*; the buffer rows are core.N_STAT stats columns."""
        return None

    def to_host(self, state: IPMState) -> IPMState:
        """Materialize a state as host numpy arrays."""
        return IPMState(*(np.asarray(v) for v in state))

    def from_host(self, state: IPMState) -> IPMState:
        """Prepare a host state (checkpoint/warm start) for ``iterate`` —
        inverse of :meth:`to_host` (backends that pad re-pad here)."""
        return state

    def block_until_ready(self, obj) -> None:
        """Synchronization barrier for timing (no-op for eager backends)."""


_REGISTRY: Dict[str, Type[SolverBackend]] = {}

def register_backend(*names: str) -> Callable[[Type[SolverBackend]], Type[SolverBackend]]:
    def deco(cls: Type[SolverBackend]) -> Type[SolverBackend]:
        for n in names:
            key = n.lower()
            if key in _REGISTRY and _REGISTRY[key] is not cls:
                raise ValueError(f"backend name {n!r} already registered")
            _REGISTRY[key] = cls
        cls.name = names[0]
        return cls

    return deco


def check_backend_name(name: str) -> None:
    """Raise ``KeyError`` unless ``name`` is registered."""
    if name.lower() in _REGISTRY:
        return
    raise KeyError(f"unknown backend {name!r}; available: {', '.join(available_backends())}")


def get_backend(name: str, **kwargs) -> SolverBackend:
    check_backend_name(name)
    return _REGISTRY[name.lower()](**kwargs)


def available_backends() -> List[str]:
    return sorted(_REGISTRY)
