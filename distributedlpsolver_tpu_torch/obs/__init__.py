"""Observability layer: metrics registry, span tracer, the request trace
context, shared stats, the ``cli report`` analyzer (``obs.report``) and
the fleet telemetry aggregator (``obs.agg``, ``cli obs-agg``).

A copy of the JAX package's ``obs/`` (all of it stdlib-only). Disabled by
default: the module-level registry and tracer are no-ops that allocate
nothing per call.
"""

# Version of the shared JSONL record schema (the stamp fields
# schema_version/ts/t_mono plus each stream's own payload). Bump when a
# stamped field changes meaning; readers must keep accepting records
# with a missing or older version (pre-stamp files have none).
SCHEMA_VERSION = 1

import threading  # noqa: E402


class DefaultSlot:
    """The one module-default holder metrics and trace both use.
    ``set`` installs a new default and returns the previous one so
    callers can restore it (tests, scoped CLI runs); ``None`` restores
    the null instance. ``get`` is deliberately lockless — the default is
    resolved on hot paths and a torn read is impossible for a single
    reference."""

    def __init__(self, null):
        self._null = null
        self._lock = threading.Lock()
        self._value = null

    def get(self):
        return self._value

    def set(self, value):
        with self._lock:
            prev = self._value
            self._value = value if value is not None else self._null
        return prev


# NOTE: DefaultSlot must be defined ABOVE these imports — metrics and
# trace import it from the partially-initialized package.
from distributedlpsolver_tpu_torch.obs.metrics import (  # noqa: E402
    MetricsRegistry,
    NULL as NULL_REGISTRY,
    get_registry,
    set_registry,
)
from distributedlpsolver_tpu_torch.obs.stats import (  # noqa: E402
    percentile,
    summarize,
)
from distributedlpsolver_tpu_torch.obs.trace import (  # noqa: E402
    NULL_TRACER,
    Tracer,
    get_tracer,
    set_tracer,
)
from distributedlpsolver_tpu_torch.obs.context import (  # noqa: E402
    TraceContext,
    new_context,
)
from distributedlpsolver_tpu_torch.obs import agg, report  # noqa: E402

__all__ = [
    "SCHEMA_VERSION",
    "DefaultSlot",
    "MetricsRegistry",
    "NULL_REGISTRY",
    "NULL_TRACER",
    "Tracer",
    "TraceContext",
    "get_registry",
    "set_registry",
    "get_tracer",
    "set_tracer",
    "new_context",
    "percentile",
    "summarize",
    "agg",
    "report",
]
