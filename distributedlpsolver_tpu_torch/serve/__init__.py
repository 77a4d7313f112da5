"""Solve service: an async batching front-end that multiplexes many LP
requests onto bucketed batched device programs (README "Serving").

Public surface: :class:`SolveService` (submit → Future), configured by
:class:`ServiceConfig` over a :class:`BucketSpec` ladder;
:class:`RequestResult` is what futures resolve to;
:class:`ServiceOverloaded` is the admission-control backpressure signal;
:func:`autotune_ladder` refines the bucket ladder from observed
shape/padding telemetry (swap it in live with
``SolveService.apply_ladder``).

The port of the JAX package's ``serve/``: the framework-free modules
are copies, the service drives the torch bucket engine
(``backends/batched.py::solve_bucket``). The network plane over it (HTTP
front-end, SLO-aware admission, brownout, router) is ``net/``;
``serve/elastic.py`` autoscales a pool of ``cli serve-http`` backends.
"""

from distributedlpsolver_tpu_torch.serve.autotune import (
    AutotuneConfig,
    autotune_from_jsonl,
    autotune_ladder,
    ladder_from_json,
    ladder_to_json,
)
from distributedlpsolver_tpu_torch.serve.buckets import (
    BucketSpec,
    BucketTable,
    pad_standard_form,
    padding_waste,
)
from distributedlpsolver_tpu_torch.serve.journal import (
    JobJournal,
    JournaledJob,
    ReplayReport,
)
from distributedlpsolver_tpu_torch.serve.records import (
    RequestResult,
    latency_summary,
)
from distributedlpsolver_tpu_torch.serve.scheduler import (
    PendingRequest,
    Scheduler,
    ServiceOverloaded,
)
from distributedlpsolver_tpu_torch.serve.service import (
    ServiceConfig,
    SolveService,
    standard_form,
)
from distributedlpsolver_tpu_torch.serve.warmcache import WarmCache, WarmEntry

__all__ = [
    "AutotuneConfig",
    "autotune_from_jsonl",
    "autotune_ladder",
    "ladder_from_json",
    "ladder_to_json",
    "BucketSpec",
    "BucketTable",
    "JobJournal",
    "JournaledJob",
    "PendingRequest",
    "ReplayReport",
    "RequestResult",
    "Scheduler",
    "ServiceConfig",
    "ServiceOverloaded",
    "SolveService",
    "WarmCache",
    "WarmEntry",
    "latency_summary",
    "pad_standard_form",
    "padding_waste",
    "standard_form",
]
