"""Network serving plane over :class:`~distributedlpsolver_tpu_torch.serve.
SolveService`: the port of the JAX package's ``net/``, with the same HTTP
routes, JSON bodies and JSONL events. Only the health probe differs: it
touches the service's device through ``torch`` (``utils/accel.py``).

Three layers, all stdlib-only (``http.server`` + ``json`` — no new
dependencies):

- **Front-end** (:mod:`net.server`, :mod:`net.protocol`): an HTTP
  surface — ``POST /v1/solve`` (sync or async-poll), ``GET
  /v1/solve/{id}``, ``GET /metrics`` (Prometheus text off the obs
  registry), ``GET /healthz`` (device probes + pipeline liveness), and
  ``GET /statusz`` — bridging request bodies onto ``SolveService.submit``
  futures.
- **SLO-aware admission** (:mod:`net.admission`): per-tenant token-bucket
  quotas, weighted-fair admission under contention, and priority classes
  that shade the scheduler's flush window; verdicts ride
  :class:`~distributedlpsolver_tpu_torch.serve.ServiceOverloaded` out to the
  429 path.
- **Router tier** (:mod:`net.router`): a front process holding a live
  backend registry — shape-aware routing onto each backend's advertised
  bucket ladder, load-aware tie-breaking from polled ``/statusz``,
  health-checked failover with retry-once semantics.
- **Crash-safe fabric** (README "Durability & graceful shutdown"):
  :mod:`net.registry` — a file-backed shared backend table so N
  replicated routers agree on ejections/re-admissions (cross-process
  stale-probe guard, single-writer lease); drain endpoints
  (``/readyz``, ``POST /quitquitquit``) over the durable job journal
  in :mod:`distributedlpsolver_tpu_torch.serve.journal`; and
  :mod:`net.chaos` — the deterministic kill -9 / torn-tail / stall
  harness ``scripts/port_probe_chaos.py`` drives.
"""

from distributedlpsolver_tpu_torch.net.admission import (
    AdmissionConfig,
    AdmissionController,
    TenantLabeler,
    TenantQuota,
    Verdict,
)
from distributedlpsolver_tpu_torch.net.protocol import (
    ProtocolError,
    SolveRequest,
    parse_solve_request,
    payload_from_record,
    peek_route_hint,
    result_payload,
)
from distributedlpsolver_tpu_torch.net.registry import BackendRegistry
from distributedlpsolver_tpu_torch.net.router import Router, RouterConfig
from distributedlpsolver_tpu_torch.net.server import NetConfig, SolveHTTPServer

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "BackendRegistry",
    "NetConfig",
    "ProtocolError",
    "Router",
    "RouterConfig",
    "SolveHTTPServer",
    "SolveRequest",
    "TenantLabeler",
    "TenantQuota",
    "Verdict",
    "parse_solve_request",
    "payload_from_record",
    "peek_route_hint",
    "result_payload",
]
