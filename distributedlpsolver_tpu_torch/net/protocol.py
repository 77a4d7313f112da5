"""Wire protocol of the HTTP serving plane: request parsing and
response encoding (stdlib ``json`` only). The port of the JAX package's
``net/protocol.py``, over this package's ``LPProblem``, MPS reader and
generators.

``POST /v1/solve`` accepts either

- a JSON body (``Content-Type: application/json``) with the problem
  inline — ``{"problem": {"c": [...], "A": [[...]], "b": [...]}}``
  (standard form min cᵀx, Ax=b, x≥0), a generated instance
  ``{"m": 8, "n": 24, "seed": 3}`` (the load-test surface — the same
  feasible+bounded generator the JSONL debug loop uses), a two-stage
  stochastic scenario set ``{"scenarios": {...}}`` (explicit base +
  per-scenario T/W/b/c blocks, or generated ``n_scenarios``/``seed``
  — routed to the scenario-decomposed engine, admission charged by K),
  or an MPS document inline as
  ``{"mps_text": "..."}`` — plus the request fields ``tol``,
  ``deadline_ms``, ``tenant``, ``priority``, ``async``, ``id``; or
- a raw MPS text body (any other content type), with the same request
  fields taken from the query string
  (``/v1/solve?tenant=acme&deadline_ms=500``).

Responses are JSON; :func:`result_payload` maps a
:class:`~distributedlpsolver_tpu_torch.serve.RequestResult` onto the response
body and its HTTP status code (terminal verdicts are 200 — the solver's
verdict rides the ``status`` field; deadline expiry is 504; an
exhausted recovery ladder is 500).
"""

from __future__ import annotations

import dataclasses
import json
import math
import urllib.parse
from typing import Optional, Tuple

import numpy as np

from distributedlpsolver_tpu_torch.ipm.state import Status
from distributedlpsolver_tpu_torch.models.problem import LPProblem

# Every application-level response a backend front-end sends carries
# this header. It lets the router tell a backend-ORIGINATED 504/503
# (a solver TIMEOUT verdict, a graceful shutdown — normal outcomes that
# must pass through to the client) from a transport/gateway failure of
# the same code, which is failover evidence.
PLANE_HEADER = "X-DLPS-Plane"
PLANE_BACKEND = "backend"

# Remaining-deadline-budget header (milliseconds, decimal). The router
# stamps it on every forward and re-stamps the REMAINING budget (original
# minus elapsed) on every retry and hedge, so a hop never resurrects
# already-spent budget. Backends treat it as an upper bound on the body's
# own ``deadline_ms`` and admission-reject expired-on-arrival work with a
# structured verdict instead of queueing it to die.
DEADLINE_HEADER = "X-DLPS-Deadline-Ms"

# Trace-context header (W3C traceparent shape:
# ``00-<trace_id:32hex>-<span_id:16hex>-<flags:2hex>``; see
# obs/context.py). The router mints a context at ingress when the
# client didn't send one and re-stamps a FRESH child span per retry and
# per hedge leg — legs are siblings under the ingress span — so the
# backend a leg lands on continues exactly that leg's branch. Malformed
# values are ignored (a new trace starts); the context is host-side
# metadata only and never reaches program inputs.
TRACE_HEADER = "X-DLPS-Trace"


class ProtocolError(ValueError):
    """Malformed request body/fields — the HTTP 400 path."""


@dataclasses.dataclass
class SolveRequest:
    """One parsed ``POST /v1/solve`` request."""

    problem: LPProblem
    tol: Optional[float] = None
    deadline_s: Optional[float] = None
    tenant: str = "default"
    priority: str = "normal"
    want_async: bool = False
    name: Optional[str] = None
    include_x: bool = True


def _scenario_problem(sc: dict) -> LPProblem:
    """Build the lowered two-stage problem from a ``scenarios`` payload:
    either a generated instance (``n_scenarios``/``seed`` + optional
    block-shape fields — the load-test surface, same seeded generator
    the tests use) or an explicit base + per-scenario blocks
    (``ScenarioLP.to_dict`` form). The lowered LPProblem carries the
    ``two_stage`` hint, so the service routes it to the
    scenario-decomposed engine and charges fair-share units by K."""
    from distributedlpsolver_tpu_torch.models.scenario import ScenarioLP, two_stage_storm

    if not isinstance(sc, dict):
        raise ProtocolError("'scenarios' must be an object")
    try:
        if "n_scenarios" in sc and "A0" not in sc:
            slp = two_stage_storm(
                int(sc["n_scenarios"]),
                block_m=int(sc.get("block_m", 8)),
                block_n=int(sc.get("block_n", 12)),
                first_stage_n=int(sc.get("first_stage_n", 8)),
                first_stage_m=int(sc.get("first_stage_m", 2)),
                seed=int(sc.get("seed", 0)),
            )
        elif "A0" in sc:
            slp = ScenarioLP.from_dict(sc)
        else:
            raise ProtocolError(
                "'scenarios' needs generated 'n_scenarios'/'seed' or an "
                "explicit base ('A0'/'b0'/'c0' + 'T'/'W'/'b'/'c')"
            )
    except ProtocolError:
        raise
    except (KeyError, TypeError, ValueError) as e:
        raise ProtocolError(f"bad scenarios payload: {e}")
    return slp.to_block_angular()


def _problem_from_spec(spec: dict) -> LPProblem:
    if "scenarios" in spec:
        return _scenario_problem(spec["scenarios"])
    if "mps_text" in spec:
        from distributedlpsolver_tpu_torch.io.mps import read_mps_string

        try:
            return read_mps_string(str(spec["mps_text"]))
        except Exception as e:
            raise ProtocolError(f"bad MPS body: {type(e).__name__}: {e}")
    if "problem" in spec:
        p = spec["problem"]
        try:
            c = np.asarray(p["c"], dtype=np.float64)
            A = np.asarray(p["A"], dtype=np.float64)
            b = np.asarray(p["b"], dtype=np.float64)
        except (KeyError, TypeError, ValueError) as e:
            raise ProtocolError(f"bad inline problem: {e}")
        if A.ndim != 2 or c.shape != (A.shape[1],) or b.shape != (A.shape[0],):
            raise ProtocolError(
                f"inline problem shapes disagree: A{list(A.shape)}, "
                f"c[{c.size}], b[{b.size}]"
            )
        m, n = A.shape
        return LPProblem(
            c=c, A=A, rlb=b, rub=b, lb=np.zeros(n),
            ub=np.full(n, np.inf), name=str(spec.get("id", f"http_{m}x{n}")),
        )
    if "m" in spec and "n" in spec:
        from distributedlpsolver_tpu_torch.models.generators import random_dense_lp

        return random_dense_lp(
            int(spec["m"]), int(spec["n"]), seed=int(spec.get("seed", 0))
        )
    raise ProtocolError(
        "request needs one of: 'problem' (inline c/A/b), 'mps_text', "
        "'scenarios' (base + deltas or generated n_scenarios/seed), "
        "or generated 'm'/'n'/'seed'"
    )


def _fields_from(spec: dict, req: SolveRequest) -> SolveRequest:
    if spec.get("tol") is not None:
        req.tol = float(spec["tol"])
    if spec.get("deadline_ms") is not None:
        req.deadline_s = float(spec["deadline_ms"]) / 1e3
    if spec.get("tenant") is not None:
        req.tenant = str(spec["tenant"])
    if spec.get("priority") is not None:
        req.priority = str(spec["priority"])
    a = spec.get("async")
    req.want_async = a in (True, 1, "1", "true", "yes")
    if spec.get("id") is not None:
        req.name = str(spec["id"])
    x = spec.get("include_x")
    if x is not None:
        req.include_x = x in (True, 1, "1", "true", "yes")
    return req


def parse_solve_request(
    body: bytes, content_type: str = "application/json", query: str = ""
) -> SolveRequest:
    """Parse one ``POST /v1/solve`` body (+ query string) into a
    :class:`SolveRequest`. Raises :class:`ProtocolError` on anything
    malformed — the handler's 400 path."""
    qfields = {
        k: v[0] for k, v in urllib.parse.parse_qs(query or "").items()
    }
    if "json" in (content_type or "").lower():
        try:
            spec = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ProtocolError(f"bad JSON body: {e}")
        if not isinstance(spec, dict):
            raise ProtocolError("JSON body must be an object")
        spec = {**qfields, **spec}  # inline fields win over the query
        req = SolveRequest(problem=_problem_from_spec(spec))
        return _fields_from(spec, req)
    # Raw MPS body; request fields ride the query string.
    try:
        text = body.decode("utf-8")
    except UnicodeDecodeError as e:
        raise ProtocolError(f"MPS body is not UTF-8: {e}")
    if not text.strip():
        raise ProtocolError("empty request body")
    req = SolveRequest(problem=_problem_from_spec({"mps_text": text}))
    return _fields_from(qfields, req)


def peek_route_hint(
    body: bytes, content_type: str = "application/json", query: str = ""
) -> Optional[Tuple[int, int, float]]:
    """Cheap (m, n, tol) extraction for the router's shape-aware pick —
    reads the JSON envelope without materializing the problem (and
    without importing numpy work): explicit ``m``/``n``, or the inline
    problem's array lengths. Returns None when the shape isn't visible
    (raw MPS body without query hints) — the router then routes on load
    alone."""
    qfields = {
        k: v[0] for k, v in urllib.parse.parse_qs(query or "").items()
    }
    spec: dict = dict(qfields)
    if "json" in (content_type or "").lower():
        try:
            parsed = json.loads(body.decode("utf-8"))
            if isinstance(parsed, dict):
                spec.update(parsed)
        except (UnicodeDecodeError, json.JSONDecodeError):
            return None
    try:
        tol = float(spec.get("tol", 1e-8))
        if "m" in spec and "n" in spec:
            return int(spec["m"]), int(spec["n"]), tol
        p = spec.get("problem")
        if isinstance(p, dict) and "b" in p and "c" in p:
            return len(p["b"]), len(p["c"]), tol
    except (TypeError, ValueError):
        return None
    return None


def peek_deadline_tenant(
    body: bytes, content_type: str = "application/json", query: str = ""
) -> Tuple[Optional[float], str]:
    """Cheap (deadline_ms, tenant) extraction for the router's deadline
    propagation and per-tenant retry-budget accounting — reads the JSON
    envelope (or the query string for raw-MPS bodies) without
    materializing the problem. deadline_ms is None when the request is
    unbounded."""
    qfields = {
        k: v[0] for k, v in urllib.parse.parse_qs(query or "").items()
    }
    spec: dict = dict(qfields)
    if "json" in (content_type or "").lower():
        try:
            parsed = json.loads(body.decode("utf-8"))
            if isinstance(parsed, dict):
                spec.update(parsed)
        except (UnicodeDecodeError, json.JSONDecodeError):
            pass  # backend's parse will 400; nothing to propagate
    try:
        dl = spec.get("deadline_ms")
        deadline_ms = None if dl is None else float(dl)
    except (TypeError, ValueError):
        deadline_ms = None
    tenant = str(spec.get("tenant") or "default")
    return deadline_ms, tenant


def restamp_deadline(
    body: bytes,
    content_type: str,
    query: str,
    remaining_ms: float,
) -> Tuple[bytes, str]:
    """Rewrite the request's own ``deadline_ms`` to the remaining budget
    (a retry/hedge must not resurrect spent budget). JSON bodies carry
    the field inline; raw-MPS bodies carry it in the query string.
    Returns (body, query) — unchanged when the original carried no
    deadline (the header the caller stamps is then the only budget)."""
    remaining_ms = max(0.0, float(remaining_ms))
    if "json" in (content_type or "").lower():
        try:
            spec = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError):
            return body, query
        if isinstance(spec, dict) and spec.get("deadline_ms") is not None:
            spec["deadline_ms"] = round(remaining_ms, 3)
            return json.dumps(spec).encode("utf-8"), query
        return body, query
    q = urllib.parse.parse_qs(query or "")
    if "deadline_ms" in q:
        q["deadline_ms"] = [f"{remaining_ms:.3f}"]
        return body, urllib.parse.urlencode(q, doseq=True)
    return body, query


# RequestResult.status -> HTTP code. Terminal solver verdicts are 200
# (the verdict is data, not transport failure); a queued-past-deadline
# request is the gateway-timeout class; an exhausted recovery ladder is
# the server-error class; client-requested cancellation is 499 (the
# nginx client-closed-request convention — the hedge loser's verdict).
_STATUS_HTTP = {
    Status.TIMEOUT: 504,
    Status.FAILED: 500,
    Status.CANCELLED: 499,
}


def _finite(v) -> Optional[float]:
    """float(v), or None when non-finite: TIMEOUT/FAILED results carry
    inf gaps/residuals (and NaN objectives), and ``json.dumps`` would
    serialize those as ``Infinity``/``NaN`` — not valid JSON, so strict
    clients could not parse exactly the error bodies."""
    v = float(v)
    return v if math.isfinite(v) else None


def result_payload(result, include_x: bool = True) -> Tuple[int, dict]:
    """(http_code, response_body) for one finished request. All float
    fields are sanitized to strict JSON (non-finite -> null)."""
    code = _STATUS_HTTP.get(result.status, 200)
    body = {
        "id": result.request_id,
        "name": result.name,
        "status": result.status.value,
        "objective": _finite(result.objective),
        "iterations": int(result.iterations),
        "rel_gap": _finite(result.rel_gap),
        "pinf": _finite(result.pinf),
        "dinf": _finite(result.dinf),
        "bucket": list(result.bucket) if result.bucket else None,
        "m": int(result.m),
        "n": int(result.n),
        "tenant": result.tenant,
        "priority": result.priority,
        "warm": result.warm,
        "queue_ms": round(result.queue_ms, 3),
        "solve_ms": round(result.solve_ms, 3),
        "total_ms": round(result.total_ms, 3),
        "faults": [f.asdict() for f in result.faults],
    }
    if getattr(result, "n_scenarios", None):
        body["n_scenarios"] = int(result.n_scenarios)
        body["scenario_bucket"] = (
            int(result.scenario_bucket) if result.scenario_bucket else None
        )
        body["schur_ms"] = round(result.schur_ms, 3)
        body["link_ms"] = round(result.link_ms, 3)
    if include_x and result.x is not None:
        body["x"] = [float(v) for v in result.x]
    return code, body


def payload_from_record(rec: dict) -> Tuple[int, dict]:
    """(http_code, response_body) from a journal-stored result record
    (``RequestResult.record()`` + optional ``"x"``) — the durable twin
    of :func:`result_payload`, used when a poll id resolves from the
    on-disk store after a front-end restart rather than from a live
    Future. Same status→code mapping, same strict-JSON sanitization."""
    status = str(rec.get("status", "failed"))
    code = {
        Status.TIMEOUT.value: 504,
        Status.FAILED.value: 500,
        Status.CANCELLED.value: 499,
    }.get(status, 200)

    def _f(key):
        v = rec.get(key)
        if v is None:
            return None
        v = float(v)
        return v if math.isfinite(v) else None

    body = {
        "id": rec.get("id"),
        "name": rec.get("name"),
        "status": status,
        "objective": _f("objective"),
        "iterations": int(rec.get("iterations", 0)),
        "rel_gap": _f("rel_gap"),
        "pinf": _f("pinf"),
        "dinf": _f("dinf"),
        "bucket": rec.get("bucket"),
        "m": int(rec.get("m", 0)),
        "n": int(rec.get("n", 0)),
        "tenant": rec.get("tenant", "default"),
        "priority": rec.get("priority", "normal"),
        "warm": rec.get("warm", "cold"),
        "queue_ms": rec.get("queue_ms", 0.0),
        "solve_ms": rec.get("solve_ms", 0.0),
        "total_ms": rec.get("total_ms", 0.0),
        "faults": rec.get("faults", []),
        "recovered": True,  # served from the durable store
    }
    if rec.get("n_scenarios"):
        # Scenario-tier fields survive the journal round-trip: a poll
        # served from the durable store carries the same K/bucket/stage
        # split a live-future response would.
        body["n_scenarios"] = int(rec["n_scenarios"])
        body["scenario_bucket"] = rec.get("scenario_bucket")
        body["schur_ms"] = rec.get("schur_ms", 0.0)
        body["link_ms"] = rec.get("link_ms", 0.0)
    if rec.get("x") is not None:
        body["x"] = [float(v) for v in rec["x"]]
    return code, body


def error_payload(code: int, error: str, **extra) -> Tuple[int, dict]:
    return code, {"error": error, **extra}
