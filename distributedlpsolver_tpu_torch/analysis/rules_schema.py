"""JSONL schema-conformance rules.

Every telemetry stream in the repo — iteration rows, serve
request/batch records, supervisor fault events, the CLI's serve result
stream — shares one record schema (obs.SCHEMA_VERSION + the field
catalogue in analysis/config), and ``cli report`` / ``cli autotune``
dispatch on those fields. Two statically visible drift modes:

- ``jsonl-fields`` — an ``IterLogger.event({...})`` payload carrying an
  uncatalogued field or event type. Uncatalogued fields are invisible
  to every consumer (report silently drops them; autotune can't use
  them), so adding one must be a deliberate catalogue edit, not a
  stray key. Literal keys are checked; ``**splat`` payloads are checked
  at their own literal source.
- ``jsonl-stamp`` — a record written to a stream (``X.write(
  json.dumps(...))``) without routing through ``stamp_record``, losing
  the schema_version/ts/t_mono stamps that let report merge streams
  across processes. Whole-file JSON artifacts (Chrome traces, metric
  snapshots) use ``json.dump(obj, fh)`` and are exempt by pattern;
  HTTP response bodies are ``json.dumps(...).encode()`` bytes and
  exempt by the same token (replies, not stream records).

Since graftcheck v2 both rules see through one level of local dataflow:
``payload = json.dumps({...}); fh.write(payload)`` is checked at the
write (the heartbeat-writer pattern the lexical rule missed), and
literal dicts passed to ``stamp_record({...})`` have their keys checked
against the catalogue exactly like ``.event({...})`` payloads.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from distributedlpsolver_tpu_torch.analysis import config
from distributedlpsolver_tpu_torch.analysis.core import FileContext, Finding, rule


def _is_event_call(node: ast.Call) -> bool:
    """``<logger-ish>.event({...})`` — the IterLogger event surface (the
    tracer has no ``event`` method, so attribute name is decisive) —
    or a literal record stamped for a stream, ``stamp_record({...})``."""
    if (
        isinstance(node.func, ast.Attribute)
        and node.func.attr == "event"
        and len(node.args) == 1
    ):
        return True
    fn = node.func
    name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
    return name == "stamp_record" and len(node.args) == 1


@rule(
    "jsonl-fields",
    "IterLogger.event/stamp_record payloads carry only catalogued fields/types",
)
def check_event_fields(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call) and _is_event_call(node)):
            continue
        payload = node.args[0]
        if not isinstance(payload, ast.Dict):
            continue  # non-literal payloads are checked at their source
        event_type = None
        for key, value in zip(payload.keys, payload.values):
            if key is None:  # **splat — its literal source is checked
                continue
            if not (isinstance(key, ast.Constant) and isinstance(key.value, str)):
                continue
            if key.value == "event" and isinstance(value, ast.Constant):
                event_type = value.value
            if key.value not in config.JSONL_FIELDS:
                out.append(
                    Finding(
                        rule="jsonl-fields",
                        path=ctx.path,
                        line=key.lineno,
                        col=key.col_offset,
                        message=(
                            f"JSONL field {key.value!r} is not in the "
                            "schema catalogue (analysis/config."
                            "JSONL_FIELDS) — consumers will drop it; "
                            "catalogue it deliberately"
                        ),
                    )
                )
        if event_type is not None and event_type not in config.JSONL_EVENT_TYPES:
            out.append(
                Finding(
                    rule="jsonl-fields",
                    path=ctx.path,
                    line=payload.lineno,
                    col=payload.col_offset,
                    message=(
                        f"event type {event_type!r} is not in "
                        "analysis/config.JSONL_EVENT_TYPES — report/"
                        "autotune will not recognize these records"
                    ),
                )
            )
    return out


def _dumps_arg(node: ast.AST, ctx: Optional[FileContext] = None):
    """The first argument of a ``json.dumps(...)`` call found anywhere
    inside ``node`` (write argument expressions are concatenations).
    ``json.dumps(...).encode()`` results are exempt when ``ctx`` is
    given — those are HTTP body bytes, not stream records."""
    for sub in ast.walk(node):
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "dumps"
            and isinstance(sub.func.value, ast.Name)
            and sub.func.value.id == "json"
            and sub.args
        ):
            if ctx is not None:
                parent = ctx.parents.get(sub)
                if isinstance(parent, ast.Attribute) and parent.attr == "encode":
                    continue
            return sub.args[0]
    return None


def _local_bindings(ctx: FileContext, node: ast.AST) -> dict:
    """name -> last assigned value expression in the enclosing function
    (or module body) — the one level of dataflow the stamp rule sees
    through (``payload = json.dumps(...); fh.write(payload)``)."""
    fn = ctx.enclosing_function(node) or ctx.tree
    out: dict = {}
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Assign):
            for t in sub.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = sub.value
    return out


@rule(
    "jsonl-stamp",
    "stream writes of json.dumps records must route through stamp_record",
)
def check_stamp(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "write"
            and len(node.args) == 1
        ):
            continue
        arg = node.args[0]
        payload = _dumps_arg(arg, ctx)
        if payload is None:
            # One level of local dataflow: a Name in the write argument
            # bound to a json.dumps(...) expression earlier in the
            # function (the heartbeat-writer pattern).
            bindings = None
            for sub in ast.walk(arg):
                if not isinstance(sub, ast.Name):
                    continue
                if bindings is None:
                    bindings = _local_bindings(ctx, node)
                bound = bindings.get(sub.id)
                if bound is not None:
                    payload = _dumps_arg(bound, ctx)
                    if payload is not None:
                        break
        if payload is None:
            continue
        stamped = (
            isinstance(payload, ast.Call)
            and (
                (isinstance(payload.func, ast.Name) and payload.func.id == "stamp_record")
                or (
                    isinstance(payload.func, ast.Attribute)
                    and payload.func.attr == "stamp_record"
                )
            )
        )
        if not stamped:
            out.append(
                Finding(
                    rule="jsonl-stamp",
                    path=ctx.path,
                    line=node.lineno,
                    col=node.col_offset,
                    message=(
                        "JSONL record written without stamp_record — it "
                        "loses schema_version/ts/t_mono and cli report "
                        "cannot merge the stream"
                    ),
                )
            )
    return out
