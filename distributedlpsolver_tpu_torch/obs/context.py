"""Cross-process trace context (W3C-traceparent-shaped).

One request entering the plane gets exactly one ``trace_id``; every
hop that does work on its behalf (router ingress, each retry/hedge
leg, the backend pipeline, the multi-host follower executing its
dispatch, the CG solve at the bottom of the IPM) emits spans stamped
with that id plus its own ``span_id``/``parent_span_id``, so the
fleet aggregator (``obs/agg.py``, ``cli obs-agg``) can stitch
per-process Perfetto artifacts back into one causal story.

The wire form is the W3C traceparent shape carried in the
``X-DLPS-Trace`` header (``TRACE_HEADER`` in the JAX package's
``net/protocol.py``)::

    00-<trace_id:32 hex>-<span_id:16 hex>-<flags:2 hex>

The ``span_id`` slot carries the *sender's* span: the receiver calls
:meth:`TraceContext.child` to mint its own span under that parent.
Calling :meth:`child` twice on the same context yields two fresh
span_ids sharing the same parent — siblings — which is exactly the
hedge-leg semantics: the router's ingress span is the parent, each
launched leg is a sibling child, and the backend that serves a leg
continues *that* leg's branch.

Everything here is host-side string/int work — contexts ride JSONL
records, HTTP headers, and dispatch-journal meta, never program
inputs, so the zero-warm-recompile invariant is untouched.

A thread-local *current context* lets deep solver code (the IPM host
loop, the sparse-iterative backend) annotate its spans with the
owning request's trace without threading an argument through the
backend protocol: the serve pipeline sets the context around each
solve, :func:`current` reads it.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
from typing import Optional

__all__ = [
    "TraceContext",
    "new_context",
    "parse",
    "current",
    "set_current",
    "use",
]

_TRACEPARENT_RE = re.compile(
    r"^(?P<version>[0-9a-f]{2})-(?P<trace>[0-9a-f]{32})"
    r"-(?P<span>[0-9a-f]{16})-(?P<flags>[0-9a-f]{2})$"
)


def _rand_hex(n_bytes: int) -> str:
    return os.urandom(n_bytes).hex()


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One hop's view of a trace: who am I (``span_id``), which story
    am I part of (``trace_id``), and who caused me (``parent_span_id``,
    empty at the root)."""

    trace_id: str
    span_id: str
    parent_span_id: str = ""
    flags: str = "01"

    def to_header(self) -> str:
        """Wire form; the receiver sees *our* span_id as its parent."""
        return f"00-{self.trace_id}-{self.span_id}-{self.flags}"

    def child(self) -> "TraceContext":
        """A fresh span under this one. Two children of the same
        context are siblings (hedge-leg semantics)."""
        return TraceContext(
            trace_id=self.trace_id,
            span_id=_rand_hex(8),
            parent_span_id=self.span_id,
            flags=self.flags,
        )

    def span_args(self) -> dict:
        """The standard trace annotation for a tracer span/event."""
        args = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_span_id:
            args["parent_span_id"] = self.parent_span_id
        return args


def new_context() -> TraceContext:
    """A root context: fresh trace_id, fresh span_id, no parent."""
    return TraceContext(trace_id=_rand_hex(16), span_id=_rand_hex(8))


def parse(header: Optional[str]) -> Optional[TraceContext]:
    """Tolerant header parse: malformed/absent input yields ``None``
    (the request simply starts a new trace) — a bad client header must
    never fail a solve."""
    if not header or not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    if m.group("trace") == "0" * 32 or m.group("span") == "0" * 16:
        return None
    # The sender's span becomes our parent; we are a fresh span.
    return TraceContext(
        trace_id=m.group("trace"),
        span_id=_rand_hex(8),
        parent_span_id=m.group("span"),
        flags=m.group("flags"),
    )


# --------------------------------------------------------------------------
# Thread-local current context
# --------------------------------------------------------------------------

_tls = threading.local()


def current() -> Optional[TraceContext]:
    """The context set for this thread, or ``None``."""
    return getattr(_tls, "ctx", None)


def set_current(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    """Install ``ctx`` for this thread; returns the previous value so
    callers can restore it."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prev


class use:
    """``with use(ctx): ...`` — scoped :func:`set_current`."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx
        self._prev = None

    def __enter__(self) -> Optional[TraceContext]:
        self._prev = set_current(self._ctx)
        return self._ctx

    def __exit__(self, *exc) -> None:
        set_current(self._prev)
