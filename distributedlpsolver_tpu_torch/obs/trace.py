"""Span tracer emitting Chrome-trace-format JSON (Perfetto-loadable).

One :class:`Tracer` accumulates events in memory (bounded) and writes a
``{"traceEvents": [...]}`` JSON object at :meth:`close`. Event phases
used (the Trace Event Format's stable subset):

- ``X`` complete spans — one lane per pipeline thread (the thread id is
  the OS thread ident; an ``M`` metadata event names each lane the
  first time it emits).
- ``b``/``e`` async spans keyed by ``(cat, id)`` — the cross-thread
  request track: ``request <id>`` begins on the submit thread, its
  nested ``queue``/``pack``/``solve`` phases begin and end on whichever
  pipeline thread handles them, and the track ends where the result is
  finished. Perfetto renders each (cat, id) pair as one connected track
  regardless of which threads emitted the events.
- ``i`` instant events — supervisor faults, reshards, ladder swaps,
  admission rejections.

Timestamps are microseconds on the ``time.perf_counter`` clock (the
same monotonic clock every JSONL record's ``t_mono`` stamp uses, so a
trace and a JSONL stream from one process line up exactly).

Like the metrics registry, the module default is :data:`NULL_TRACER`,
whose methods are no-ops — instrumentation sites call unconditionally
and the disabled path allocates nothing. The real tracer takes one lock
per event append; it is never on the device path.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Iterator, Optional

# Bound on buffered events: a runaway loop must not grow host memory
# without bound. 1M events ≈ a few hundred MB of JSON — far above any
# probe run; on overflow the tracer drops new events and records that it
# did in the file's metadata.
MAX_EVENTS = 1_000_000


def _now_us() -> float:
    return time.perf_counter() * 1e6


class Tracer:
    """Collects Chrome-trace events; ``close()`` writes the JSON file."""

    enabled = True

    def __init__(self, path: str, process_name: str = "distributedlpsolver"):
        self.path = path
        self._lock = threading.Lock()
        self._events: list = []  # guarded-by: _lock
        self._named_threads: set = set()  # guarded-by: _lock
        self._dropped = 0  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        self._events.append(
            {
                "ph": "M", "name": "process_name", "pid": 1, "tid": 0,
                "args": {"name": process_name},
            }
        )

    # -- internals -------------------------------------------------------

    def _emit(self, ev: dict) -> None:
        tid = ev.setdefault("tid", threading.get_ident())
        ev.setdefault("pid", 1)
        with self._lock:
            if self._closed:
                return
            if len(self._events) >= MAX_EVENTS:
                self._dropped += 1
                return
            if tid not in self._named_threads:
                self._named_threads.add(tid)
                self._events.append(
                    {
                        "ph": "M", "name": "thread_name", "pid": 1,
                        "tid": tid,
                        "args": {"name": threading.current_thread().name},
                    }
                )
            self._events.append(ev)

    # -- synchronous spans (thread lanes) --------------------------------

    @contextlib.contextmanager
    def span(
        self, name: str, cat: str = "", args: Optional[dict] = None
    ) -> Iterator[None]:
        """``X`` complete span on the calling thread's lane."""
        t0 = _now_us()
        try:
            yield
        finally:
            self._emit(
                {
                    "ph": "X", "name": name, "cat": cat or "span",
                    "ts": t0, "dur": _now_us() - t0,
                    **({"args": args} if args else {}),
                }
            )

    def complete(
        self,
        name: str,
        dur_s: float,
        cat: str = "",
        args: Optional[dict] = None,
        end_us: Optional[float] = None,
    ) -> None:
        """``X`` span for an interval that already happened (the caller
        measured ``dur_s`` itself and is reporting after the fact)."""
        end = _now_us() if end_us is None else end_us
        self._emit(
            {
                "ph": "X", "name": name, "cat": cat or "span",
                "ts": end - dur_s * 1e6, "dur": dur_s * 1e6,
                **({"args": args} if args else {}),
            }
        )

    # -- async request tracks (cross-thread) -----------------------------

    def async_begin(
        self, name: str, track: int, cat: str = "request",
        args: Optional[dict] = None,
    ) -> None:
        self._emit(
            {
                "ph": "b", "name": name, "cat": cat, "id": track,
                "ts": _now_us(), **({"args": args} if args else {}),
            }
        )

    def async_end(
        self, name: str, track: int, cat: str = "request",
        args: Optional[dict] = None,
    ) -> None:
        self._emit(
            {
                "ph": "e", "name": name, "cat": cat, "id": track,
                "ts": _now_us(), **({"args": args} if args else {}),
            }
        )

    # -- instants --------------------------------------------------------

    def instant(self, name: str, args: Optional[dict] = None,
                cat: str = "event") -> None:
        self._emit(
            {
                "ph": "i", "name": name, "cat": cat, "ts": _now_us(),
                "s": "p",  # process-scoped marker line
                **({"args": args} if args else {}),
            }
        )

    # -- lifecycle -------------------------------------------------------

    def event_count(self) -> int:
        with self._lock:
            return len(self._events)

    def close(self) -> Optional[str]:
        """Write the trace JSON; returns the path (idempotent — later
        calls rewrite with whatever accumulated since, so a service can
        flush at shutdown while the CLI flushes again at exit)."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        payload = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "clock": "perf_counter_us",
                **({"dropped_events": dropped} if dropped else {}),
            },
        }
        with open(self.path, "w") as fh:
            json.dump(payload, fh)
            fh.write("\n")
        return self.path


class _NullTracer:
    """Disabled tracer: same surface, every method a no-op (the span
    context manager is a shared reusable null context)."""

    enabled = False
    path = None

    __slots__ = ()

    def span(self, name, cat="", args=None):
        return _NULL_CONTEXT

    def complete(self, name, dur_s, cat="", args=None, end_us=None):
        pass

    def async_begin(self, name, track, cat="request", args=None):
        pass

    def async_end(self, name, track, cat="request", args=None):
        pass

    def instant(self, name, args=None, cat="event"):
        pass

    def event_count(self) -> int:
        return 0

    def close(self):
        return None


_NULL_CONTEXT = contextlib.nullcontext()
NULL_TRACER = _NullTracer()

from distributedlpsolver_tpu_torch.obs import DefaultSlot  # noqa: E402

_DEFAULT = DefaultSlot(NULL_TRACER)


def get_tracer():
    return _DEFAULT.get()


def set_tracer(tracer) -> object:
    """Install ``tracer`` as the module default (None restores the no-op
    tracer); returns the previous default for scoped restore."""
    return _DEFAULT.set(tracer)
