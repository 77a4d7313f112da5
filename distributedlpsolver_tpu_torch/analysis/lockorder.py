"""Dynamic lock-order recorder — the runtime companion to the static
``guarded-by`` rule.

The static rule proves each shared attribute is accessed under its
lock; it cannot prove two locks are always taken in a consistent
*order* (the classic deadlock: thread A holds ``_lock`` wanting
``_span_lock`` while thread B holds ``_span_lock`` wanting ``_lock``).
This module records the order at runtime: tests wrap the live lock
objects of a real 3-thread ``SolveService`` drain, every acquisition
adds held→acquired edges to a graph, and :meth:`LockOrderRecorder.check`
asserts the graph is acyclic — any cycle is a lock-order inversion that
*can* deadlock, whether or not this run happened to.

The wrapped lock is duck-type compatible with ``threading.Lock`` (and
with being handed to ``threading.Condition``: acquire/release are all
the default Condition shims need), so instrumentation is attribute
replacement, no production-code changes::

    rec = LockOrderRecorder()
    svc._span_lock = rec.wrap(svc._span_lock, "span")
    ...run traffic...
    rec.check()   # raises LockOrderViolation on any cycle
"""

from __future__ import annotations

import threading
from typing import Dict, List, Set, Tuple


class LockOrderViolation(AssertionError):
    """A cycle in the observed lock-acquisition graph."""


class _RecordingLock:
    """Proxy delegating to a real lock, recording acquisition order."""

    def __init__(self, inner, name: str, recorder: "LockOrderRecorder"):
        self._inner = inner
        self._name = name
        self._recorder = recorder

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = (
            self._inner.acquire(blocking, timeout)
            if timeout != -1
            else self._inner.acquire(blocking)
        )
        if ok:
            self._recorder._acquired(self._name)
        return ok

    def release(self) -> None:
        self._recorder._released(self._name)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()


class LockOrderRecorder:
    """Accumulates held→acquired edges across every wrapped lock."""

    def __init__(self):
        self._graph_lock = threading.Lock()
        self._held = threading.local()  # per-thread stack of held names
        self._edges: Dict[str, Set[str]] = {}
        self._names: List[str] = []

    def wrap(self, lock, name: str) -> _RecordingLock:
        with self._graph_lock:
            if name not in self._names:
                self._names.append(name)
        return _RecordingLock(lock, name, self)

    # -- called by the proxies -------------------------------------------

    def _stack(self) -> List[str]:
        if not hasattr(self._held, "stack"):
            self._held.stack = []
        return self._held.stack

    def _acquired(self, name: str) -> None:
        stack = self._stack()
        if stack:
            with self._graph_lock:
                for held in stack:
                    if held != name:
                        self._edges.setdefault(held, set()).add(name)
        stack.append(name)

    def _released(self, name: str) -> None:
        stack = self._stack()
        # Condition.wait releases out of FIFO order is impossible for a
        # plain lock, but be tolerant: remove the most recent entry.
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                break

    # -- inspection ------------------------------------------------------

    def edges(self) -> Set[Tuple[str, str]]:
        with self._graph_lock:
            return {(a, b) for a, succ in self._edges.items() for b in succ}

    def find_cycle(self) -> List[str]:
        """One observed ordering cycle as a lock-name path, or []."""
        with self._graph_lock:
            graph = {a: set(b) for a, b in self._edges.items()}
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in graph}
        path: List[str] = []

        def dfs(n: str):
            color[n] = GRAY
            path.append(n)
            for m in sorted(graph.get(n, ())):
                c = color.get(m, WHITE)
                if c == GRAY:
                    return path[path.index(m) :] + [m]
                if c == WHITE:
                    found = dfs(m)
                    if found:
                        return found
            path.pop()
            color[n] = BLACK
            return []

        for n in sorted(graph):
            if color.get(n, WHITE) == WHITE:
                cycle = dfs(n)
                if cycle:
                    return cycle
        return []

    def check(self) -> None:
        """Raise :class:`LockOrderViolation` if any ordering cycle was
        observed (a potential deadlock, independent of this run's luck)."""
        cycle = self.find_cycle()
        if cycle:
            raise LockOrderViolation(
                "lock-order inversion observed: " + " -> ".join(cycle)
            )
