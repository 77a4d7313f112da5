"""Thread-safe in-process metrics registry (counters, gauges,
fixed-bucket histograms) with Prometheus-text and JSON snapshot
exporters.

Design constraints, in order:

1. **Zero-cost when disabled.** The module default is :data:`NULL`, a
   registry whose instruments are shared singletons with no-op methods —
   no locks taken, no objects allocated per call — so the IPM driver can
   increment an iteration counter unconditionally without the no-obs
   path paying anything measurable (tier-1 timing envelopes and the
   zero-warm-recompile invariant must be untouched).
2. **Hot-path instruments are pre-resolved.** ``registry.counter(name)``
   does a locked dict lookup; callers on per-iteration paths resolve
   their instruments once (driver: before the loop; service: in
   ``__init__``) and then call ``inc()``/``observe()`` — a bare method
   call on a few primitives.
3. **Host-side only.** Nothing here touches a device value; callers
   observe wall-clock floats they already measured. Instrumentation must
   never add a device sync.

Labels are a plain dict; an instrument's identity is (name, sorted
label items), matching Prometheus semantics. Histograms use fixed
upper-inclusive bucket edges (Prometheus ``le``), cumulative in the
text exposition, plus ``sum``/``count``.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, Optional, Sequence, Tuple

# Default histogram edges for millisecond-scale latencies (pack/solve/
# queue) — roughly log-spaced from sub-ms to minutes.
LATENCY_MS_BUCKETS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1_000.0, 2_500.0, 5_000.0, 10_000.0, 30_000.0, 60_000.0,
)
# Seconds-scale variant (IPM step times, recovery overhead).
SECONDS_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0,
)
# Fractions in [0, 1] (padding waste, overlap ratio).
RATIO_BUCKETS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)
# IPM iteration counts per solve/request (the warm-vs-cold split rides
# an {start="warm"|"cold"} label on this histogram).
ITER_BUCKETS = (
    1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0, 48.0, 64.0,
    96.0, 128.0, 200.0,
)
# Scenario counts per scenario-tier request (the pow2 bucket ladder of
# models/scenario.scenario_k_bucket, extended to pod-scale K).
SCENARIO_K_BUCKETS = (
    1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
    1024.0, 4096.0, 16384.0,
)

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Optional[dict]) -> _Key:
    if not labels:
        return (name, ())
    return (name, tuple(sorted((str(k), str(v)) for k, v in labels.items())))


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class Counter:
    """Monotonically increasing count. ``inc`` is the only mutator."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """A value that goes up and down (queue depth, mesh width)."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram, Prometheus ``le`` semantics: bucket ``i``
    counts observations ``v <= edges[i]``; values above the last edge
    land only in the implicit ``+Inf`` bucket (``count``)."""

    __slots__ = (
        "edges", "_counts", "_sum", "_count", "_lock", "_exemplar"
    )

    def __init__(self, edges: Sequence[float]):
        if list(edges) != sorted(edges) or len(set(edges)) != len(edges):
            raise ValueError(f"histogram edges must be sorted, unique: {edges}")
        self.edges = tuple(float(e) for e in edges)
        self._counts = [0] * len(self.edges)
        self._sum = 0.0
        self._count = 0
        # Slowest-observation exemplar: (value, trace_id-or-label). One
        # slot, max-value wins — "which request was this histogram's
        # worst" is the question the fleet aggregator answers with it.
        self._exemplar: Optional[Tuple[float, str]] = None
        self._lock = threading.Lock()

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        v = float(value)
        with self._lock:
            self._sum += v
            self._count += 1
            # Linear scan beats bisect at these edge counts (<= ~16) and
            # allocates nothing.
            for i, e in enumerate(self.edges):
                if v <= e:
                    self._counts[i] += 1
                    break
            if exemplar is not None and (
                self._exemplar is None or v > self._exemplar[0]
            ):
                self._exemplar = (v, str(exemplar))

    def snapshot(self) -> dict:
        with self._lock:
            snap = {
                "buckets": {
                    f"{e:g}": c for e, c in zip(self.edges, self._counts)
                },
                "sum": self._sum,
                "count": self._count,
            }
            if self._exemplar is not None:
                snap["exemplar"] = {
                    "value": self._exemplar[0],
                    "trace_id": self._exemplar[1],
                }
            return snap

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


class _NullInstrument:
    """Shared do-nothing counter/gauge/histogram. The methods take the
    same arguments as the real ones and return immediately — no lock, no
    allocation — so disabled-mode instrumentation costs one bound-method
    call per site."""

    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        pass

    def snapshot(self) -> dict:
        return {}

    value = 0.0
    count = 0
    sum = 0.0
    edges = ()


_NULL_INSTRUMENT = _NullInstrument()


class MetricsRegistry:
    """Get-or-create home of named instruments.

    ``counter``/``gauge``/``histogram`` return the same instrument for
    the same (name, labels) forever; a name registered as one kind
    cannot be re-registered as another (raises TypeError — silent kind
    confusion corrupts both exporters).
    """

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[_Key, object] = {}  # guarded-by: _lock
        self._kinds: Dict[str, str] = {}  # guarded-by: _lock
        self._help: Dict[str, str] = {}  # guarded-by: _lock

    def _get(self, kind: str, name: str, labels, help_, factory):
        key = _key(name, labels)
        with self._lock:
            prev = self._kinds.get(name)
            if prev is not None and prev != kind:
                raise TypeError(
                    f"metric {name!r} already registered as {prev}, "
                    f"not {kind}"
                )
            inst = self._instruments.get(key)
            if inst is None:
                inst = factory()
                self._instruments[key] = inst
                self._kinds[name] = kind
                if help_:
                    self._help[name] = help_
            return inst

    def counter(
        self, name: str, labels: Optional[dict] = None, help: str = ""
    ) -> Counter:
        return self._get("counter", name, labels, help, Counter)

    def gauge(
        self, name: str, labels: Optional[dict] = None, help: str = ""
    ) -> Gauge:
        return self._get("gauge", name, labels, help, Gauge)

    def histogram(
        self,
        name: str,
        buckets: Sequence[float] = LATENCY_MS_BUCKETS,
        labels: Optional[dict] = None,
        help: str = "",
    ) -> Histogram:
        return self._get(
            "histogram", name, labels, help, lambda: Histogram(buckets)
        )

    # -- exporters -------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-serializable view: ``{name{labels}: value-or-hist}`` —
        the form embedded into bench rows and the serve summary event."""
        with self._lock:
            items = list(self._instruments.items())
            kinds = dict(self._kinds)
        out: dict = {}
        for (name, labels), inst in sorted(items):
            full = name + _label_str(labels)
            if kinds[name] == "histogram":
                out[full] = inst.snapshot()
            else:
                out[full] = inst.value
        return out

    def to_prometheus_text(self) -> str:
        """Prometheus text exposition (v0.0.4): HELP/TYPE headers, one
        sample line per instrument, cumulative ``_bucket{le=}`` series
        plus ``_sum``/``_count`` for histograms."""
        with self._lock:
            items = sorted(self._instruments.items())
            kinds = dict(self._kinds)
            helps = dict(self._help)
        lines = []
        seen_header = set()
        for (name, labels), inst in items:
            if name not in seen_header:
                seen_header.add(name)
                if name in helps:
                    lines.append(f"# HELP {name} {helps[name]}")
                lines.append(f"# TYPE {name} {kinds[name]}")
            if kinds[name] == "histogram":
                snap = inst.snapshot()
                cum = 0
                for edge, c in zip(
                    inst.edges, snap["buckets"].values()
                ):
                    cum += c
                    ls = dict(labels)
                    ls["le"] = f"{edge:g}"
                    lines.append(
                        f"{name}_bucket{_label_str(tuple(sorted(ls.items())))}"
                        f" {cum}"
                    )
                ls = dict(labels)
                ls["le"] = "+Inf"
                lines.append(
                    f"{name}_bucket{_label_str(tuple(sorted(ls.items())))}"
                    f" {snap['count']}"
                )
                lines.append(f"{name}_sum{_label_str(labels)} {snap['sum']:g}")
                lines.append(
                    f"{name}_count{_label_str(labels)} {snap['count']}"
                )
            else:
                lines.append(f"{name}{_label_str(labels)} {inst.value:g}")
        return "\n".join(lines) + "\n"

    def write_prometheus(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_prometheus_text())

    def write_snapshot(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.snapshot(), fh, indent=2, sort_keys=True)
            fh.write("\n")


class NullRegistry(MetricsRegistry):
    """The disabled registry: every instrument request returns the one
    shared no-op instrument; both exporters render empty."""

    enabled = False

    def __init__(self):
        pass  # no lock, no dicts — nothing to protect

    def counter(self, name, labels=None, help=""):
        return _NULL_INSTRUMENT

    def gauge(self, name, labels=None, help=""):
        return _NULL_INSTRUMENT

    def histogram(self, name, buckets=LATENCY_MS_BUCKETS, labels=None, help=""):
        return _NULL_INSTRUMENT

    def snapshot(self) -> dict:
        return {}

    def to_prometheus_text(self) -> str:
        return ""


NULL = NullRegistry()

# Module-level default: NULL until something (the CLI flags, bench.py, a
# test) installs a real registry. Components resolve it at construction
# time, so a registry installed after a service started does not
# retroactively instrument it.
from distributedlpsolver_tpu_torch.obs import DefaultSlot  # noqa: E402

_DEFAULT = DefaultSlot(NULL)


def get_registry() -> MetricsRegistry:
    return _DEFAULT.get()


def set_registry(registry: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Install ``registry`` as the module default (None restores the
    no-op NULL). Returns the previous default so callers can restore it
    (tests, scoped CLI runs)."""
    return _DEFAULT.set(registry)
