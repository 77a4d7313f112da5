"""Problem-fingerprint warm cache: the serve layer's amortization store.

Correlated traffic (the same model re-solved with perturbed b/c,
near-duplicate requests, parameterized streams) keys to ONE structural
fingerprint (utils/fingerprint.structural_fingerprint — A pattern +
values, shapes, bounds shape; b/c deliberately excluded). Per
fingerprint the cache holds what every same-structure request can
share:

* the last OPTIMAL interior-space iterate — the warm-start seed
  (ipm/warm.py safeguards it before use);
* the Ruiz scaling factors + pre-scaled A — equilibration depends only
  on A, so delta-solves rescale just their b/c/u vectors;
* the detected block-structure hint — structure detection re-routed
  without re-detection.

Bounded LRU with a single lock (graftcheck ``guarded-by`` discipline);
entries are evicted strictly least-recently-used. Lookups verify the
recorded shapes against the request — a key collision (or a corrupted
store) is REJECTED as a miss and counted, never handed to a solve
(``warm_collisions``; the checkpoint-fingerprint lesson, utils/
checkpoint.py v2, applied to the cache).
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Optional

from distributedlpsolver_tpu_torch.ipm.state import IPMState
from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics


@dataclasses.dataclass
class WarmEntry:
    """Everything one structural fingerprint amortizes across requests."""

    m: int
    n: int
    # Last OPTIMAL iterate in the unscaled interior space (host numpy).
    state: Optional[IPMState] = None
    # Ruiz factors + the pre-scaled A they produced (models/scaling.py);
    # valid for ANY b/c of the same structure.
    scaling: Optional[object] = None
    scaled_A: Optional[object] = None
    # Block-structure hint (models/structure.py detection result).
    structure: Optional[dict] = None
    # Final IPM scaling vector d of the last OPTIMAL solve — the
    # sparse-iterative backend's warm preconditioner seed: the next
    # same-structure solve freezes its PCG preconditioner factors on
    # this d for the early (loose-forcing) iterations instead of
    # refactoring every step (backends/sparse_iterative.offer_precond).
    precond_d: Optional[object] = None
    tol: float = 0.0
    solves: int = 0  # OPTIMAL finishes stored under this fingerprint


class WarmCache:
    """Bounded, thread-safe, LRU problem-fingerprint cache."""

    def __init__(
        self,
        capacity: int = 512,
        metrics: Optional[obs_metrics.MetricsRegistry] = None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()  # guarded-by: _lock
        self._hits = 0  # guarded-by: _lock
        self._misses = 0  # guarded-by: _lock
        self._collisions = 0  # guarded-by: _lock
        self._stores = 0  # guarded-by: _lock
        self._evictions = 0  # guarded-by: _lock
        m = metrics if metrics is not None else obs_metrics.get_registry()
        self._m_hits = m.counter(
            "warm_cache_hits_total",
            help="warm-cache lookups that found a usable entry",
        )
        self._m_misses = m.counter(
            "warm_cache_misses_total",
            help="warm-cache lookups with no (or rejected) entry",
        )

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def lookup(self, fingerprint: str, m: int, n: int) -> Optional[WarmEntry]:
        """The entry for ``fingerprint`` (refreshing its LRU position),
        or None. An entry whose recorded shapes disagree with the
        request is a COLLISION: rejected as a miss (and counted) — a
        shape-coincident wrong iterate converges to the wrong answer,
        a shape mismatch merely crashes later and uglier."""
        with self._lock:
            entry = self._entries.get(fingerprint)
            if entry is not None and (entry.m != m or entry.n != n):
                self._collisions += 1
                entry = None
            if entry is None:
                self._misses += 1
            else:
                self._hits += 1
                self._entries.move_to_end(fingerprint)
        if entry is None:
            self._m_misses.inc()
        else:
            self._m_hits.inc()
        return entry

    def store(
        self,
        fingerprint: str,
        m: int,
        n: int,
        state: Optional[IPMState] = None,
        scaling=None,
        scaled_A=None,
        structure=None,
        precond_d=None,
        tol: float = 0.0,
    ) -> None:
        """Insert/refresh the entry for ``fingerprint``, evicting the
        least-recently-used entry past capacity. Fields already cached
        are kept when the new store omits them (a solve that reused the
        cached scaling stores its fresh iterate without re-handing the
        scaling back)."""
        with self._lock:
            prev = self._entries.pop(fingerprint, None)
            if prev is not None and (prev.m != m or prev.n != n):
                prev = None  # collision: never merge across shapes
            entry = WarmEntry(
                m=m,
                n=n,
                state=state if state is not None else (prev.state if prev else None),
                scaling=scaling
                if scaling is not None
                else (prev.scaling if prev else None),
                scaled_A=scaled_A
                if scaled_A is not None
                else (prev.scaled_A if prev else None),
                structure=structure
                if structure is not None
                else (prev.structure if prev else None),
                precond_d=precond_d
                if precond_d is not None
                else (prev.precond_d if prev else None),
                tol=tol or (prev.tol if prev else 0.0),
                solves=(prev.solves if prev else 0) + (1 if state is not None else 0),
            )
            self._entries[fingerprint] = entry
            self._stores += 1
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self._evictions += 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hits": self._hits,
                "misses": self._misses,
                "collisions": self._collisions,
                "stores": self._stores,
                "evictions": self._evictions,
            }
