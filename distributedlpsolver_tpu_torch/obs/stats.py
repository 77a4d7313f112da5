"""The one percentile/summary implementation.

Before this module, p50/p99 was computed three independent ways —
``serve/records.latency_summary`` (np.percentile via a local wrapper),
``bench.py``'s serve row (np.percentile inline), and the probe scripts
(reading whichever of the two they were near) — which is exactly how two
reports of "p99" end up disagreeing on the same data. Everything routes
here now.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """q-th percentile (linear interpolation, numpy semantics); 0.0 for
    an empty input — every caller treats "no data" as a zero row, and a
    NaN would poison downstream JSON."""
    if not len(values):
        return 0.0
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def summarize(
    values: Sequence[float], quantiles: Iterable[int] = (50, 95, 99)
) -> Dict[str, float]:
    """``{count, mean, p50, p95, p99, max}`` over ``values`` (all-zero
    row when empty). The standard per-phase row ``cli report`` prints
    and the serve summary embeds."""
    vals: List[float] = [float(v) for v in values]
    out: Dict[str, float] = {"count": len(vals)}
    if not vals:
        out.update({f"p{q}": 0.0 for q in quantiles})
        out.update(mean=0.0, max=0.0)
        return out
    arr = np.asarray(vals, dtype=np.float64)
    for q in quantiles:
        out[f"p{q}"] = round(float(np.percentile(arr, q)), 3)
    out["mean"] = round(float(arr.mean()), 3)
    out["max"] = round(float(arr.max()), 3)
    return out
