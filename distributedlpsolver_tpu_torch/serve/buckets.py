"""Shape bucketing: pad arbitrary request shapes onto a small set of
(m, n, batch) buckets so every bucket reuses ONE compiled batched-IPM
program (backends/batched.solve_bucket).

Why bucketing: XLA programs are shape-monomorphic, so serving raw request
shapes would compile per shape — a continuous-batching service amortizes
compilation by rounding shapes up to a geometric ladder (the same design
LLM inference serving uses for sequence lengths, and MPAX's batch-axis
solving implies for this domain). The price is padding waste, which the
service records per dispatch so the ladder can be tuned.

Padding scheme (solution-preserving, strictly-interior-feasible):

* columns n → N: appended columns are zero in A with cost 1, so their
  optimum is 0 and they never perturb the real block;
* rows m → M: each appended row i gets a dedicated appended column p_i
  with ``A[i, p_i] = 1, b[i] = 1, c[p_i] = 1`` — a trivial independent
  1×1 sub-LP (x=1 interior point, nondegenerate dual), keeping A·Aᵀ
  nonsingular where zero rows would break the normal equations.

The padded problem is block-separable (real block ⊕ trivial pad block),
so solving it to tolerance solves the real block to tolerance; the
service recomputes the objective from the real column slice on demux.
Because each pad row needs its own pad column, a bucket can only hold a
request when ``N - n ≥ M - m`` — :meth:`BucketTable.spec_for` enforces
this when choosing the bucket.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One serving bucket: problems padded to (m, n), batch slots per
    device program."""

    m: int
    n: int
    batch: int

    @property
    def cells(self) -> int:
        return self.batch * self.m * self.n

    def key(self) -> Tuple[int, int, int]:
        return (self.m, self.n, self.batch)


def _round_up_pow2(v: int, floor: int = 8) -> int:
    r = floor
    while r < v:
        r *= 2
    return r


class BucketTable:
    """Maps a request shape to its bucket.

    With an explicit ``buckets`` list, the smallest-cell bucket that fits
    (including the pad-column constraint) wins. Without one, buckets are
    created on demand by rounding m and n up to the next power of two
    (≥ 8) — deterministic, so two services over the same request stream
    build the same table.

    ``devices`` is the batch-axis mesh size of the service's dispatches:
    every bucket's batch must divide by it (the sharded program places
    B/devices problems per device). The auto batch is rounded up to the
    next multiple; explicit buckets that don't divide are a configuration
    error and rejected loudly.
    """

    def __init__(
        self,
        buckets: Optional[Sequence[BucketSpec]] = None,
        batch: int = 16,
        devices: int = 1,
    ):
        self.devices = max(1, int(devices))
        if buckets:
            for s in buckets:
                if s.batch % self.devices != 0:
                    raise ValueError(
                        f"bucket {s.key()} batch {s.batch} not divisible by "
                        f"mesh devices {self.devices}"
                    )
        self._explicit = sorted(buckets, key=lambda s: s.cells) if buckets else None
        self._batch = -(-batch // self.devices) * self.devices
        self._auto: dict = {}

    @property
    def batch(self) -> int:
        """Slots per auto-created bucket (already devices-divisible)."""
        return self._batch

    def spec_for(self, m: int, n: int) -> BucketSpec:
        if self._explicit is not None:
            for s in self._explicit:
                if s.m >= m and s.n >= n and (s.n - n) >= (s.m - m):
                    return s
            raise ValueError(
                f"no configured bucket fits request shape ({m}, {n})"
            )
        M = _round_up_pow2(m)
        N = _round_up_pow2(n)
        while (N - n) < (M - m):  # every pad row needs its own pad column
            N *= 2
        key = (M, N)
        spec = self._auto.get(key)
        if spec is None:
            spec = BucketSpec(M, N, self._batch)
            self._auto[key] = spec
        return spec

    def specs(self) -> Tuple[BucketSpec, ...]:
        if self._explicit is not None:
            return tuple(self._explicit)
        return tuple(self._auto.values())


def pad_standard_form(
    c: np.ndarray, A: np.ndarray, b: np.ndarray, M: int, N: int
):
    """Pad one standard-form LP (min cᵀx, Ax=b, x≥0) from (m, n) to the
    bucket shape (M, N) with the solution-preserving scheme above."""
    m, n = A.shape
    if M < m or N < n or (N - n) < (M - m):
        raise ValueError(
            f"cannot pad ({m}, {n}) into bucket ({M}, {N}): need "
            f"M ≥ m, N ≥ n and N - n ≥ M - m"
        )
    A_p = np.zeros((M, N), dtype=np.float64)
    A_p[:m, :n] = A
    b_p = np.ones(M, dtype=np.float64)
    b_p[:m] = b
    c_p = np.ones(N, dtype=np.float64)
    c_p[:n] = c
    for i in range(M - m):
        A_p[m + i, n + i] = 1.0
    return c_p, A_p, b_p


def padding_waste(real_cells: int, spec: BucketSpec) -> float:
    """Fraction of a dispatched bucket's A-cells that were padding (both
    shape padding inside slots and empty slots) — the service telemetry
    field the bucket ladder is tuned against."""
    return 1.0 - real_cells / spec.cells
