"""Synthetic LP generators for the benchmark suite and tests.

A copy of ``random_dense_lp``, ``random_sparse_lp``, ``random_general_lp``,
``random_batched_lp`` (with ``BatchedLP``), ``random_request_stream`` and
``correlated_request_stream`` from the JAX package's
``models/generators.py``: the same seed gives the same problem (and the
same stream) in both packages. The block-angular generators are not
ported yet.

All generators construct problems that are feasible and bounded *by
construction* (primal point and dual certificate built first, data derived
from them), so tests can assert convergence unconditionally.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

from distributedlpsolver_tpu_torch.models.problem import LPProblem

_INF = np.inf


def random_dense_lp(m: int, n: int, seed: int = 0, sigma: float = 1.0) -> LPProblem:
    """Random dense standard-form LP ``min cᵀx, Ax=b, x≥0`` (feasible+bounded).

    Construction: draw A; draw an interior primal point ``x0>0`` and set
    ``b = A·x0``; draw dual ``y0`` and slack ``s0>0`` and set
    ``c = Aᵀy0 + s0``. Then x0 is strictly feasible and (y0, s0) is a
    strictly feasible dual point, so an optimum exists (strong duality).
    """
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * sigma
    x0 = rng.uniform(0.5, 2.0, size=n)
    b = A @ x0
    y0 = rng.standard_normal(m)
    s0 = rng.uniform(0.5, 2.0, size=n)
    c = A.T @ y0 + s0
    return LPProblem(
        c=c, A=A, rlb=b, rub=b, lb=np.zeros(n), ub=np.full(n, _INF),
        name=f"random_dense_{m}x{n}_s{seed}",
    )


def random_sparse_lp(
    m: int, n: int, density: float = 0.002, seed: int = 0
) -> LPProblem:
    """Random UNSTRUCTURED sparse standard-form LP (neos3-class stand-in,
    BASELINE.json:10): a uniformly random sparsity pattern, so
    ``models/structure.py``'s block-angular detection legitimately finds
    nothing (every row couples random column subsets — no permutation
    exposes an arrow form). Feasible + bounded by the same primal/dual
    witness construction as :func:`random_dense_lp`; every row is given
    ≥2 nonzeros so no singleton row lets presolve trivially shrink it.
    """
    rng = np.random.default_rng(seed)
    nnz = max(int(density * m * n), 2 * m)
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    # guarantee ≥2 entries per row (pattern stays random elsewhere)
    rows = np.concatenate([rows, np.arange(m), np.arange(m)])
    cols = np.concatenate(
        [cols, rng.integers(0, n, m), rng.integers(0, n, m)]
    )
    vals = np.concatenate([vals, rng.standard_normal(2 * m)])
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    A.sum_duplicates()
    x0 = rng.uniform(0.5, 2.0, size=n)
    b = A @ x0
    y0 = rng.standard_normal(m)
    s0 = rng.uniform(0.5, 2.0, size=n)
    c = A.T @ y0 + s0
    return LPProblem(
        c=c, A=A, rlb=b, rub=b, lb=np.zeros(n), ub=np.full(n, _INF),
        name=f"random_sparse_{m}x{n}_d{density}_s{seed}",
    )


def random_general_lp(
    m: int, n: int, seed: int = 0, frac_eq: float = 0.3, frac_box: float = 0.5
) -> LPProblem:
    """Random *general-form* LP with mixed row senses, ranges, and bounds.

    Exercises the full ``to_interior_form`` conversion (slacks, shifts,
    negations, free splits). Feasible by construction; boundedness is forced
    by boxing a fraction of the variables and keeping c ≥ dual-feasible on
    the rest.
    """
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    x0 = rng.uniform(-1.0, 2.0, size=n)

    lb = np.full(n, -_INF)
    ub = np.full(n, _INF)
    kinds = rng.uniform(size=n)
    for j in range(n):
        if kinds[j] < frac_box:  # boxed
            lb[j] = x0[j] - rng.uniform(0.1, 2.0)
            ub[j] = x0[j] + rng.uniform(0.1, 2.0)
        elif kinds[j] < frac_box + 0.2:  # lower-bounded
            lb[j] = x0[j] - rng.uniform(0.1, 2.0)
        elif kinds[j] < frac_box + 0.4:  # upper-bounded
            ub[j] = x0[j] + rng.uniform(0.1, 2.0)
        # else free

    ax0 = A @ x0
    rlb = np.full(m, -_INF)
    rub = np.full(m, _INF)
    senses = rng.uniform(size=m)
    for i in range(m):
        if senses[i] < frac_eq:  # E
            rlb[i] = rub[i] = ax0[i]
        elif senses[i] < frac_eq + 0.3:  # L
            rub[i] = ax0[i] + rng.uniform(0.1, 1.0)
        elif senses[i] < frac_eq + 0.6:  # G
            rlb[i] = ax0[i] - rng.uniform(0.1, 1.0)
        else:  # ranged
            rlb[i] = ax0[i] - rng.uniform(0.1, 1.0)
            rub[i] = ax0[i] + rng.uniform(0.1, 1.0)

    # Bounded objective: make c a nonnegative combination that cannot dive to
    # -inf along any ray of the (partially unbounded) feasible set. Simplest
    # robust choice: c = Aᵀy + s with s>0 only guaranteed to bound the
    # standard-form recession cone, which here may include negative
    # directions for non-lb variables; so penalize those toward their finite
    # side instead.
    c = rng.standard_normal(n)
    for j in range(n):
        if not np.isfinite(lb[j]) and not np.isfinite(ub[j]):
            c[j] = 0.0  # free var: keep objective flat to guarantee bounded
        elif not np.isfinite(lb[j]):
            c[j] = -abs(c[j])  # only ub finite: push up toward ub
        elif not np.isfinite(ub[j]):
            c[j] = abs(c[j])  # only lb finite: push down toward lb
    return LPProblem(
        c=c, A=A, rlb=rlb, rub=rub, lb=lb, ub=ub,
        name=f"random_general_{m}x{n}_s{seed}",
    )


@dataclasses.dataclass
class BatchedLP:
    """A batch of independent standard-form LPs with identical shapes.

    ``A``: (B, m, n); ``b``: (B, m); ``c``: (B, n). Lower bounds are 0 and
    there are no upper bounds — the batched backend consumes this
    directly (BASELINE.json:11: 1024 × (m=128, n=512)).
    """

    c: np.ndarray
    A: np.ndarray
    b: np.ndarray
    name: str = "batched"

    @property
    def batch(self) -> int:
        return self.A.shape[0]

    @property
    def m(self) -> int:
        return self.A.shape[1]

    @property
    def n(self) -> int:
        return self.A.shape[2]

    def problem(self, k: int) -> LPProblem:
        m, n = self.m, self.n
        return LPProblem(
            c=self.c[k], A=self.A[k], rlb=self.b[k], rub=self.b[k],
            lb=np.zeros(n), ub=np.full(n, _INF), name=f"{self.name}[{k}]",
        )


def random_batched_lp(batch: int, m: int, n: int, seed: int = 0) -> BatchedLP:
    """Batch of feasible+bounded standard-form LPs (same construction as
    :func:`random_dense_lp`, vectorized over a leading batch axis)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((batch, m, n))
    x0 = rng.uniform(0.5, 2.0, size=(batch, n))
    b = np.einsum("bmn,bn->bm", A, x0)
    y0 = rng.standard_normal((batch, m))
    s0 = rng.uniform(0.5, 2.0, size=(batch, n))
    c = np.einsum("bmn,bm->bn", A, y0) + s0
    return BatchedLP(c=c, A=A, b=b, name=f"batched_{batch}x{m}x{n}_s{seed}")


def random_request_stream(
    n_requests: int,
    shapes=((8, 24), (12, 32)),
    seed: int = 0,
):
    """Deterministic stream of standard-form LP requests at randomly drawn
    shapes — the serve/ layer's test and load-probe workload. Each request
    is a feasible+bounded :func:`random_dense_lp` instance (standard form:
    all-equality rows, x ≥ 0), so the service routes it to the bucketed
    fast path and every request has an OPTIMAL reference solve."""
    rng = np.random.default_rng(seed)
    for k in range(n_requests):
        m, n = shapes[int(rng.integers(len(shapes)))]
        yield random_dense_lp(m, n, seed=int(rng.integers(2**31 - 1)))


def correlated_request_stream(
    n_requests: int,
    shapes=((8, 24), (12, 32)),
    n_models: int = 4,
    jitter: float = 0.01,
    cost_jitter: Optional[float] = None,
    seed: int = 0,
    offset: int = 0,
):
    """Correlated serve traffic: a few base MODELS re-solved with
    perturbed b/c — the workload the warm-start & amortization layer
    exists for (near-duplicate requests, parameterized streams; same A,
    new b/c, so same-model requests share one structural fingerprint).

    Each of the ``n_models`` base models fixes (A, x0, y0, s0) on a
    shape drawn from ``shapes``; each request picks a model uniformly
    and re-derives ``b = A·(x0·(1+jitter·g))`` and
    ``c = Aᵀ·y0 + s0·(1+cost_jitter·g)`` from jittered witnesses —
    every instance stays feasible+bounded by construction (the
    :func:`random_dense_lp` argument), and the perturbation never
    touches A or the bounds pattern. Fully seeded: the same seed yields
    the identical stream, models and jitters included; ``offset`` skips
    the first draws of that stream, so a follow-on wave continues the
    SAME models with fresh perturbations (the warm-vs-cold probe's
    steady-state leg).
    """
    if cost_jitter is None:
        cost_jitter = jitter
    models = []
    for i in range(n_models):
        m, n = shapes[i % len(shapes)]
        mr = np.random.default_rng((seed, 7919, i))
        A = mr.standard_normal((m, n))
        x0 = mr.uniform(0.5, 2.0, size=n)
        y0 = mr.standard_normal(m)
        s0 = mr.uniform(0.5, 2.0, size=n)
        models.append((i, A, x0, y0, s0))
    rng = np.random.default_rng((seed, 104729))
    for k in range(offset + n_requests):
        i, A, x0, y0, s0 = models[int(rng.integers(n_models))]
        m, n = A.shape
        xk = x0 * (1.0 + jitter * rng.standard_normal(n))
        sk = np.maximum(s0 * (1.0 + cost_jitter * rng.standard_normal(n)), 0.05)
        if k < offset:
            continue
        b = A @ xk
        c = A.T @ y0 + sk
        yield LPProblem(
            c=c, A=A, rlb=b, rub=b, lb=np.zeros(n), ub=np.full(n, _INF),
            name=f"corr_m{i}_{m}x{n}_r{k}",
        )
