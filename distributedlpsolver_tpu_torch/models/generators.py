"""Synthetic LP generators for the benchmark suite and tests.

A copy of ``random_dense_lp``, ``random_sparse_lp``, ``random_general_lp``,
``random_batched_lp`` (with ``BatchedLP``), ``random_request_stream``,
``correlated_request_stream``, ``sparse_request_stream`` (the PDHG
tier's stream) and the sparse tier's ``storm_sparse_lp`` and
``netlib_sparse_lp``, and the block-angular tier's ``block_angular_lp``
(the pds family's profile), from the JAX package's
``models/generators.py``: the same seed gives the same problem (and the
same stream) in both packages, bit for bit.

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


def storm_sparse_lp(
    num_scenarios: int,
    block_m: int = 64,
    block_n: int = 96,
    first_stage_n: int = 64,
    seed: int = 0,
    t_nnz_per_row: int = 4,
    w_nnz_per_row: int = 6,
) -> LPProblem:
    """Storm-class (stormG2-like) two-stage stochastic LP in BORDERED
    (dual block-angular) form — the huge-sparse tier's headline profile.

    Columns are ``[first-stage x₀ (n1) | scenario-local x_b (K·nb)]``;
    rows are K scenario blocks of ``block_m`` equality rows each:

    .. code-block:: text

        T_b·x₀ + W_b·x_b = b_b      (scenario b = 1..K)
        x ≥ 0

    so scenario rows couple ONLY through the n1 first-stage columns —
    exactly the pattern the sparse-iterative backend's bordered Woodbury
    preconditioner inverts without ever forming ADAᵀ. T_b and W_b are
    random sparse with fixed nonzeros per row (every row keeps ≥1
    recourse entry, so no row is first-stage-only).

    Feasible + bounded by the same witness trick as
    :func:`random_dense_lp` / :func:`random_request_stream`'s instances:
    draw x₀, x_b > 0 and set b from them; draw (y₀, s₀ > 0) and set
    ``c = Aᵀy₀ + s₀``. Fully seeded — the same arguments reproduce the
    identical instance, pattern and values.
    """
    rng = np.random.default_rng(seed)
    K, mb, nb, n1 = num_scenarios, block_m, block_n, first_stage_n
    m = K * mb
    n = n1 + K * nb

    rows = []
    cols = []
    vals = []
    for b in range(K):
        r0 = b * mb
        c0 = n1 + b * nb
        # T_b: coupling into the first-stage columns.
        tr = np.repeat(np.arange(r0, r0 + mb), t_nnz_per_row)
        tc = rng.integers(0, n1, size=mb * t_nnz_per_row)
        tv = rng.standard_normal(mb * t_nnz_per_row)
        # W_b: scenario-local recourse block; each row gets a guaranteed
        # diagonal-ish entry (no empty recourse rows) plus random fill.
        wr = np.repeat(np.arange(r0, r0 + mb), w_nnz_per_row)
        wc = c0 + rng.integers(0, nb, size=mb * w_nnz_per_row)
        wv = rng.standard_normal(mb * w_nnz_per_row)
        dr_ = np.arange(r0, r0 + mb)
        dc_ = c0 + (np.arange(mb) % nb)
        dv_ = 1.0 + rng.uniform(0.5, 1.5, size=mb)
        rows += [tr, wr, dr_]
        cols += [tc, wc, dc_]
        vals += [tv, wv, dv_]
    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(m, n),
    ).tocsr()
    A.sum_duplicates()

    x0 = rng.uniform(0.5, 2.0, size=n)
    b_vec = np.asarray(A @ x0).ravel()
    y0 = rng.standard_normal(m)
    s0 = rng.uniform(0.5, 2.0, size=n)
    c = np.asarray(A.T @ y0).ravel() + s0
    p = LPProblem(
        c=c, A=A, rlb=b_vec, rub=b_vec, lb=np.zeros(n), ub=np.full(n, _INF),
        name=f"storm_K{K}_{mb}x{nb}_n1{n1}_s{seed}",
    )
    p.block_structure = {
        "kind": "bordered",
        "num_blocks": K,
        "block_m": mb,
        "block_n": nb,
        "first_stage_n": n1,
    }
    return p


def netlib_sparse_lp(
    m: int, n: int, seed: int = 0, mean_col_nnz: float = 5.0
) -> LPProblem:
    """Netlib-like density profile: column nonzero counts drawn from a
    heavy-tailed (geometric) distribution — most columns carry 2–5
    entries, a few are dense-ish, the way real netlib files look —
    rather than the uniform pattern of :func:`random_sparse_lp`.
    Feasible + bounded by the witness construction; fully seeded."""
    rng = np.random.default_rng(seed)
    counts = rng.geometric(1.0 / max(mean_col_nnz - 1.0, 1.0), size=n) + 1
    counts = np.minimum(counts, m)
    rows = np.concatenate(
        [rng.choice(m, size=k, replace=False) for k in counts]
    )
    cols = np.repeat(np.arange(n), counts)
    vals = rng.standard_normal(counts.sum())
    # Every row gets ≥2 entries so presolve can't trivially shrink it.
    rows = np.concatenate([rows, np.arange(m), np.arange(m)])
    cols = np.concatenate([cols, rng.integers(0, n, m), rng.integers(0, n, m)])
    vals = np.concatenate([vals, rng.standard_normal(2 * m)])
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    A.sum_duplicates()
    x0 = rng.uniform(0.5, 2.0, size=n)
    b = np.asarray(A @ x0).ravel()
    y0 = rng.standard_normal(m)
    s0 = rng.uniform(0.5, 2.0, size=n)
    c = np.asarray(A.T @ y0).ravel() + s0
    return LPProblem(
        c=c, A=A, rlb=b, rub=b, lb=np.zeros(n), ub=np.full(n, _INF),
        name=f"netlib_like_{m}x{n}_s{seed}",
    )


def sparse_request_stream(
    n_requests: int,
    shapes=((12, 40), (16, 48)),
    density: float = 0.25,
    seed: int = 0,
    tol: float = 1e-4,
):
    """Deterministic stream of SMALL sparse-profile standard-form
    requests for the serve layer's tolerance-tiered routing: each yields
    ``(problem, tol)`` where the problem's A is sparse in CONTENT but
    stored dense (ndarray) — at bucket shapes the padded batch tensor is
    dense either way, and dense storage keeps it on the bucketed fast
    path (serve.standard_form). Feasible + bounded by the witness trick
    (same construction as :func:`random_request_stream`); fully seeded.
    The default ``tol=1e-4`` is the PDHG tier — the router must send
    these to the first-order engine."""
    rng = np.random.default_rng(seed)
    for k in range(n_requests):
        m, n = shapes[int(rng.integers(len(shapes)))]
        mask = rng.uniform(size=(m, n)) < density
        mask[np.arange(m), rng.integers(0, n, m)] = True  # no empty rows
        A = rng.standard_normal((m, n)) * mask
        x0 = rng.uniform(0.5, 2.0, size=n)
        b = A @ x0
        y0 = rng.standard_normal(m)
        s0 = rng.uniform(0.5, 2.0, size=n)
        c = A.T @ y0 + s0
        yield (
            LPProblem(
                c=c, A=A, rlb=b, rub=b, lb=np.zeros(n),
                ub=np.full(n, _INF),
                name=f"sparse_req_{m}x{n}_r{k}",
            ),
            tol,
        )


def block_angular_lp(
    num_blocks: int,
    block_m: int,
    block_n: int,
    link_m: int,
    seed: int = 0,
    density: float = 0.3,
    sparse: Optional[bool] = None,
) -> LPProblem:
    """pds-like block-angular LP (BASELINE.json:8 structure).

    Structure (primal block-angular, as in multicommodity flow / stochastic
    programs like stormG2):

    .. code-block:: text

        min Σ_k c_kᵀ x_k
        s.t. B_k x_k = b_k           (local block rows, k = 1..K)
             Σ_k L_k x_k ≤ d        (dense-ish linking rows)
             x ≥ 0

    Feasible+bounded by the same primal/dual construction as
    :func:`random_dense_lp`. Returns a single assembled LPProblem whose rows
    are ordered [block 1 rows, ..., block K rows, linking rows]; the
    block-structured backend re-detects the structure from metadata stored in
    ``prob.block_structure``.
    """
    rng = np.random.default_rng(seed)
    K, mb, nb = num_blocks, block_m, block_n
    n = K * nb
    m = K * mb + link_m

    x0 = rng.uniform(0.5, 2.0, size=n)
    blocks = []
    links = []
    b_loc = []
    for k in range(K):
        Bk = rng.standard_normal((mb, nb)) * (rng.uniform(size=(mb, nb)) < density)
        # Guard against empty rows (would make the row trivially infeasible
        # unless rhs is 0; keep the matrix numerically well-posed instead).
        zero_rows = ~Bk.any(axis=1)
        if zero_rows.any():
            Bk[zero_rows, rng.integers(0, nb, size=zero_rows.sum())] = 1.0
        Lk = rng.standard_normal((link_m, nb)) * (rng.uniform(size=(link_m, nb)) < density)
        blocks.append(Bk)
        links.append(Lk)
        b_loc.append(Bk @ x0[k * nb : (k + 1) * nb])

    L_full = np.hstack(links)
    d = L_full @ x0 + rng.uniform(0.1, 1.0, size=link_m)  # strict slack

    use_sparse = sparse if sparse is not None else (m * n > 200_000)
    if use_sparse:
        A = sp.bmat(
            [
                [sp.csr_matrix(blocks[k]) if kk == k else None for kk in range(K)]
                for k in range(K)
            ]
            + [[sp.csr_matrix(links[k]) for k in range(K)]],
            format="csr",
        )
    else:
        A = np.zeros((m, n))
        for k in range(K):
            A[k * mb : (k + 1) * mb, k * nb : (k + 1) * nb] = blocks[k]
        A[K * mb :, :] = L_full

    # Dual certificate for boundedness: c = Aᵀy + s, s > 0.
    y0 = rng.standard_normal(m)
    y0[K * mb :] = -np.abs(y0[K * mb :])  # linking rows are ≤ → dual y ≤ 0
    s0 = rng.uniform(0.5, 2.0, size=n)
    c = np.asarray(A.T @ y0).ravel() + s0

    rlb = np.concatenate([np.concatenate(b_loc), np.full(link_m, -_INF)])
    rub = np.concatenate([np.concatenate(b_loc), d])
    prob = LPProblem(
        c=c, A=A, rlb=rlb, rub=rub, lb=np.zeros(n), ub=np.full(n, _INF),
        name=f"block_angular_K{K}_{mb}x{nb}_link{link_m}_s{seed}",
    )
    prob.block_structure = {
        "num_blocks": K,
        "block_m": mb,
        "block_n": nb,
        "link_m": link_m,
    }
    return prob
