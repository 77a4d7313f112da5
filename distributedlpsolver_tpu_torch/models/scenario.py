"""Two-stage stochastic LP model layer: ``ScenarioLP`` — one base model
× K scenario deltas as a first-class problem object.

A copy of the JAX package's ``models/scenario.py`` (numpy and scipy
only), over this package's ``LPProblem``: the lowered forms, hints and
dicts are the reference's, bit for bit.

The stochastic scenario tier (ROADMAP "stochastic scenario tier") serves
two-stage stochastic LPs

.. code-block:: text

    min  c₀ᵀx₀ + Σ_k p_k·c_kᵀx_k
    s.t. A₀·x₀                 = b₀        (first-stage rows, m0 of them)
         T_k·x₀ + W_k·x_k      = b_k       (recourse rows, scenario k)
         x ≥ 0

whose constraint matrix is the BORDERED (dual block-angular) arrow the
storm generators already emit: scenario blocks couple only through the
shared first-stage columns. ``ScenarioLP`` keeps the blocks unassembled
(A₀/b₀/c₀ + stacked T/W/b/c + probability weights) so the
scenario-decomposed engine (backends/scenario.py) can batch the
per-scenario Schur work over K without re-slicing a monolithic matrix,
while :meth:`ScenarioLP.to_block_angular` lowers to a plain sparse
:class:`LPProblem` — the oracle form every other backend (and HiGHS)
can check the decomposition against.

Serialization is strict JSON (:meth:`to_dict`/:meth:`from_dict`) so a
scenario job survives the durable job journal (serve/journal.py) the
same way plain requests do — all values are finite by construction, so
no inf sentinels are needed.

Generators follow the repo's witness construction (feasible + bounded
by building a strictly feasible primal point and dual certificate
first); ``scenario_delta_stream`` emits waves of b/c-only deltas
against one shared base so the structural fingerprints (which
exclude b and c) hit across waves and the warm cache amortizes.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import scipy.sparse as sp

from distributedlpsolver_tpu_torch.models.problem import LPProblem

_INF = np.inf


def scenario_k_bucket(k: int) -> int:
    """Padded scenario-count bucket for ``k`` scenarios: the pow2 ladder
    (1, 2, 4, 8, ...) the scenario engine compiles one program per. All
    K inside one bucket share the compiled Schur-batch programs — dead
    lanes are masked, never re-traced."""
    if k < 1:
        raise ValueError(f"scenario count must be >= 1; got {k}")
    b = 1
    while b < k:
        b *= 2
    return b


@dataclasses.dataclass
class ScenarioLP:
    """One base model × K scenario deltas (all scenarios share a block
    shape, so the recourse blocks stack into dense (K, ·, ·) tensors).

    ``c`` holds the RAW per-scenario costs; the lowering multiplies in
    the probability weights (min c₀ᵀx₀ + Σ p_k c_kᵀ x_k)."""

    A0: np.ndarray  # (m0, n0) first-stage rows (m0 may be 0)
    b0: np.ndarray  # (m0,)
    c0: np.ndarray  # (n0,) first-stage objective
    T: np.ndarray  # (K, mk, n0) first-stage coupling per scenario
    W: np.ndarray  # (K, mk, nk) recourse blocks
    b: np.ndarray  # (K, mk) recourse rhs
    c: np.ndarray  # (K, nk) recourse objective (pre-probability)
    probs: Optional[np.ndarray] = None  # (K,) weights; None = uniform
    name: str = "scenario"

    def __post_init__(self):
        self.A0 = np.asarray(self.A0, dtype=np.float64)
        self.b0 = np.asarray(self.b0, dtype=np.float64).ravel()
        self.c0 = np.asarray(self.c0, dtype=np.float64).ravel()
        self.T = np.asarray(self.T, dtype=np.float64)
        self.W = np.asarray(self.W, dtype=np.float64)
        self.b = np.asarray(self.b, dtype=np.float64)
        self.c = np.asarray(self.c, dtype=np.float64)
        if self.A0.ndim != 2:
            raise ValueError(f"A0 must be 2-D; got shape {self.A0.shape}")
        m0, n0 = self.A0.shape
        if self.T.ndim != 3 or self.W.ndim != 3:
            raise ValueError("T and W must be (K, mk, ·) stacks")
        K, mk, n0_t = self.T.shape
        _, mk_w, nk = self.W.shape
        if K < 1:
            raise ValueError("a ScenarioLP needs at least one scenario")
        if n0_t != n0 or mk_w != mk or self.W.shape[0] != K:
            raise ValueError(
                f"block shapes disagree: A0 {self.A0.shape}, "
                f"T {self.T.shape}, W {self.W.shape}"
            )
        if self.b0.shape != (m0,) or self.c0.shape != (n0,):
            raise ValueError("b0/c0 shapes disagree with A0")
        if self.b.shape != (K, mk) or self.c.shape != (K, nk):
            raise ValueError("b/c shapes disagree with T/W")
        if self.probs is None:
            self.probs = np.full(K, 1.0 / K)
        else:
            self.probs = np.asarray(self.probs, dtype=np.float64).ravel()
            if self.probs.shape != (K,):
                raise ValueError(f"probs must have shape ({K},)")
            if np.any(self.probs <= 0):
                raise ValueError("probs must be strictly positive")

    # -- shape surface ----------------------------------------------------

    @property
    def n_scenarios(self) -> int:
        return self.T.shape[0]

    @property
    def first_stage_m(self) -> int:
        return self.A0.shape[0]

    @property
    def first_stage_n(self) -> int:
        return self.A0.shape[1]

    @property
    def block_m(self) -> int:
        return self.T.shape[1]

    @property
    def block_n(self) -> int:
        return self.W.shape[2]

    @property
    def m(self) -> int:
        """Rows of the lowered form."""
        return self.first_stage_m + self.n_scenarios * self.block_m

    @property
    def n(self) -> int:
        """Columns of the lowered form."""
        return self.first_stage_n + self.n_scenarios * self.block_n

    def structure_hint(self) -> dict:
        """The ``two_stage`` block-structure hint the lowered problem
        carries — consumed by backends/auto routing, the scenario
        engine's layout resolution, and (first-stage-row-free patterns)
        the bordered-Woodbury preconditioner."""
        return {
            "kind": "two_stage",
            "num_blocks": int(self.n_scenarios),
            "block_m": int(self.block_m),
            "block_n": int(self.block_n),
            "first_stage_n": int(self.first_stage_n),
            "first_stage_m": int(self.first_stage_m),
        }

    # -- lowering ---------------------------------------------------------

    def to_block_angular(self) -> LPProblem:
        """Lower to one assembled sparse :class:`LPProblem` (rows:
        first-stage then scenario blocks; columns: x₀ then per-scenario
        x_k), with the ``two_stage`` structure hint attached. This is
        the oracle form: any backend that can solve a sparse LP checks
        the decomposed engine, and the serve layer journals/routes it
        like any other general-form request (sparse A keeps it off the
        dense bucketed path)."""
        K, mk, nk = self.n_scenarios, self.block_m, self.block_n
        m0, n0 = self.A0.shape
        blocks = [
            [sp.csr_matrix(self.A0)]
            + [None] * K
        ]
        for k in range(K):
            row = [sp.csr_matrix(self.T[k])] + [None] * K
            row[1 + k] = sp.csr_matrix(self.W[k])
            blocks.append(row)
        A = sp.bmat(blocks, format="csr")
        c = np.concatenate(
            [self.c0] + [self.probs[k] * self.c[k] for k in range(K)]
        )
        b = np.concatenate([self.b0] + [self.b[k] for k in range(K)])
        n = n0 + K * nk
        p = LPProblem(
            c=c, A=A, rlb=b, rub=b, lb=np.zeros(n), ub=np.full(n, _INF),
            name=self.name,
        )
        p.block_structure = self.structure_hint()
        return p

    # -- strict-JSON round-trip -------------------------------------------

    def to_dict(self) -> dict:
        """JSON-serializable round-trip (strict JSON: every value is a
        finite float/int/str) — the scenario payload of ``POST
        /v1/solve`` and the journal's replayable spec."""
        return {
            "A0": [[float(v) for v in row] for row in self.A0],
            "b0": [float(v) for v in self.b0],
            "c0": [float(v) for v in self.c0],
            "T": [[[float(v) for v in r] for r in Tk] for Tk in self.T],
            "W": [[[float(v) for v in r] for r in Wk] for Wk in self.W],
            "b": [[float(v) for v in bk] for bk in self.b],
            "c": [[float(v) for v in ck] for ck in self.c],
            "probs": [float(v) for v in self.probs],
            "name": self.name,
            "shape": {
                "n_scenarios": int(self.n_scenarios),
                "block_m": int(self.block_m),
                "block_n": int(self.block_n),
                "first_stage_m": int(self.first_stage_m),
                "first_stage_n": int(self.first_stage_n),
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioLP":
        """Inverse of :meth:`to_dict`."""
        shape = d.get("shape") or {}
        m0 = int(shape.get("first_stage_m", len(d["b0"])))
        n0 = int(shape.get("first_stage_n", len(d["c0"])))
        A0 = np.asarray(d["A0"], dtype=np.float64).reshape(m0, n0)
        return cls(
            A0=A0,
            b0=np.asarray(d["b0"], dtype=np.float64),
            c0=np.asarray(d["c0"], dtype=np.float64),
            T=np.asarray(d["T"], dtype=np.float64),
            W=np.asarray(d["W"], dtype=np.float64),
            b=np.asarray(d["b"], dtype=np.float64),
            c=np.asarray(d["c"], dtype=np.float64),
            probs=(
                np.asarray(d["probs"], dtype=np.float64)
                if d.get("probs") is not None
                else None
            ),
            name=str(d.get("name", "scenario")),
        )


# -- generators --------------------------------------------------------------


def _witness_blocks(rng, K, mk, nk, m0, n0):
    """Random block data + a strictly feasible primal/dual witness pair
    for the lowered form (the repo's feasible+bounded construction)."""
    A0 = rng.standard_normal((m0, n0))
    T = rng.standard_normal((K, mk, n0)) * 0.5
    W = rng.standard_normal((K, mk, nk))
    # Diagonal-ish boost keeps every W_k full row rank (the per-scenario
    # Schur block S_k = W_k·D_k·W_kᵀ must be SPD), mirroring
    # generators.storm_sparse_lp's guaranteed recourse entries.
    for k in range(K):
        idx = np.arange(mk) % nk
        W[k, np.arange(mk), idx] += 2.0 + rng.uniform(0.5, 1.5, size=mk)
    return A0, T, W


def two_stage_storm(
    num_scenarios: int,
    block_m: int = 8,
    block_n: int = 12,
    first_stage_n: int = 8,
    first_stage_m: int = 2,
    seed: int = 0,
    probs: Optional[np.ndarray] = None,
) -> ScenarioLP:
    """Seeded storm-profile two-stage stochastic LP (dense small blocks
    — the scenario engine's native workload; the sparse 20k-row cousin
    is :func:`~distributedlpsolver_tpu_torch.models.generators.storm_sparse_lp`).

    Feasible + bounded by the witness trick on the LOWERED form: draw
    x* > 0, set b from it; draw (y, s > 0), set the lowered c = Aᵀy + s
    and split it back into (c₀, p_k·c_k). ``block_n >= block_m`` keeps
    every recourse block full row rank. Fully seeded."""
    if num_scenarios < 1:
        raise ValueError(
            f"num_scenarios must be >= 1; got {num_scenarios}"
        )
    if block_n < block_m:
        raise ValueError(
            f"block_n ({block_n}) must be >= block_m ({block_m}) so the "
            f"recourse blocks have full row rank"
        )
    rng = np.random.default_rng(seed)
    K, mk, nk = num_scenarios, block_m, block_n
    m0, n0 = first_stage_m, first_stage_n
    A0, T, W = _witness_blocks(rng, K, mk, nk, m0, n0)
    if probs is None:
        raw = rng.uniform(0.5, 1.5, size=K)
        probs = raw / raw.sum()
    probs = np.asarray(probs, dtype=np.float64)

    # Primal witness x* > 0 → b; dual witness (y, s > 0) → c.
    x0s = rng.uniform(0.5, 2.0, size=n0)
    xks = rng.uniform(0.5, 2.0, size=(K, nk))
    b0 = A0 @ x0s
    b = np.einsum("kmn,n->km", T, x0s) + np.einsum(
        "kmn,kn->km", W, xks
    )
    y0 = rng.standard_normal(m0)
    yk = rng.standard_normal((K, mk))
    s0 = rng.uniform(0.5, 2.0, size=n0)
    sk = rng.uniform(0.5, 2.0, size=(K, nk))
    c0 = A0.T @ y0 + np.einsum("kmn,km->n", T, yk) + s0
    # Lowered column block k carries p_k·c_k = W_kᵀy_k + s_k.
    ck = (np.einsum("kmn,km->kn", W, yk) + sk) / probs[:, None]
    return ScenarioLP(
        A0=A0, b0=b0, c0=c0, T=T, W=W, b=b, c=ck, probs=probs,
        name=f"two_stage_storm_K{K}_{mk}x{nk}_n0{n0}_s{seed}",
    )


def scenario_delta_stream(
    n_requests: int,
    num_scenarios: int = 8,
    block_m: int = 6,
    block_n: int = 10,
    first_stage_n: int = 6,
    first_stage_m: int = 2,
    jitter: float = 0.02,
    seed: int = 0,
    offset: int = 0,
) -> Iterator[ScenarioLP]:
    """Waves of b/c-only scenario deltas against ONE shared base: every
    yielded :class:`ScenarioLP` reuses the identical (A₀, T, W, probs)
    and re-derives b/c from jittered witnesses, so all lowered forms
    share one structural fingerprint (utils/fingerprint — b/c excluded)
    and the warm cache amortizes across the wave. Fully seeded;
    ``offset`` skips the first draws so a follow-on wave continues the
    SAME stream (the warm-vs-cold probe's steady-state leg)."""
    base_rng = np.random.default_rng((seed, 7919))
    K, mk, nk = num_scenarios, block_m, block_n
    m0, n0 = first_stage_m, first_stage_n
    A0, T, W = _witness_blocks(base_rng, K, mk, nk, m0, n0)
    raw = base_rng.uniform(0.5, 1.5, size=K)
    probs = raw / raw.sum()
    x0s = base_rng.uniform(0.5, 2.0, size=n0)
    xks = base_rng.uniform(0.5, 2.0, size=(K, nk))
    y0 = base_rng.standard_normal(m0)
    yk = base_rng.standard_normal((K, mk))
    s0 = base_rng.uniform(0.5, 2.0, size=n0)
    sk = base_rng.uniform(0.5, 2.0, size=(K, nk))

    rng = np.random.default_rng((seed, 104729))
    for r in range(offset + n_requests):
        x0j = x0s * (1.0 + jitter * rng.standard_normal(n0))
        xkj = xks * (1.0 + jitter * rng.standard_normal((K, nk)))
        s0j = np.maximum(
            s0 * (1.0 + jitter * rng.standard_normal(n0)), 0.05
        )
        skj = np.maximum(
            sk * (1.0 + jitter * rng.standard_normal((K, nk))), 0.05
        )
        if r < offset:
            continue
        b0 = A0 @ x0j
        b = np.einsum("kmn,n->km", T, x0j) + np.einsum(
            "kmn,kn->km", W, xkj
        )
        c0 = A0.T @ y0 + np.einsum("kmn,km->n", T, yk) + s0j
        ck = (np.einsum("kmn,km->kn", W, yk) + skj) / probs[:, None]
        yield ScenarioLP(
            A0=A0, b0=b0, c0=c0, T=T, W=W, b=b, c=ck, probs=probs,
            name=f"scenario_delta_K{K}_r{r}",
        )
