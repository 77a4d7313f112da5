"""Scenario-decomposed two-stage IPM — the stochastic scenario tier's
engine.

The port of the JAX package's ``backends/scenario.py``
(``ScenarioBackend``, registered as ``scenario``). A two-stage stochastic
LP lowers to the bordered (dual block-angular) standard form

.. code-block:: text

    A = [[A0, 0      ],        rows: m0 first-stage + K·mb recourse
         [T,  blk(W_k)]]       cols: n0 first-stage + K·nb recourse

whose normal matrix M = A·diag(d)·Aᵀ this backend never assembles. Each
Newton solve is preconditioned CG on ``v ↦ A·(d∘Aᵀ·v)`` with the
classical two-stage elimination as its preconditioner:

1. **Per-scenario Schur blocks**, batched: ``S_k = W_k·D_k·W_kᵀ`` over
   all K lanes in one launch of the normal-equations kernel
   (``ops/normal_eq.py``, the lanes on its batch axis), one batched
   Cholesky, ``Y_k = L_k⁻¹·T_k`` by one batched triangular solve and the
   closure ``C = Σ_k Y_kᵀ·Y_k`` as one GEMM on the (K·mb, n0) view.
2. **Linking factor**: ``H = C + D0⁻¹`` (n0×n0) and its Cholesky,
   ``G = H⁻¹·A0ᵀ`` and the Cholesky of ``F = A0·G`` (m0×m0, empty when
   the model has no first-stage rows).
3. **Application**: ``t = Σ_k T_kᵀ·S_k⁻¹·r_k``, the linking solve for
   dy0 and ``w0 = H⁻¹·(A0ᵀ·dy0 + t)``, then every ``dy_k = S_k⁻¹·(r_k −
   T_k·w0)`` by batched back-substitution.

The lanes pad K up the pow2 bucket ladder (``models/scenario.
scenario_k_bucket``): a dead lane has W = T = 0 and a unit diagonal, so
its factor is the identity and it adds exactly zero to C and to every
application. The stacks are built on the device by scattering A's
entries through index maps — no host loop over scenarios and no dense
host copy of any block. The reference cuts the lanes into chunks of 128
(``SCENARIO_CHUNK``, a TPU program-size workaround); here every padded
lane runs in one launch (``chunks`` is 1), so C sums in another order
than the reference's (about 1e-15 relative).

CG keeps the reference's rules, which set the iteration counts: the
first iterate is the applied decomposition, the threshold 1e-12·‖r‖, the
cap ``config.cg_iters``, an exit on a non-finite or non-positive
curvature, and the best iterate seen is returned. The operator is the
port's ``ops/sparse.py`` hybrid-ELL operator (the hand-written SpMV
kernel on a card), so the iterate never leaves the device; the loop asks
the host whether to go on once per chunk of masked iterations (each
masked iteration after the exit changes nothing), counted as host syncs.

The Mehrotra core runs eagerly through the driver's host loop, as the
reference's does (``ipm/core.py`` on this backend's device). Stage times
are CUDA-event times on a card, read when the step's statistics come to
the host, so timing adds no sync: ``schur_ms``/``link_ms`` time each
factorization's two stages and ``solve_ms`` each CG solve as a whole. The
reference also adds every application's stages to ``schur_ms``/
``link_ms``; four events an application cost ~10% of a warm solve on the
card (``scripts/port_time_stage_clock.py``), so the port does not.

On a mesh (``ScenarioBackend(mesh=)``, ``parallel/mesh.py``) the padded
lanes are split over the mesh's batch axis (its last when it has none)
where the reference splits them, ``min(k_pad, SCENARIO_CHUNK) % R == 0``;
otherwise every member holds every lane, as the reference's replicated
placement does, and the solve is ``mesh=None``'s. The member at position
i of the axis holds lanes ``[i·k_pad/R, (i+1)·k_pad/R)`` (the reference's
blocks are per 128-lane chunk, which changes only C's summation order),
scattered from its lanes' entries of A alone; A0 and
CG's operator (the whole A) are replicated. A factorization runs K1 over
the member's lanes and sums C over the members (one all-reduce); an
application sums ``t`` (one) and the members' ``dy`` rows, each member
writing its own rows of a zeroed m-vector through its inverse map (one).
Every sum is ``Mesh.sum_parts``, so every rank ends each application with
the same bits and CG takes the same exits everywhere. ``mesh=None`` is
member 0 of 1 on the same code, so a mesh of one (local, or a world of
one) gives its bits.
"""

from __future__ import annotations

import importlib
import threading
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from distributedlpsolver_tpu_torch.backends.base import SolverBackend, register_backend
from distributedlpsolver_tpu_torch.backends.block_angular import _cho_solve, _cholesky, _pad
from distributedlpsolver_tpu_torch.backends.dense import _torch_dtype, resolve_device
from distributedlpsolver_tpu_torch.ipm import core
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.ipm.state import IPMState, StepStats
from distributedlpsolver_tpu_torch.models.problem import InteriorForm
from distributedlpsolver_tpu_torch.models.scenario import ScenarioLP, scenario_k_bucket
from distributedlpsolver_tpu_torch.ops import pcg as pcg_ops
from distributedlpsolver_tpu_torch.ops import sparse as sparse_ops
from distributedlpsolver_tpu_torch.ops.normal_eq import normal_eq


class ScenarioLayout(NamedTuple):
    K: int  # scenarios
    k_pad: int  # lanes: K padded up its bucket
    mb: int  # rows of the largest scenario block
    nb: int  # columns of the largest scenario block
    m0: int  # first-stage rows
    n0: int  # first-stage columns
    m: int
    n: int


# The reference's lane chunk (a TPU program-size cap): its lanes split
# over a mesh only when the mesh divides a chunk.
SCENARIO_CHUNK = 128


class ScenarioTensors(NamedTuple):
    """One member's share of the arrow-structured A on its device — the
    lanes ``[lo, hi)`` of the padded stacks (all of them for one member),
    the replicated first stage — with the maps the operators gather
    through. Padded slots of ``rows_idx``/``cols_idx`` point at m/n (a
    zero appended to the vector they index)."""

    W: torch.Tensor  # (lanes, mb, nb) recourse blocks
    T: torch.Tensor  # (lanes, mb, n0) first-stage coupling of each block
    A0: torch.Tensor  # (m0, n0) first-stage rows
    rows0: torch.Tensor  # (m0,) interior rows of the first stage
    cols0: torch.Tensor  # (n0,) interior columns of the first stage
    rows_idx: torch.Tensor  # (lanes, mb) interior row of each block row
    cols_idx: torch.Tensor  # (lanes, nb) interior column of each block column
    pad_row: torch.Tensor  # (lanes, mb) 1 on padded rows, else 0
    # (m,) slot of each row in cat([dy_K (lanes·mb), dy_0 (m0), 0]): the
    # last, zero, for rows of other members' lanes and, on every member
    # but the first, for the first stage's rows.
    row_pos: torch.Tensor


class _Arrow(NamedTuple):
    """A's entries classified on the host against the ``two_stage``
    layout: what every member's :func:`place_lanes` reads."""

    lay: "ScenarioLayout"
    A: sp.csr_matrix
    er: np.ndarray  # row of each stored entry
    ec: np.ndarray  # column of each stored entry
    rk: np.ndarray  # scenario of each entry's row (-1: the first stage)
    is_w: np.ndarray
    is_t: np.ndarray
    is_0: np.ndarray
    lr: np.ndarray  # each row's rank in its block (or in the first stage)
    lc: np.ndarray  # each column's rank in its block (or in the first stage)
    rb: np.ndarray
    cb: np.ndarray
    rorder: np.ndarray  # block rows, by block
    corder: np.ndarray  # block columns, by block
    rows0: np.ndarray
    cols0: np.ndarray


def scenario_program_cache_size() -> int:
    """Compiled programs the tier holds: the hand kernels' libraries it
    has loaded (K1 and the ELL SpMV, 0 before the first solve on a card
    and on the CPU). The reference's meter counts the jitted programs of
    each padded (scenario bucket, block shape); the port compiles nothing
    per key — each kernel source is built once whatever the shapes, the
    rest are library calls — so after the first solve this is constant by
    construction, and a K-mixed stream cannot grow it. Kept for the
    reference's API."""
    # The modules (the package's ``ops.normal_eq`` attribute is the function).
    mods = ("distributedlpsolver_tpu_torch.ops.normal_eq", "distributedlpsolver_tpu_torch.ops.ell_spmv")
    return sum(importlib.import_module(m)._lib is not None for m in mods)


class _ReportSlot:
    """Telemetry of the most recent scenario solve in this process — the
    serve layer's per-request ``schur_ms``/``link_ms`` source (the solo
    path runs solves one at a time on its thread, so last-solve semantics
    are race-free there)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: dict = {}  # guarded-by: _lock

    def reset(self, **base) -> None:
        with self._lock:
            self._data = dict(base)

    def add(self, key: str, v: float) -> None:
        with self._lock:
            self._data[key] = self._data.get(key, 0.0) + v

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._data)


_REPORT = _ReportSlot()


def last_solve_report() -> dict:
    """Telemetry of the last scenario solve: ``n_scenarios``,
    ``scenario_bucket`` (padded K), ``chunks`` (lane launches a stage: 1
    here), the block shape, accumulated ``schur_ms`` (the factorizations'
    batched per-scenario stage), ``link_ms`` (their first-stage factor)
    and ``solve_ms`` (the CG solves: applications of the decomposition,
    products with A and vector work), ``factorizations``, ``solves``
    (applications of the decomposition), ``cg_iters``, ``cg_masked``
    (masked CG iterations run past an exit, between two host reads) and
    ``host_syncs`` (host reads of CG's exit flag)."""
    return _REPORT.snapshot()


def _layout_from_hint(hint: dict, m: int, n: int):
    """(row_block, col_block) index maps from a ``two_stage`` hint:
    per-row/col scenario id, -1 for first-stage rows/columns. Accepts the
    compact contiguous form (block_m/block_n/first_stage_*) the lowering
    emits and the explicit array form detection emits."""
    K = int(hint["num_blocks"])
    if "row_block" in hint and "col_block" in hint:
        rb = np.asarray(hint["row_block"], dtype=np.int64)
        cb = np.asarray(hint["col_block"], dtype=np.int64)
        if rb.shape != (m,) or cb.shape != (n,):
            raise ValueError(
                f"two_stage hint index maps have shapes {rb.shape}/"
                f"{cb.shape}; expected ({m},)/({n},)"
            )
        return K, rb, cb
    mb = int(hint["block_m"])
    nb = int(hint["block_n"])
    m0 = int(hint.get("first_stage_m", 0))
    n0 = int(hint["first_stage_n"])
    if m0 + K * mb != m or n0 + K * nb != n:
        raise ValueError(
            f"two_stage hint (K={K}, mb={mb}, nb={nb}, m0={m0}, n0={n0}) "
            f"does not tile A's shape ({m}, {n})"
        )
    rb = np.full(m, -1, dtype=np.int64)
    cb = np.full(n, -1, dtype=np.int64)
    rb[m0:] = np.repeat(np.arange(K, dtype=np.int64), mb)
    cb[n0:] = np.repeat(np.arange(K, dtype=np.int64), nb)
    return K, rb, cb


def _local_index(ids: np.ndarray, K: int):
    """Per-entry rank inside its block (blocks 0..K-1, in index order),
    the block sizes, and the (K, max size) map back, padded with -1."""
    live = np.flatnonzero((ids >= 0) & (ids < K))
    order = live[np.argsort(ids[live], kind="stable")]
    counts = np.bincount(ids[live], minlength=K)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    local = np.full(ids.shape[0], -1, dtype=np.int64)
    local[order] = np.arange(order.size) - np.repeat(starts, counts)
    return local, counts, order


def analyze_arrow(inf: InteriorForm) -> _Arrow:
    """The layout from the ``two_stage`` hint and A's entries classified
    against it. Raises ValueError for a missing or malformed hint, no
    first-stage columns, an empty scenario block, or entries outside the
    arrow (a first-stage row touching a scenario column, or coupling
    between scenarios): the supervisor then degrades to the sparse tier
    on the assembled form."""
    hint = inf.block_structure or {}
    if hint.get("kind") != "two_stage":
        raise ValueError(
            "scenario backend needs a two_stage block-structure hint "
            "(models/scenario.ScenarioLP.to_block_angular or "
            "models/structure.detect_two_stage)"
        )
    m, n = inf.m, inf.n
    K, rb, cb = _layout_from_hint(hint, m, n)
    rows0 = np.flatnonzero(rb == -1)
    cols0 = np.flatnonzero(cb == -1)
    if len(cols0) == 0:
        raise ValueError("two_stage hint marks no first-stage columns")
    lr, rcount, rorder = _local_index(rb, K)
    lc, ccount, corder = _local_index(cb, K)
    if K < 1 or (rcount == 0).any() or (ccount == 0).any():
        raise ValueError("two_stage hint has an empty scenario block")
    mb, nb = int(rcount.max()), int(ccount.max())
    m0, n0 = len(rows0), len(cols0)
    lay = ScenarioLayout(K=K, k_pad=scenario_k_bucket(K), mb=mb, nb=nb, m0=m0, n0=n0, m=m, n=n)
    lr[rows0] = np.arange(m0)
    lc[cols0] = np.arange(n0)

    # Every stored entry of A (nonzeros of a dense A), each position once.
    A = sp.csr_matrix(inf.A, dtype=np.float64)
    A.sum_duplicates()
    er = np.repeat(np.arange(m, dtype=np.int64), np.diff(A.indptr))
    ec = A.indices.astype(np.int64)
    rk, ck = rb[er], cb[ec]
    in_block = (rk >= 0) & (rk < K)
    is_w = in_block & (ck == rk)
    is_t = in_block & (ck == -1)
    is_0 = (rk == -1) & (ck == -1)
    outside = A.nnz - int(is_w.sum() + is_t.sum() + is_0.sum())
    if outside:
        raise ValueError(
            f"A has {outside} entries outside the two_stage arrow pattern — "
            f"not scenario-decomposable"
        )
    if rorder.size + m0 != m:
        raise ValueError("two_stage hint leaves a row in no block and not in the first stage")
    return _Arrow(lay=lay, A=A, er=er, ec=ec, rk=rk, is_w=is_w, is_t=is_t, is_0=is_0, lr=lr,
                  lc=lc, rb=rb, cb=cb, rorder=rorder, corder=corder, rows0=rows0, cols0=cols0)


def place_lanes(arrow: _Arrow, lo: int, hi: int, dtype, device) -> ScenarioTensors:
    """The member holding lanes ``[lo, hi)``: its stacks scattered on
    ``device`` from its lanes' entries of A alone (never a full stack
    sliced), the replicated first stage, and its inverse map ``row_pos``
    (the first stage's rows on the member with lane 0 only)."""
    a, lay = arrow, arrow.lay
    m, mb, nb, m0, n0 = lay.m, lay.mb, lay.nb, lay.m0, lay.n0
    lanes = hi - lo
    mine = (a.rk >= lo) & (a.rk < hi)
    slot = (a.rk - lo) * mb + a.lr[a.er]  # (lane, row) of a block entry

    def scatter(size, sel, flat):
        out = torch.zeros(size, dtype=dtype, device=device)
        out[torch.from_numpy(flat[sel]).to(device)] = torch.from_numpy(a.A.data[sel]).to(
            device=device, dtype=dtype)
        return out

    W = scatter(lanes * mb * nb, a.is_w & mine, slot * nb + a.lc[a.ec]).view(lanes, mb, nb)
    T = scatter(lanes * mb * n0, a.is_t & mine, slot * n0 + a.lc[a.ec]).view(lanes, mb, n0)
    A0 = scatter(m0 * n0, a.is_0, a.lr[a.er] * n0 + a.lc[a.ec]).view(m0, n0)

    ro = a.rorder[(a.rb[a.rorder] >= lo) & (a.rb[a.rorder] < hi)]
    co = a.corder[(a.cb[a.corder] >= lo) & (a.cb[a.corder] < hi)]
    rows_idx = np.full((lanes, mb), m, dtype=np.int64)
    rows_idx[a.rb[ro] - lo, a.lr[ro]] = ro
    cols_idx = np.full((lanes, nb), lay.n, dtype=np.int64)
    cols_idx[a.cb[co] - lo, a.lc[co]] = co
    row_pos = np.full(m, lanes * mb + m0, dtype=np.int64)
    row_pos[ro] = (a.rb[ro] - lo) * mb + a.lr[ro]
    if lo == 0:
        row_pos[a.rows0] = lanes * mb + np.arange(m0)

    def put(v, dt=torch.int64):
        return torch.from_numpy(np.ascontiguousarray(v)).to(device=device, dtype=dt)

    return ScenarioTensors(
        W=W, T=T, A0=A0, rows0=put(a.rows0), cols0=put(a.cols0), rows_idx=put(rows_idx),
        cols_idx=put(cols_idx), pad_row=put(rows_idx == m, dtype), row_pos=put(row_pos),
    )


def build_tensors(inf: InteriorForm, dtype, device) -> Tuple[ScenarioTensors, ScenarioLayout]:
    """The layout from the ``two_stage`` hint and every lane's stacks on
    ``device`` as one member (:func:`analyze_arrow`'s errors)."""
    arrow = analyze_arrow(inf)
    return place_lanes(arrow, 0, arrow.lay.k_pad, dtype, device), arrow.lay


def lane_split(mesh, k_pad: int):
    """``(axis, R)``: the mesh axis the lanes split over and its width,
    or ``(None, 1)`` where the reference keeps every lane on every member
    (no mesh, or a chunk the mesh does not divide)."""
    if mesh is None or min(k_pad, SCENARIO_CHUNK) % mesh.size:
        return None, 1
    axis = "batch" if "batch" in mesh.axis_names else mesh.axis_names[-1]
    return axis, int(mesh.shape[axis])


class _StageClock:
    """Accumulates stage times into the report: CUDA events on a card,
    resolved by :meth:`flush` once the host has synchronized anyway (no
    sync of its own), the host clock on the CPU (the reference's)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._pending = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def add(self, key: str, t0, t1) -> None:
        if self.cuda:
            self._pending.append((key, t0, t1))
        else:
            _REPORT.add(key, (t1 - t0) * 1e3)

    def flush(self) -> None:
        if not self._pending:
            return
        self._pending[-1][2].synchronize()  # the stream's last: every earlier one is done
        for key, t0, t1 in self._pending:
            _REPORT.add(key, t0.elapsed_time(t1))
        self._pending = []


@register_backend("scenario")
class ScenarioBackend(SolverBackend):
    """Scenario-decomposed IPM over a lowered two-stage LP, on one CUDA
    card (or the CPU when asked for with ``device="cpu"``), or with
    ``mesh`` over its members (the module note; the device defaults to the
    mesh's).

    ``setup`` reads the ``two_stage`` hint, pads K up its bucket and
    scatters the (W, T, A0) stacks of the lanes this process holds on
    their devices; the driver's host loop then runs the Mehrotra core with
    ``factorize``/``solve`` as above."""

    def __init__(self, device=None, mesh=None):
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"mesh device {mesh.device} != backend device {device}")
            device = mesh.device
        self.device = resolve_device(device)
        self._mesh = mesh
        self._reg = 0.0
        self._cfg: Optional[SolverConfig] = None

    # -- setup -----------------------------------------------------------

    def setup(self, inf: InteriorForm, config: SolverConfig) -> None:
        dtype = _torch_dtype(config.dtype)
        t0 = time.perf_counter()
        arrow = analyze_arrow(inf)
        lay = self._lay = arrow.lay
        mesh = self._mesh
        self._axis, R = lane_split(mesh, lay.k_pad)
        w = lay.k_pad // R
        # (device, lo, hi) of each member this process executes.
        members = ([(self.device, 0, lay.k_pad)] if self._axis is None else
                   [(dev, i * w, (i + 1) * w) for i, dev in mesh.axis_members(self._axis)])
        self._parts = [place_lanes(arrow, lo, hi, dtype, dev) for dev, lo, hi in members]
        self.lane_ranges = [(lo, hi) for _, lo, hi in members]
        del arrow
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self._op = sparse_ops.from_scipy(inf.A, dtype=dtype, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_report = {"stacks_s": t1 - t0, "operator_s": time.perf_counter() - t1}
        self._cfg = config
        self._dtype = dtype
        self._reg = config.reg_dual
        self._params = config.step_params()
        # CG iteration cap of the preconditioned normal-equations solve.
        self._cg_iters = config.cg_iters
        self._cg_hint = None  # the last Newton solve's CG count: the next one's first chunk
        self._clock = _StageClock(self.device)
        self._shape = dict(
            n_scenarios=lay.K, scenario_bucket=lay.k_pad, chunks=1, block_m=lay.mb,
            block_n=lay.nb, first_stage_m=lay.m0, first_stage_n=lay.n0,
        )
        self._data = core.make_problem_data(
            np.asarray(inf.c, dtype=np.float64), np.asarray(inf.b, dtype=np.float64),
            np.asarray(inf.u, dtype=np.float64), dtype, self.device,
        )
        # Exact primal-row closure (LinOps.primal_project): A·Aᵀ is the same
        # arrow at d ≡ 1, so the closure reuses the decomposition, factored
        # once here at the unit diagonal.
        self._aat_factors = self._factorize(
            torch.ones(lay.n, dtype=dtype, device=self.device), config.reg_dual
        )
        self._reset_report()

    def _reset_report(self) -> None:
        self._clock.flush()
        _REPORT.reset(schur_ms=0.0, link_ms=0.0, solve_ms=0.0, factorizations=0,
                      solves=0, cg_iters=0, cg_masked=0, host_syncs=0, **self._shape)
        self._cg_per_iter = []
        self._newton_solves = 0
        self._acc = []  # CG counts of the current step's Newton solves

    @property
    def mesh(self):
        """The mesh the lanes are split over, or None."""
        return self._mesh

    @property
    def layout(self) -> ScenarioLayout:
        return self._lay

    def _sum(self, parts):
        """The members' partials summed: one ``Mesh.sum_parts`` when the
        lanes are split, the one part itself otherwise."""
        if self._axis is None:
            return parts[0]
        return self._mesh.sum_parts(parts, self._axis)

    def _primal_project(self, rv):
        """``rv ↦ Aᵀ(A·Aᵀ)⁻¹·rv`` through the unit-diagonal factors — corrects
        each KKT solve's final dx so A·dx hits its target exactly."""
        return self._op.rmatvec(self._solve(self._aat_factors, rv))

    def operand_nbytes(self) -> int:
        """Dense operand footprint of the decomposition (the W/T stacks, the
        per-lane factors and the first-stage factors); M never exists."""
        lay = self._lay
        per_lane = lay.mb * lay.nb + lay.mb * lay.n0 + lay.mb * lay.mb  # W, T, L
        elt = torch.finfo(self._dtype).bits // 8
        return elt * (lay.k_pad * per_lane + lay.n0 * lay.n0 + lay.n0 * lay.m0
                      + lay.m0 * lay.m0)

    def member_nbytes(self) -> int:
        """Bytes of the member tensors this process holds: its lanes'
        stacks and maps, and the replicated first stage."""
        return sum(v.numel() * v.element_size() for t in self._parts for v in t)

    # -- the LinOps seam --------------------------------------------------

    def _schur_factor(self, t, dK, reg):
        """The per-scenario Schur batch of member ``t``'s lanes (the
        reference's ``_schur_factor_jit``): ``(L, C_t)``, the factors of
        ``S_k = W_k·D_k·W_kᵀ`` and the member's closure ``Σ_k Y_kᵀ·Y_k``."""
        S = normal_eq(t.W, dK)  # the member's lanes in one launch
        # Padded rows of W are zero, so are their rows and columns of S: a
        # unit diagonal decouples them (the reference's mask, exactly).
        diag = S.diagonal(dim1=-2, dim2=-1)
        diag.add_(reg * diag + t.pad_row)
        L = _cholesky(S)
        Y = torch.linalg.solve_triangular(L, t.T, upper=False)
        Y2 = Y.reshape(-1, Y.shape[-1])
        return L, Y2.mT @ Y2  # the lane sum inside one GEMM

    def _link_factor(self, C, d0, reg):
        """The first-stage linking factor (the reference's
        ``_link_factor_jit``): ``(LH, G, LF)`` for ``H = C + D0⁻¹``,
        ``G = H⁻¹·A0ᵀ`` and ``F = A0·G``."""
        A0 = self._parts[0].A0
        H = C + torch.diag(1.0 / d0)
        hd = H.diagonal()
        hd.add_(reg * hd)
        LH = _cholesky(H)
        G = _cho_solve(LH, A0.mT)
        F = A0 @ G
        fd = F.diagonal()
        fd.add_(reg * fd)
        return LH, G, _cholesky(F)

    def _factorize(self, d, reg):
        clock = self._clock
        t0 = clock.mark()
        Ls, Cs = [], []
        for t in self._parts:
            # Padded columns gather 0 from the appended slot.
            L, C = self._schur_factor(t, _pad(d.to(t.W.device))[t.cols_idx], reg)
            Ls.append(L)
            Cs.append(C)
        C = self._sum(Cs)  # one n0×n0 all-reduce over the members
        t1 = clock.mark()
        LH, G, LF = self._link_factor(C, d[self._parts[0].cols0], reg)
        t2 = clock.mark()
        clock.add("schur_ms", t0, t1)
        clock.add("link_ms", t1, t2)
        _REPORT.add("factorizations", 1)
        return (Ls, LH, G, LF, d)

    def _apply_decomp(self, factors, r):
        """One application of the decomposition: ``M⁻¹·r`` of the
        regularized two-level elimination, two sums over the members (t,
        then the members' rows of dy)."""
        Ls, LH, G, LF = factors[:4]
        t0 = self._parts[0]
        rKs, tvs = [], []
        for t, L in zip(self._parts, Ls):
            rK = _pad(r.to(t.W.device))[t.rows_idx]  # (lanes, mb); padded slots read 0
            u = _cho_solve(L, rK[..., None])
            tvs.append(t.T.view(-1, t.T.shape[-1]).mT @ u.view(-1))  # Σ_k T_kᵀ·S_k⁻¹·r_k
            rKs.append(rK)
        tv = self._sum(tvs)
        ht = _cho_solve(LH, tv[:, None])[:, 0]
        dy0 = _cho_solve(LF, (r[t0.rows0] - t0.A0 @ ht)[:, None])[:, 0]
        w0 = G @ dy0 + ht
        outs = []
        for t, L, rK in zip(self._parts, Ls, rKs):
            dev = t.W.device
            dyK = _cho_solve(L, (rK - t.T @ w0.to(dev))[..., None])
            outs.append(torch.cat([dyK.view(-1), dy0.to(dev), dyK.new_zeros(1)])[t.row_pos])
        return self._sum(outs)

    def _solve(self, factors, rhs):
        """M⁻¹·rhs: CG on the matrix-free operator ``v ↦ A·(d∘Aᵀv)``
        preconditioned by the factored decomposition, with the reference's
        rules (module note). The loop runs in masked chunks: an iteration
        past the exit changes nothing, so x and the count are the
        reference loop's."""
        op, d = self._op, factors[4]
        t_start = self._clock.mark()
        apply = lambda v: self._apply_decomp(factors, v)  # noqa: E731

        def mv(v):
            return op.matvec(d * op.rmatvec(v))

        norm0 = torch.linalg.vector_norm(rhs)
        thresh = 1e-12 * norm0
        x = apply(rhs)
        res = rhs - mv(x)
        best_x, best_rn = x, torch.linalg.vector_norm(res)
        z = apply(res)
        p = z
        rz = res @ z
        it = torch.zeros((), dtype=torch.int64, device=rhs.device)
        alive = torch.ones((), dtype=torch.bool, device=rhs.device)
        cap = self._cg_iters

        def cond():  # the reference loop's test at the top of an iteration
            return alive & (it < cap) & torch.isfinite(rz) & ~(best_rn <= thresh)

        syncs = ran = 0
        for chunk in pcg_ops._chunks(rhs.device, self._cg_hint):
            flag, n_it = torch.stack([cond().to(torch.int64), it]).tolist()
            syncs += 1
            if not flag:
                break
            ran += chunk
            for _ in range(chunk):
                go = cond()
                Ap = mv(p)
                denom = p @ Ap
                ok = go & (denom > 0) & torch.isfinite(denom)
                alpha = rz / torch.where(ok, denom, 1.0)
                x1 = x + alpha * p
                res1 = res - alpha * Ap
                rn = torch.linalg.vector_norm(res1)
                better = ok & torch.isfinite(rn) & (rn < best_rn)
                z1 = apply(res1)
                rz2 = res1 @ z1
                p1 = z1 + (rz2 / torch.where(ok, rz, 1.0)) * p
                x, res, p, rz = (torch.where(ok, a, b) for a, b in
                                 ((x1, x), (res1, res), (p1, p), (rz2, rz)))
                best_x = torch.where(better, x1, best_x)
                best_rn = torch.where(better, rn, best_rn)
                it = it + ok.to(it.dtype)
                alive = ok
        self._cg_hint = max(n_it, 1)
        self._newton_solves += 1
        self._acc.append(n_it)
        # Applications: the first iterate's, the first residual's and one
        # an iteration; masked iterations past the exit are counted apart.
        _REPORT.add("solves", 2 + n_it)
        _REPORT.add("cg_iters", float(n_it))
        _REPORT.add("cg_masked", ran - n_it)
        _REPORT.add("host_syncs", syncs)
        # A zero right-hand side returns zeros whatever the factors hold.
        out = torch.where(norm0 == 0, torch.zeros_like(best_x), best_x)
        self._clock.add("solve_ms", t_start, self._clock.mark())
        return out

    def _ops(self) -> core.LinOps:
        reg = self._reg
        return core.LinOps(
            matvec=self._op.matvec, rmatvec=self._op.rmatvec,
            factorize=lambda d: self._factorize(d, reg), solve=self._solve,
            primal_project=self._primal_project,
        )

    # -- SolverBackend surface -------------------------------------------

    def starting_point(self) -> IPMState:
        self._reset_report()
        st = core.starting_point(self._ops(), self._data, self._params)
        self._cg_per_iter.append(sum(self._acc))
        return st

    def iterate(self, state: IPMState) -> Tuple[IPMState, StepStats]:
        self._acc = []
        new_state, stats = core.mehrotra_step(self._ops(), self._data, self._params, state)
        # One device→host copy of every scalar of the step.
        host = torch.stack([v.to(self._dtype) for v in stats]).cpu().tolist()
        self._clock.flush()
        self._cg_per_iter.append(sum(self._acc))
        return new_state, StepStats(*host[:-1], bad=bool(host[-1]))

    def bump_regularization(self) -> bool:
        if self._reg * self._cfg.reg_grow > 1e-2:
            return False
        self._reg = max(self._reg, 1e-12) * self._cfg.reg_grow
        return True

    def cg_report(self) -> dict:
        """CG telemetry of this backend's solve: the total and the count of
        each IPM iteration (the starting point's first), the Newton solves
        and the host reads of CG's exit flag."""
        rep = _REPORT.snapshot()
        return {
            "cg_iters": int(sum(self._cg_per_iter)),
            "cg_per_iteration": list(self._cg_per_iter),
            "newton_solves": self._newton_solves,
            "host_syncs": int(rep.get("host_syncs", 0)),
            "cg_cap": self._cg_iters,
        }

    def to_host(self, state: IPMState) -> IPMState:
        return IPMState(*(v.detach().cpu().numpy() for v in state))

    def from_host(self, state: IPMState) -> IPMState:
        return IPMState(
            *(torch.tensor(np.asarray(v, dtype=np.float64), dtype=self._dtype,
                           device=self.device) for v in state)
        )

    def block_until_ready(self, obj) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def solve_scenario(
    slp: ScenarioLP,
    config: Optional[SolverConfig] = None,
    warm_cache=None,
    device=None,
    **overrides,
):
    """Solve a :class:`~distributedlpsolver_tpu_torch.models.scenario.
    ScenarioLP` through the scenario-decomposed engine on ``device`` (the
    card unless the caller names the CPU): lower to the hinted
    block-angular form and run the standard driver (presolve is skipped
    by the hint; ``warm_cache`` enables delta-wave amortization — same
    base, same structural fingerprint)."""
    from distributedlpsolver_tpu_torch.ipm.driver import solve

    return solve(
        slp.to_block_angular(), backend=ScenarioBackend(device=device), config=config,
        warm_cache=warm_cache, **overrides,
    )
