"""First-order (restarted PDHG / "PDLP"-style) backend and the serve
ladder's bucketed PDHG engine.

The port of the JAX package's ``backends/first_order.py``. Algorithm:
primal-dual hybrid gradient on the interior form ``min cᵀx s.t. Ax = b,
0 ≤ x ≤ u`` —

    x⁺ = clip(x − τ·(c − Aᵀy), 0, u)
    y⁺ = y + σ·(b − A·(2x⁺ − x))

with step sizes ``τ = η/ω, σ = η·ω`` (``η = 0.9/‖A‖₂`` from a power
iteration, ω the primal weight), Polyak–Ruppert averaging inside each
restart cycle, adaptive restarts on the normalized KKT error, and
primal-weight updates at restarts. Each iteration is two matrix-vector
products plus vector arithmetic: dense A takes ``torch`` GEMVs, sparse A a
``torch`` sparse CSR product (the JAX package's products are XLA
``jnp``/BCOO, outside any Pallas kernel, so they stay library calls here).

Where the JAX package runs the loop as one ``lax.while_loop``, the loop
here is a masked body — ``check_every`` = 40 inner steps plus the
restart, averaging and primal-weight bookkeeping — run by
``ipm/device_loop.py``: eagerly on the CPU, as one captured CUDA graph
replayed by the host on a card. The loop bounds (``max_iter``, ``tol``)
are device scalars of the loop's inputs, so a new bound is a fill, not a
new capture.

The power iteration's start vector is the JAX package's
``jax.random.normal(PRNGKey(seed), (n,), dtype)``, computed in NumPy by
``utils/threefry.py``, so the step sizes — and the trajectories — follow
the reference's. Seeds: an explicit seed, else ``crc32(name)`` for the
solo backend. In the bucket engine a lane's seed is an index into a
static table of B start vectors (row k seeded with k): the serve layer
passes ``crc32(request name) mod B`` (:func:`pdhg_seed`), so a request's
step size — and its verdict — does not depend on the slot it lands in;
a caller that passes no seeds gets each slot's own index.

Working precision: off TPU the reference keeps ``config.dtype`` (f64);
``factor_dtype="float32"`` gives f32. ``mesh=`` is not ported (ROADMAP
Queue 1 item 13c).
"""

from __future__ import annotations

import threading
import time
import warnings
import zlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from distributedlpsolver_tpu_torch.backends import dense
from distributedlpsolver_tpu_torch.backends.base import SolverBackend, register_backend
from distributedlpsolver_tpu_torch.backends.dense import resolve_device
from distributedlpsolver_tpu_torch.ipm import core, device_loop
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.ipm.state import IPMState, Status, StepStats
from distributedlpsolver_tpu_torch.models.problem import InteriorForm
from distributedlpsolver_tpu_torch.utils import threefry

CHECK_EVERY = 40  # inner PDHG steps per loop body
RESTART_LEN = 2000
RESTART_BETA = 0.5
BURST = 400  # inner steps per driver iteration / per unit of max_iter


def pdhg_seed(name: str, batch: int) -> int:
    """A bucket lane's start-vector index for the request ``name``: the
    solo backend's ``crc32(name)`` seed, modulo the bucket's ``batch``."""
    return (zlib.crc32(name.encode()) & 0x7FFFFFFF) % batch


def _mesh_unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the torch package yet (ROADMAP Queue 1 item 13c)")


class PDHGState(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    x_sum: torch.Tensor  # running averages within the restart cycle
    y_sum: torch.Tensor
    n_avg: torch.Tensor
    x_restart: torch.Tensor  # cycle start (for primal-weight updates)
    y_restart: torch.Tensor
    err_restart: torch.Tensor  # KKT error at the last restart point
    omega: torch.Tensor  # primal weight
    it_cycle: torch.Tensor


def _estimate_norm(matvec, rmatvec, n, dtype, device, iters: int = 30, seed: int = 0):
    """Power iteration for ‖A‖₂ (σ_max) — sets the PDHG step size — from
    the JAX package's start vector for ``seed``."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    v = torch.from_numpy(threefry.normal(seed, n, np_dtype)).to(device)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = rmatvec(matvec(v))
        v = w / torch.linalg.vector_norm(w).clamp_min(1e-30)
    return torch.sqrt(torch.linalg.vector_norm(rmatvec(matvec(v))))


def _kkt_error(matvec, rmatvec, data, x, y):
    """(pinf, dinf, gap_rel, pobj, dobj) of an (x, y) pair.

    Reduced costs split by bound structure: r = c − Aᵀy; on finite-u
    columns a negative r is priced by the upper bound (contributes r·u to
    the dual objective); on unbounded columns a negative r is dual
    infeasibility."""
    c, b, u_f, hub = data.c, data.b, data.u_f, data.hub
    r_p = b - matvec(x)
    r = c - rmatvec(y)
    r_neg = r.clamp_max(0.0)
    dinf_vec = torch.where(hub > 0, 0.0, r_neg)  # unbounded cols: r must be ≥ 0
    pinf = torch.linalg.vector_norm(r_p) / data.norm_b
    dinf = torch.linalg.vector_norm(dinf_vec) / data.norm_c
    pobj = c @ x
    dobj = b @ y + (hub * u_f) @ r_neg
    gap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj) + torch.abs(dobj))
    return pinf, dinf, gap, pobj, dobj


def _err_of(matvec, rmatvec, data, x, y):
    pinf, dinf, gap, _, _ = _kkt_error(matvec, rmatvec, data, x, y)
    return torch.maximum(pinf, torch.maximum(dinf, gap))


def _pdhg_loop(matvec, rmatvec, data, eta, dtype, device):
    """The restarted-PDHG loop of one problem as a :class:`DeviceLoop`
    over the carry ``(PDHGState, it, err)`` with inputs ``max_iter`` and
    ``tol``: one body is ``CHECK_EVERY`` inner steps plus the restart
    bookkeeping, every update masked by the loop's condition so a body
    past the exit leaves the carry bit for bit."""
    u = torch.where(data.hub > 0, data.u_f, torch.inf)

    def one_pdhg(x, y, omega):
        tau = eta / omega
        sigma = eta * omega
        x_new = torch.minimum((x - tau * (data.c - rmatvec(y))).clamp_min(0.0), u)
        y_new = y + sigma * (data.b - matvec(2.0 * x_new - x))
        return x_new, y_new

    def cond(carry, s):
        _, it, err = carry
        return (it < s["max_iter"]) & (err > s["tol"])

    def body(carry, s):
        st, it, err = carry
        go = cond(carry, s)
        x, y = st.x, st.y
        for _ in range(CHECK_EVERY):
            x, y = one_pdhg(x, y, st.omega)
        x_sum = st.x_sum + x * CHECK_EVERY  # cheap running average proxy
        y_sum = st.y_sum + y * CHECK_EVERY
        n_avg = st.n_avg + CHECK_EVERY
        x_avg = x_sum / n_avg
        y_avg = y_sum / n_avg

        err_cur = _err_of(matvec, rmatvec, data, x, y)
        err_avg = _err_of(matvec, rmatvec, data, x_avg, y_avg)
        it_cycle = st.it_cycle + CHECK_EVERY

        # Restart candidate: whichever of (current, average) is better.
        use_avg = err_avg < err_cur
        x_cand = torch.where(use_avg, x_avg, x)
        y_cand = torch.where(use_avg, y_avg, y)
        err_cand = torch.minimum(err_avg, err_cur)
        do_restart = (err_cand <= RESTART_BETA * st.err_restart) | (it_cycle >= RESTART_LEN)

        # Primal-weight update at restarts (PDLP rule: ratio of movements).
        dx = torch.linalg.vector_norm(x_cand - st.x_restart)
        dy = torch.linalg.vector_norm(y_cand - st.y_restart)
        omega_new = torch.where(
            (dx > 1e-30) & (dy > 1e-30),
            torch.exp(0.5 * torch.log(st.omega) + 0.5 * torch.log(dy / dx)),
            st.omega,
        )
        zero = torch.zeros_like(n_avg)
        restart = PDHGState(
            x=x_cand, y=y_cand, x_sum=torch.zeros_like(x), y_sum=torch.zeros_like(y),
            n_avg=zero, x_restart=x_cand, y_restart=y_cand, err_restart=err_cand,
            omega=omega_new, it_cycle=torch.zeros_like(it_cycle),
        )
        cont = st._replace(x=x, y=y, x_sum=x_sum, y_sum=y_sum, n_avg=n_avg, it_cycle=it_cycle)
        new = PDHGState(*(torch.where(do_restart, a, b) for a, b in zip(restart, cont)))
        new = PDHGState(*(torch.where(go, a, b) for a, b in zip(new, st)))
        best_err = torch.minimum(err_cand, err_cur)
        return (new, torch.where(go, it + CHECK_EVERY, it), torch.where(go, best_err, err))

    def meta(carry):
        _, it, err = carry
        return torch.stack([it.to(err.dtype), err])

    inputs = {
        "max_iter": torch.zeros((), dtype=torch.int32, device=device),
        "tol": torch.zeros((), dtype=dtype, device=device),
    }
    return device_loop.DeviceLoop(body, cond, meta, inputs)


def _pdhg_solve(loop, matvec, rmatvec, data, x0, y0, omega0, err_restart0, max_iter, tol):
    """One bounded run of the restarted-PDHG loop from ``(x0, y0)``.

    ``omega0``/``err_restart0`` make the loop resumable: a caller driving
    bounded bursts feeds back the returned ``(omega, err_restart)`` so the
    adaptive primal weight and restart baseline survive burst boundaries
    (a fresh start passes ``omega0=1, err_restart0=inf``). Returns
    ``(x, y, it, err, omega, err_restart)``: the better of (last, cycle
    average), the inner iterations run and the device scalars."""
    dtype = x0.dtype
    err0 = _err_of(matvec, rmatvec, data, x0, y0)
    st0 = PDHGState(
        x=x0, y=y0, x_sum=torch.zeros_like(x0), y_sum=torch.zeros_like(y0),
        n_avg=torch.zeros((), dtype=dtype, device=x0.device), x_restart=x0, y_restart=y0,
        err_restart=torch.minimum(torch.as_tensor(err_restart0, dtype=dtype, device=x0.device),
                                  err0),
        omega=torch.as_tensor(omega0, dtype=dtype, device=x0.device).clone(),
        it_cycle=torch.zeros((), dtype=torch.int32, device=x0.device),
    )
    carry = (st0, torch.zeros((), dtype=torch.int32, device=x0.device), st0.err_restart.clone())
    (st, it, _), _ = loop.run(carry, max_iter=int(max_iter), tol=float(tol))
    # Report the better of (last, average-of-cycle).
    has_avg = st.n_avg > 0
    x_avg = torch.where(has_avg, st.x_sum / st.n_avg.clamp_min(1.0), st.x)
    y_avg = torch.where(has_avg, st.y_sum / st.n_avg.clamp_min(1.0), st.y)
    err_avg = _err_of(matvec, rmatvec, data, x_avg, y_avg)
    err_cur = _err_of(matvec, rmatvec, data, st.x, st.y)
    use_avg = err_avg < err_cur
    x_fin = torch.where(use_avg, x_avg, st.x)
    y_fin = torch.where(use_avg, y_avg, st.y)
    return x_fin, y_fin, it, torch.minimum(err_avg, err_cur), st.omega, st.err_restart


@register_backend("pdlp", "first-order", "pdhg")
class FirstOrderBackend(SolverBackend):
    """Restarted-PDHG execution backend (matrix-free) on the first CUDA
    card, or the CPU with ``device="cpu"``.

    Plugs into the same driver surface as every other backend: the
    IPM-shaped ``iterate`` contract runs one 400-step burst per call and
    reports KKT stats; ``solve_full`` is the fused loop, whose
    ``max_iter`` counts bursts of 400 inner steps."""

    def __init__(self, mesh=None, seed: Optional[int] = None, device=None):
        if mesh is not None:
            raise _mesh_unported("mesh-sharded pdlp (mesh=)")
        self.device = resolve_device(device)
        self._sparse = False
        # Norm-estimate seed: explicit wins; else derived from the
        # problem name at setup (deterministic per request).
        self._seed = seed

    def setup(self, inf: InteriorForm, config: SolverConfig) -> None:
        if config.mesh_shape is not None and not sp.issparse(inf.A):
            raise _mesh_unported("mesh-sharded pdlp (config.mesh_shape)")
        self._cfg = config
        # Working precision: the reference's off-TPU rule — config.dtype,
        # or f32 under an explicit factor_dtype="float32".
        dtype = torch.float32 if config.factor_dtype == "float32" else dense._torch_dtype(
            config.dtype)
        self._dtype = dtype
        dev = self.device
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        A = inf.A
        self._sparse = sp.issparse(A)
        if self._sparse:
            def csr(M):
                M = sp.csr_matrix(M)
                with warnings.catch_warnings():  # torch's "beta state" notice
                    warnings.filterwarnings("ignore", message="Sparse CSR tensor support")
                    return torch.sparse_csr_tensor(
                        torch.from_numpy(M.indptr.astype(np.int64)),
                        torch.from_numpy(M.indices.astype(np.int64)),
                        torch.from_numpy(M.data.astype(np.float64)).to(dtype),
                        size=M.shape, device=dev, check_invariants=True)

            self._A, self._AT = csr(A), csr(sp.csr_matrix(A).T)
            self._nnz = int(sp.csr_matrix(A).nnz)
            A_, AT_ = self._A, self._AT
            self._matvec = lambda v: A_ @ v
            self._rmatvec = lambda v: AT_ @ v
        else:
            self._A = torch.as_tensor(np.asarray(A, dtype=np.float64), device=dev).to(
                dtype).contiguous()
            A_ = self._A
            self._matvec = lambda v: A_ @ v
            self._rmatvec = lambda v: A_.T @ v
        # c, b and u cast to the working dtype on the host, as there.
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        host = lambda v: np.asarray(v, dtype=np.float64).astype(np_dtype)
        self._data = core.make_problem_data(host(inf.c), host(inf.b), host(inf.u), dtype, dev)
        seed = int(self._seed) if self._seed is not None else (
            zlib.crc32(inf.name.encode()) & 0x7FFFFFFF)
        nrm = _estimate_norm(self._matvec, self._rmatvec, inf.n, dtype, dev, seed=seed)
        self._eta = float(0.9 / max(float(nrm), 1e-12))
        self._reset_adaptive()

    def _reset_adaptive(self) -> None:
        # Adaptive PDHG state persisted ACROSS bursts (iterate calls and
        # solve_full segments): the learned primal weight and the restart
        # baseline.
        self._omega = 1.0
        self._err_restart = float("inf")

    def _run(self, x, y, omega, err_restart, max_iter, report=None):
        """One bounded loop run on a fresh :class:`DeviceLoop` (closed
        after), its accounting merged into ``report``."""
        eta = torch.tensor(self._eta, dtype=self._dtype, device=self.device)
        loop = _pdhg_loop(self._matvec, self._rmatvec, self._data, eta, self._dtype,
                          self.device)
        try:
            out = _pdhg_solve(loop, self._matvec, self._rmatvec, self._data, x, y, omega,
                              err_restart, max_iter, self._cfg.tol)
        finally:
            loop.close()
        if report is not None:
            for k, v in loop.report().items():
                if isinstance(v, (int, float)):
                    report[k] = report.get(k, 0) + v
        return out

    def starting_point(self) -> IPMState:
        n = self._data.c.shape[0]
        m = self._data.b.shape[0]
        zeros = lambda k: torch.zeros(k, dtype=self._dtype, device=self.device)
        return self._wrap(zeros(n), zeros(m))

    def _wrap(self, x, y) -> IPMState:
        # Carry (x, y) through the IPMState container; s/w/z are derived
        # quantities for PDHG and reported as reduced costs at the end.
        r = self._data.c - self._rmatvec(y)
        hub = self._data.hub > 0
        s = r.clamp_min(0.0)
        z = (-r).clamp_min(0.0) * hub
        w = torch.where(hub, self._data.u_f - x, 1.0)
        return IPMState(x=x, y=y, s=s, w=w, z=z)

    def _stats_row(self, x, y):
        pinf, dinf, gap, pobj, dobj = _kkt_error(self._matvec, self._rmatvec, self._data, x, y)
        zero = torch.zeros((), dtype=self._dtype, device=self.device)
        return torch.stack([gap, torch.abs(pobj - dobj), gap, pinf, dinf, pobj, dobj,
                            zero, zero, zero])

    def iterate(self, state: IPMState) -> Tuple[IPMState, StepStats]:
        # One driver "iteration" = a bounded PDHG burst; stats are true KKT
        # measures so the host convergence test stays meaningful.
        x, y, _, _, omega, err_restart = self._run(
            state.x, state.y, self._omega, self._err_restart, BURST)
        self._omega = float(omega)
        self._err_restart = float(err_restart)
        row = self._stats_row(x, y).to(torch.float64).cpu().tolist()
        gap = row[0]
        stats = StepStats(mu=gap, gap=row[1], rel_gap=gap, pinf=row[3], dinf=row[4],
                          pobj=row[5], dobj=row[6], alpha_p=0.0, alpha_d=0.0, sigma=0.0,
                          bad=not np.isfinite(gap))
        return self._wrap(x, y), stats

    def bump_regularization(self) -> bool:
        return False  # nothing to regularize

    def solve_full(self, state: IPMState):
        """The fused loop from ``state``: ``max_iter`` counts bursts of 400
        inner steps. Host-segmented into bursts (carrying x, y, ω and the
        restart baseline) when ``segment_iters > 0``, else one run.
        ``self.phase_report`` gets one row with the loop's accounting."""
        cfg = self._cfg
        max_inner = int(cfg.max_iter) * BURST
        x, y = state.x, state.y
        omega, err_restart = self._omega, self._err_restart
        acc: dict = {}
        t0 = time.perf_counter()
        if core.use_segments(cfg.segment_iters, self.device.type):
            burst = max(BURST, int(cfg.segment_iters) * BURST)
            it_total, first = 0, True
            while it_total < max_inner:
                this = min(burst, max_inner - it_total)
                t1 = time.perf_counter()
                x, y, it_b, err_b, omega, err_restart = self._run(
                    x, y, omega, err_restart, this, acc)
                dt = time.perf_counter() - t1
                it_b, err = int(it_b), float(err_b)
                it_total += it_b
                if err <= float(cfg.tol) or it_b == 0:
                    break
                if not first:  # the first burst's wall time includes setup
                    burst = max(BURST, min(200000, int(burst * 15.0 / max(dt, 1e-3))))
                first = False
            it = it_total
        else:
            x, y, it, _, omega, err_restart = self._run(x, y, omega, err_restart, max_inner, acc)
            it = int(it)
        self._omega = float(omega)
        self._err_restart = float(err_restart)
        row = self._stats_row(x, y)
        host = row.to(torch.float64).cpu().numpy()
        gap, pinf, dinf = host[0], host[3], host[4]
        ok = (gap <= cfg.tol) & (pinf <= cfg.tol) & (dinf <= cfg.tol)
        status = np.asarray(core.STATUS_OPTIMAL if ok else core.STATUS_MAXITER)
        self.phase_report = [{
            "phase": 0, "engine": "pdhg", "iters": it,
            "wall_s": round(time.perf_counter() - t0, 3), "mode": dense._mode(self._dtype), **acc,
        }]
        # One summary stats record, but the REAL inner-iteration count —
        # floored at 1, so an immediately-optimal start still surfaces its
        # stats row.
        return self._wrap(x, y), torch.tensor(max(it, 1)), status, host[None, :]

    def to_host(self, state: IPMState) -> IPMState:
        return IPMState(*(v.detach().to(torch.float64).cpu().numpy() for v in state))

    def from_host(self, state: IPMState) -> IPMState:
        # A restored iterate invalidates the burst-adaptive baselines.
        self._reset_adaptive()
        return IPMState(*(torch.tensor(np.asarray(v, dtype=np.float64), device=self.device).to(
            self._dtype) for v in state))

    def block_until_ready(self, obj) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


# -- bucketed batched PDHG: the serve ladder's first-order engine -----------
#
# One program per (B, m, n, dtype, device) bucket key — tol and max_iter
# are loop inputs, so the tolerance tiers share the program and a warm
# bucket never captures again (the invariant of batched._BucketProgram).
# Each lane runs the restarted-PDHG loop of this module, vectorized over
# the batch with per-lane convergence masks; per-lane step sizes come
# from a power iteration run at every dispatch (A changes), each lane
# started from the table row its seed index names.
# Verdicts are crossover-honest: a lane is OPTIMAL only when its true KKT
# error (pinf, dinf, relative gap) passes the REQUEST tolerance.


class _PDHGLanes(NamedTuple):
    x: torch.Tensor  # (B, n)
    y: torch.Tensor  # (B, m)
    x_sum: torch.Tensor
    y_sum: torch.Tensor
    n_avg: torch.Tensor  # (B,)
    x_restart: torch.Tensor
    y_restart: torch.Tensor
    err_restart: torch.Tensor  # (B,)
    omega: torch.Tensor  # (B,)
    it_cycle: torch.Tensor  # (B,) int32


def _bmv(A, x):
    """Per-lane ``A_k @ x_k``: (B, m, n), (B, n) → (B, m)."""
    return torch.bmm(A, x.unsqueeze(-1)).squeeze(-1)


def _bmtv(A, y):
    """Per-lane ``A_kᵀ @ y_k``: (B, m, n), (B, m) → (B, n)."""
    return torch.bmm(y.unsqueeze(1), A).squeeze(1)


def _lanes_kkt(A, b, c, x, y):
    """Per-lane (pinf, dinf, gap, pobj, dobj) for bucket standard form
    (x ≥ 0, no upper bounds)."""
    r_p = b - _bmv(A, x)
    r = c - _bmtv(A, y)
    pinf = torch.linalg.vector_norm(r_p, dim=1) / (1.0 + torch.linalg.vector_norm(b, dim=1))
    dinf = torch.linalg.vector_norm(r.clamp_max(0.0), dim=1) / (
        1.0 + torch.linalg.vector_norm(c, dim=1))
    pobj = torch.sum(c * x, dim=1)
    dobj = torch.sum(b * y, dim=1)
    gap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj) + torch.abs(dobj))
    return pinf, dinf, gap, pobj, dobj


def _lanes_err(A, b, c, x, y):
    pinf, dinf, gap, _, _ = _lanes_kkt(A, b, c, x, y)
    return torch.maximum(pinf, torch.maximum(dinf, gap))


def _lanes_body(carry, s, A, b, c, eta):
    """One trip of the batched loop: ``CHECK_EVERY`` fused primal-dual
    steps for ALL lanes (finished lanes' updates masked out), then each
    lane's KKT error and its restart/averaging bookkeeping. A trip with
    no live lane leaves the carry bit for bit."""
    st, it, err, live = carry
    B = live.shape[0]
    lcol = live[:, None]
    tau = (eta / st.omega)[:, None]
    sigma = (eta * st.omega)[:, None]
    x, y = st.x, st.y
    for _ in range(CHECK_EVERY):
        xn = (x - tau * (c - _bmtv(A, y))).clamp_min(0.0)
        yn = y + sigma * (b - _bmv(A, 2.0 * xn - x))
        x = torch.where(lcol, xn, x)
        y = torch.where(lcol, yn, y)
    x_sum = st.x_sum + x * CHECK_EVERY
    y_sum = st.y_sum + y * CHECK_EVERY
    n_avg = st.n_avg + CHECK_EVERY
    x_avg = x_sum / n_avg[:, None]
    y_avg = y_sum / n_avg[:, None]

    err_cur = _lanes_err(A, b, c, x, y)
    err_avg = _lanes_err(A, b, c, x_avg, y_avg)
    it_cycle = st.it_cycle + CHECK_EVERY

    use_avg = (err_avg < err_cur)[:, None]
    x_cand = torch.where(use_avg, x_avg, x)
    y_cand = torch.where(use_avg, y_avg, y)
    err_cand = torch.minimum(err_avg, err_cur)
    do_restart = (err_cand <= RESTART_BETA * st.err_restart) | (it_cycle >= RESTART_LEN)

    dx = torch.linalg.vector_norm(x_cand - st.x_restart, dim=1)
    dy = torch.linalg.vector_norm(y_cand - st.y_restart, dim=1)
    omega_new = torch.where(
        (dx > 1e-30) & (dy > 1e-30),
        torch.exp(0.5 * torch.log(st.omega) + 0.5 * torch.log(dy / dx)),
        st.omega,
    )
    rs = do_restart & live
    rcol = rs[:, None]
    st_new = _PDHGLanes(
        x=torch.where(rcol, x_cand, x),
        y=torch.where(rcol, y_cand, y),
        x_sum=torch.where(rcol, 0.0, x_sum),
        y_sum=torch.where(rcol, 0.0, y_sum),
        n_avg=torch.where(rs, 0.0, n_avg),
        x_restart=torch.where(rcol, x_cand, st.x_restart),
        y_restart=torch.where(rcol, y_cand, st.y_restart),
        err_restart=torch.where(rs, err_cand, st.err_restart),
        omega=torch.where(rs, omega_new, st.omega),
        it_cycle=torch.where(rs, torch.zeros_like(it_cycle), it_cycle),
    )
    # Frozen lanes keep their previous state verbatim.
    st_new = _PDHGLanes(*(
        torch.where(live.reshape((B,) + (1,) * (new.dim() - 1)), new, old)
        for new, old in zip(st_new, st)
    ))
    err_new = torch.where(live, torch.minimum(err_cand, err_cur), err)
    it = torch.where(live, it + CHECK_EVERY, it)
    live = live & (err_new > s["tol"]) & (it < s["max_iter"]) & torch.isfinite(err_new)
    return st_new, it, err_new, live


def _lanes_meta(carry):
    _, it, err, live = carry
    return torch.stack([it.max().to(err.dtype), live.sum().to(err.dtype)])


class _PDHGBucketProgram:
    """One cached bucket program of the PDHG engine — the counterpart of
    one compiled ``_pdhg_bucket_jit`` executable of the JAX package,
    built the way ``backends/batched.py::_BucketProgram`` is.

    It owns static device buffers for the bucket's A, b, c, the lanes'
    step sizes η and a table of B power-iteration start vectors (row k
    seeded with k, fixed per program), and the :class:`DeviceLoop` of the
    masked batched loop over them. A dispatch ``copy_``s its bucket into
    the buffers, gathers each lane's start vector from the table by its
    seed index, runs the power iteration and the start (eager), the loop (on a card ONE CUDA graph,
    captured at the program's first dispatch and only replayed after;
    ``tol`` and ``max_iter`` are fills) and the final report."""

    def __init__(self, B, m, n, dtype, device):
        zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
        self.B = B
        self.A, self.b, self.c = zeros(B, m, n), zeros(B, m), zeros(B, n)
        self.eta = zeros(B)
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        self.v0 = torch.from_numpy(np.stack([threefry.normal(k, n, np_dtype)
                                             for k in range(B)])).to(device)
        inputs = {
            "max_iter": torch.zeros((), dtype=torch.int32, device=device),
            "tol": torch.zeros((), dtype=dtype, device=device),
        }
        self.loop = device_loop.DeviceLoop(
            lambda carry, s: _lanes_body(carry, s, self.A, self.b, self.c, self.eta),
            lambda carry, s: carry[3].any(),
            _lanes_meta, inputs, capture_on_exit=True,
        )
        self.lock = threading.Lock()

    def fill(self, A, b, c) -> None:
        for dst, src in ((self.A, A), (self.b, b), (self.c, c)):
            if dst is not src:
                dst.copy_(src)

    def _norms(self, seeds, iters: int = 30):
        """Per-lane ‖A_k‖₂ from the power iteration started at row
        ``seeds[k]`` of the start-vector table."""
        A = self.A
        v0 = self.v0.index_select(0, seeds)
        v = v0 / torch.linalg.vector_norm(v0, dim=1, keepdim=True)
        for _ in range(iters):
            w = _bmtv(A, _bmv(A, v))
            v = w / torch.linalg.vector_norm(w, dim=1, keepdim=True).clamp_min(1e-30)
        return torch.sqrt(torch.linalg.vector_norm(_bmtv(A, _bmv(A, v)), dim=1))

    def run(self, active, tol: float, max_inner: int, seeds):
        """Step sizes, the start, the loop and the final per-lane report,
        on the filled buffers; ``seeds`` (B,) int64 indexes each lane's
        start vector. Returns the host-side fields and the loop's
        accounting for this dispatch."""
        A, b, c = self.A, self.b, self.c
        B, dtype = self.B, A.dtype
        self.eta.copy_(0.9 / self._norms(seeds).clamp_min(1e-12))
        zB = torch.zeros(B, dtype=dtype, device=A.device)
        err0 = _lanes_err(A, b, c, torch.zeros_like(c), torch.zeros_like(b))
        st0 = _PDHGLanes(
            x=torch.zeros_like(c), y=torch.zeros_like(b),
            x_sum=torch.zeros_like(c), y_sum=torch.zeros_like(b), n_avg=zB,
            x_restart=torch.zeros_like(c), y_restart=torch.zeros_like(b),
            err_restart=err0, omega=torch.ones_like(zB),
            it_cycle=torch.zeros(B, dtype=torch.int32, device=A.device),
        )
        live0 = active & (err0 > tol)
        carry = (st0, torch.zeros(B, dtype=torch.int32, device=A.device), err0.clone(), live0)
        before = self.loop.report()
        (st, it, _, _), _ = self.loop.run(carry, tol=tol, max_iter=max_inner)
        after = self.loop.report()
        acc = {k: after[k] - before[k]
               for k in ("runs", "captures", "bodies", "eager", "replays", "masked")}
        for k in ("eager_ms", "replay_ms"):
            acc[k] = after[k] - before[k]
        acc["capture_ms"] = after["capture_ms"] if acc["captures"] else 0.0
        # Report the better of (last, cycle average) per lane.
        has_avg = (st.n_avg > 0)[:, None]
        navg = st.n_avg.clamp_min(1.0)[:, None]
        x_avg = torch.where(has_avg, st.x_sum / navg, st.x)
        y_avg = torch.where(has_avg, st.y_sum / navg, st.y)
        use_avg = (_lanes_err(A, b, c, x_avg, y_avg) < _lanes_err(A, b, c, st.x, st.y))[:, None]
        x_fin = torch.where(use_avg, x_avg, st.x)
        y_fin = torch.where(use_avg, y_avg, st.y)
        pinf, dinf, gap, pobj, _ = _lanes_kkt(A, b, c, x_fin, y_fin)
        to_np = lambda v: v.detach().to(torch.float64).cpu().numpy()
        host = {"x": to_np(x_fin), "y": to_np(y_fin), "iterations": it.cpu().numpy(),
                "pinf": to_np(pinf),
                "dinf": to_np(dinf), "gap": to_np(gap), "pobj": to_np(pobj),
                "active": active.cpu().numpy()}
        return host, acc


# PDHG bucket programs of this process, by key (B, m, n, dtype, device).
_PROGRAMS: dict = {}
_PROGRAMS_LOCK = threading.Lock()


def pdhg_bucket_cache_size() -> int:
    """PDHG bucket programs in this process — the serve layer's
    zero-warm-rebuild accounting (summed into
    ``backends.batched.bucket_cache_size``)."""
    with _PROGRAMS_LOCK:
        return len(_PROGRAMS)


def pdhg_bucket_capture_count() -> int:
    """CUDA-graph captures the PDHG bucket programs made so far."""
    with _PROGRAMS_LOCK:
        return sum(p.loop.captures for p in _PROGRAMS.values())


def release_pdhg_bucket_programs() -> None:
    """Close every PDHG bucket program and drop it from the cache."""
    with _PROGRAMS_LOCK:
        progs = list(_PROGRAMS.values())
        _PROGRAMS.clear()
    for p in progs:
        with p.lock:
            p.loop.close()


def solve_pdhg_bucket(
    batch,
    active,
    config: Optional[SolverConfig] = None,
    mesh=None,
    max_iter: Optional[int] = None,
    device=None,
    seeds=None,
    **config_overrides,
):
    """Solve one pre-padded serving bucket with batched restarted PDHG —
    the first-order engine of the tolerance-tiered serve ladder (requests
    at tol ≥ ``ServiceConfig.pdhg_tol`` route here; see
    serve/service.py).

    Mirrors ``backends.batched.solve_bucket``'s contract: ``batch`` is
    (B, m, n)/(B, m)/(B, n) arrays already padded to the bucket shape (or
    placed by ``place_bucket``), ``active`` the live-slot mask; returns a
    ``BatchedResult``. ``config.max_iter`` (or ``max_iter``) counts
    bursts of 400 inner PDHG steps. Verdicts are crossover-honest:
    OPTIMAL only where the final true KKT error meets the request
    tolerance, anything else ITERATION_LIMIT (the service's solo ladder
    owns it); padding slots report the placeholder OPTIMAL. ``y``/``s``/
    ``w``/``z`` are left None: a tol-loose PDHG iterate must not seed the
    warm cache the IPM engine draws from. Runs on the first CUDA card
    unless ``device`` names another; ``mesh`` is not ported and raises.
    The lanes' duals are in ``BatchedResult.dual``, for KKT checks.

    ``seeds`` (B ints in [0, B)) picks each lane's power-iteration start
    vector; the serve layer passes :func:`pdhg_seed` of each request's
    name and each padding slot's own index. None = every slot its own
    index. Two lanes may share a seed.
    """
    from distributedlpsolver_tpu_torch.backends.batched import BatchedResult, place_bucket

    if mesh is not None:
        raise _mesh_unported("solve_pdhg_bucket over a mesh")
    cfg = config or SolverConfig()
    if config_overrides:
        cfg = cfg.replace(**config_overrides)
    dev = resolve_device(device)
    dtype = dense._torch_dtype(cfg.dtype)

    t0 = time.perf_counter()
    if isinstance(batch.A, torch.Tensor) and batch.A.device == dev and batch.A.dtype == dtype:
        A, b, c = batch.A, batch.b, batch.c
        act = active if isinstance(active, torch.Tensor) else torch.as_tensor(
            np.asarray(active, dtype=bool), device=dev)
    else:
        placed, act = place_bucket(batch, active, cfg, device=dev)
        A, b, c = placed.A, placed.b, placed.c
    setup_time = time.perf_counter() - t0

    Bsz, m, n = A.shape
    inner_cap = int(max_iter if max_iter is not None else cfg.max_iter) * BURST
    t1 = time.perf_counter()
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    key = (Bsz, m, n, dtype, dev)
    with _PROGRAMS_LOCK:
        prog = _PROGRAMS.get(key)
        built = prog is None
        if built:
            prog = _PROGRAMS[key] = _PDHGBucketProgram(Bsz, m, n, dtype, dev)
    seed_idx = np.arange(Bsz) if seeds is None else np.asarray(seeds, dtype=np.int64)
    if seed_idx.shape != (Bsz,) or seed_idx.min() < 0 or seed_idx.max() >= Bsz:
        raise ValueError(f"seeds must be {Bsz} indices in [0, {Bsz}), got {seeds!r}")
    seed_t = torch.as_tensor(seed_idx, dtype=torch.int64).to(dev, non_blocking=True)
    with prog.lock:
        prog.fill(A, b, c)
        host, acc = prog.run(act, float(cfg.tol), inner_cap, seed_t)
    solve_time = time.perf_counter() - t1

    pinf, dinf, gap = host["pinf"], host["dinf"], host["gap"]
    ok = (gap <= cfg.tol) & (pinf <= cfg.tol) & (dinf <= cfg.tol)
    # Inactive (padding) slots report the same placeholder OPTIMAL as
    # solve_bucket — demux by slot and ignore them.
    ok = ok | ~host["active"].astype(bool)
    it_host = host["iterations"]
    return BatchedResult(
        status=np.array([Status.OPTIMAL if o else Status.ITERATION_LIMIT for o in ok],
                        dtype=object),
        objective=host["pobj"],
        x=host["x"],
        iterations=it_host,
        rel_gap=gap,
        pinf=pinf,
        dinf=dinf,
        solve_time=solve_time,
        setup_time=setup_time,
        phase_report=[{"phase": 0, "engine": "pdhg", "tol": float(cfg.tol),
                       "iters": int(it_host.max(initial=0)), "built": built, **acc}],
        fused_iters=CHECK_EVERY,  # inner steps per loop body
        dual=host["y"],
    )
