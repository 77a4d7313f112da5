"""Matrix-free inexact-IPM backend: PCG normal equations, no ADAᵀ ever.

The port of the JAX package's ``backends/sparse_iterative.py``
(single device). The per-iteration Newton solves run preconditioned CG
(``ops/pcg.py``) against the matrix-free operator ``v ↦ A·(d ∘ Aᵀv) +
reg·v`` over the hybrid-ELL :class:`~distributedlpsolver_tpu_torch.ops.
sparse.SparseOperator`, whose products are the hand-written CUDA kernel
of ``ops/ell_spmv.py`` on a card. The only m-sized objects are vectors
and the preconditioner's fixed small blocks (:meth:`SparseIterativeBackend.
memory_report` — the guard that ADAᵀ was never formed in any format).

Preconditioners, resolved at setup as in the reference: ``jacobi`` (the
default), ``block`` (exact bs×bs diagonal blocks), ``bordered``
(block-Jacobi over scenario row blocks + Woodbury first-stage
capacitance; chosen for a ``bordered`` hint or a contiguous two-stage
one), ``ildl`` (incomplete LDLᵀ). Under ``precond="auto"`` an
unstructured solve whose Newton solves keep burning half the CG cap (or
that takes a bad step) escalates once to ILDL.

Inexactness: the CG tolerance rides the reference's forcing sequence
keyed to the last iterate's KKT error, read on the host from the step's
statistics (which the host reads anyway, in one transfer a step). A
warm-cache seam (:meth:`~SparseIterativeBackend.offer_precond` /
:meth:`~SparseIterativeBackend.export_precond`) freezes a prior solve's
preconditioner factors for the early iterations.

Each step is the shared ``ipm/core.py::mehrotra_step`` run eagerly on the
backend's device with this backend's ``LinOps``; CG asks the host whether
to go on once per chunk of masked iterations (``ops/pcg.py``). The
driver's host loop runs it (there is no fused loop, as in the reference).

Not ported: the row-sharded tier (``mesh=``, ``reshard()``; ROADMAP
Queue 1 item 13c).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from distributedlpsolver_tpu_torch.backends.base import SolverBackend, register_backend
from distributedlpsolver_tpu_torch.backends.dense import _torch_dtype, resolve_device
from distributedlpsolver_tpu_torch.ipm import core
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.ipm.state import IPMState, StepStats
from distributedlpsolver_tpu_torch.models.problem import InteriorForm
from distributedlpsolver_tpu_torch.obs import context as obs_context
from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics
from distributedlpsolver_tpu_torch.obs import trace as obs_trace
from distributedlpsolver_tpu_torch.ops import ildl as ildl_ops
from distributedlpsolver_tpu_torch.ops import pcg as pcg_ops
from distributedlpsolver_tpu_torch.ops import sparse as sparse_ops

# CG cap per Newton solve: m+32 makes PCG an exact solver on probe shapes;
# the absolute cap keeps one solve bounded at storm scale.
_CG_CAP = 2048

# Forcing sequence: cg_tol = clip(_FORCE_FRAC · err, cfg.cg_tol,
# _FORCE_MAX) — loose solves while the iterate is far, tightening with the
# KKT error.
_FORCE_FRAC = 0.05
_FORCE_MAX = 1e-2

# A frozen (warm-cache-supplied) preconditioner is kept while the
# iterate's relative KKT error stays above this.
_FROZEN_ERR_EXIT = 1e-4

# ILDL auto-escalation trigger: this many CONSECUTIVE Newton-solve steps
# each spending ≥ _ILDL_CG_FRAC of the CG cap — or one bad step.
_ILDL_CG_FRAC = 0.5
_ILDL_STREAK = 3

_MESH_UNPORTED = ("the row-sharded sparse tier (mesh=, reshard) is not ported to the torch "
                  "package yet (ROADMAP Queue 1 item 13c)")


def _bordered_usable(hint: dict) -> bool:
    """Whether a block-structure hint feeds the bordered-Woodbury
    preconditioner: an explicit ``bordered`` hint, or a ``two_stage`` one
    with no first-stage rows and a contiguous layout (the reference's
    test)."""
    kind = hint.get("kind")
    if kind == "bordered":
        return True
    if kind != "two_stage":
        return False
    if int(hint.get("first_stage_m", 0)) != 0:
        return False
    rb = hint.get("row_block")
    if rb is not None:
        rb = np.asarray(rb)
        mb = int(hint.get("block_m", 0))
        K = int(hint.get("num_blocks", 0))
        if mb * K != rb.size:
            return False
        if not np.array_equal(rb, np.repeat(np.arange(K), mb)):
            return False
        cb = np.asarray(hint.get("col_block"))
        n0 = int(hint.get("first_stage_n", 0))
        if cb is None or not np.all(cb[:n0] == -1):
            return False
    return True


def _build_factors(op, prec, d, reg):
    """Preconditioner factors for scaling ``d``: the inverse normal
    diagonal for Jacobi (``prec is None``), else the block / bordered /
    ILDL factors."""
    if prec is None:
        return 1.0 / op.normal_diag(d, reg)
    return prec.factor(d, reg)


def _apply_factors(prec, factors):
    if prec is None:
        idiag = factors
        return lambda r: r * idiag
    return prec.apply_with(factors)


def _as_csr(A) -> sp.csr_matrix:
    return A.tocsr() if sp.issparse(A) else sp.csr_matrix(np.asarray(A))


@register_backend("sparse-iterative", "inexact-ipm", "sparse-pcg")
class SparseIterativeBackend(SolverBackend):
    """Inexact (PCG) normal-equations execution of the shared IPM core, on
    one CUDA card (or the CPU when asked for with ``device="cpu"``)."""

    def __init__(self, precond: str = "auto", mesh=None, device=None):
        if precond not in ("auto", "jacobi", "block", "bordered", "ildl"):
            raise ValueError(f"precond must be auto/jacobi/block/bordered/ildl; got {precond!r}")
        if mesh is not None:
            raise NotImplementedError(_MESH_UNPORTED)
        self._precond_req = precond
        self.device = resolve_device(device)
        self._prec = None
        self._frozen = None
        self._cfg: Optional[SolverConfig] = None

    # -- setup -----------------------------------------------------------

    def setup(self, inf: InteriorForm, config: SolverConfig) -> None:
        self._cfg = config
        dtype = _torch_dtype(config.dtype)
        dev = self.device
        A = inf.A
        hint = inf.block_structure or {}
        kind = self._precond_req
        self._op = sparse_ops.from_scipy(A, dtype=dtype, device=dev)
        if kind == "auto":
            kind = "bordered" if _bordered_usable(hint) else "jacobi"
        if kind == "bordered":
            self._prec = pcg_ops.BorderedPrecond(_as_csr(A), hint, dtype=dtype, device=dev)
        elif kind == "block":
            self._prec = pcg_ops.BlockJacobi(_as_csr(A), dtype=dtype, device=dev)
        elif kind == "ildl":
            self._prec = ildl_ops.ILDLPrecond(_as_csr(A), dtype=dtype, device=dev)
        else:
            self._prec = None
        self.precond = kind
        # ILDL escalation candidates: auto-routed Jacobi on an unstructured
        # pattern. Host CSR kept for the symbolic phase only.
        self._A_csr = None
        self._ildl_tried = False
        self._hi_cg = 0
        if (self._precond_req == "auto" and kind == "jacobi" and not _bordered_usable(hint)
                and int(A.shape[0]) <= ildl_ops._MAX_ROWS):
            self._A_csr = _as_csr(A)
        self._data = core.make_problem_data(
            np.asarray(inf.c, dtype=np.float64), np.asarray(inf.b, dtype=np.float64),
            np.asarray(inf.u, dtype=np.float64), dtype, dev,
        )
        self._dtype = dtype
        self._params = config.step_params()
        self._reg = float(config.reg_dual)
        self._cg_cap = min(self._op.m + 32, _CG_CAP)
        self._cg_floor = float(config.cg_tol)
        self._last_err = 1.0
        self._frozen = None
        self._frozen_used = 0
        self._last_state = None
        self._cg_iters_total = 0
        self._cg_per_iter = []
        self._newton_solves = 0
        self._host_syncs = 0
        self._cg_hint = None  # the last Newton solve's CG count: the next one's first chunk
        self._m_cg = obs_metrics.get_registry().counter(
            "sparse_cg_iters_total", labels={"precond": kind},
            help="PCG iterations spent in the sparse-iterative backend",
        )

    # -- warm-cache preconditioner seam ----------------------------------

    def offer_precond(self, d_prior) -> bool:
        """Seed the preconditioner from a prior same-structure solve's
        final scaling vector (warm cache): the factors are built once here
        and reused (frozen) until the iterate's KKT error drops to the
        endgame. Takes the export dict (``{"d": numpy, "precond": name}``)
        or a bare vector; a mismatched, non-finite or non-positive vector
        is refused (False)."""
        if isinstance(d_prior, dict):
            d_prior = d_prior.get("d")
            if d_prior is None:
                return False
        d_prior = np.asarray(d_prior, dtype=np.float64).ravel()
        if self._cfg is None or d_prior.shape != (self._op.n,):
            return False
        if not np.all(np.isfinite(d_prior)) or not np.all(d_prior > 0):
            return False
        d = torch.as_tensor(d_prior, dtype=self._dtype, device=self.device)
        self._frozen = _build_factors(self._op, self._prec, d, self._reg)
        self._frozen_used = 0
        return True

    def export_precond(self):
        """This solve's final scaling vector, host-canonical (numpy dict),
        for the warm cache (None before any step)."""
        if self._last_state is None:
            return None
        d = core.scaling_d(self._last_state, self._data, self._params)
        return {"d": d.double().cpu().numpy(), "precond": self.precond}

    # -- driver surface --------------------------------------------------

    def _cg_tol(self) -> float:
        return float(min(_FORCE_MAX, max(self._cg_floor, _FORCE_FRAC * self._last_err)))

    def _ops(self, acc: list, frozen=None) -> core.LinOps:
        """LinOps over the matrix-free normal operator; ``acc`` collects
        each Newton solve's CG count, ``frozen`` short-circuits the factor
        build with warm-cache factors."""
        op, prec, reg = self._op, self._prec, self._reg
        cg_tol, cg_max = self._cg_tol(), self._cg_cap

        def factorize(d):
            if frozen is not None:
                return d, frozen
            return d, _build_factors(op, prec, d, reg)

        def solve(factors, rhs):
            d, fac = factors

            def mv(v):
                return op.matvec(d * op.rmatvec(v)) + reg * v

            syncs = pcg_ops.pcg.syncs
            x, it = pcg_ops.pcg(mv, _apply_factors(prec, fac), rhs, cg_tol, cg_max,
                                first_chunk=self._cg_hint)
            self._host_syncs += pcg_ops.pcg.syncs - syncs
            self._newton_solves += 1
            self._cg_hint = max(it, 1)
            acc.append(it)
            return x

        return core.LinOps(matvec=op.matvec, rmatvec=op.rmatvec, factorize=factorize, solve=solve)

    def starting_point(self) -> IPMState:
        acc = []
        st = core.starting_point(self._ops(acc), self._data, self._params)
        self._note_cg(sum(acc))
        return st

    def iterate(self, state: IPMState) -> Tuple[IPMState, StepStats]:
        acc = []
        if self._frozen is not None and self._last_err > _FROZEN_ERR_EXIT:
            ops = self._ops(acc, frozen=self._frozen)
            self._frozen_used += 1
        else:
            self._frozen = None
            ops = self._ops(acc)
        new_state, stats = core.mehrotra_step(ops, self._data, self._params, state)
        # One device→host copy of every scalar of the step.
        host = torch.stack([v.to(self._dtype) for v in stats]).cpu().tolist()
        stats = StepStats(*host[:-1], bad=bool(host[-1]))
        self._note_cg(sum(acc))
        if stats.bad:
            # A frozen (stale) preconditioner is the first suspect on a
            # failed solve: drop it before the driver escalates reg.
            self._frozen = None
            self._maybe_escalate_ildl(force=True)
        else:
            self._maybe_escalate_ildl()
            self._last_err = float(max(stats.rel_gap, stats.pinf, stats.dinf))
            self._last_state = new_state
        return new_state, stats

    def _note_cg(self, n: int) -> None:
        self._cg_iters_total += n
        self._cg_per_iter.append(n)
        self._m_cg.inc(n)
        tr = obs_trace.get_tracer()
        if tr.enabled:
            # One instant per step's CG work, linked to the owning request.
            cg_args = {"cg_iters": n, "precond": self.precond, "shards": 1, "psum_per_iter": 0}
            ctx = obs_context.current()
            if ctx is not None:
                cg_args.update(ctx.span_args())
            tr.instant("cg.step", args=cg_args, cat="cg")
        if n >= int(_ILDL_CG_FRAC * self._cg_cap):
            self._hi_cg += 1
        else:
            self._hi_cg = 0

    def _maybe_escalate_ildl(self, force: bool = False) -> None:
        """Swap Jacobi → incomplete-LDLᵀ when the iteration counts say
        Jacobi stopped capturing the spectrum (see _ILDL_STREAK); tried at
        most once per solve. A pattern over the ILDL budget keeps Jacobi."""
        if self._A_csr is None or self._ildl_tried:
            return
        if not force and self._hi_cg < _ILDL_STREAK:
            return
        self._ildl_tried = True
        try:
            prec = ildl_ops.ILDLPrecond(self._A_csr, dtype=self._dtype, device=self.device)
        except ValueError:
            return
        self._prec = prec
        self.precond = "ildl"
        # Frozen factors are Jacobi-shaped; the new apply can't use them.
        self._frozen = None
        self._hi_cg = 0
        self._m_cg = obs_metrics.get_registry().counter(
            "sparse_cg_iters_total", labels={"precond": "ildl"},
            help="PCG iterations spent in the sparse-iterative backend",
        )

    def bump_regularization(self) -> bool:
        if self._reg * self._cfg.reg_grow > 1e-2:
            return False
        self._reg = max(self._reg, 1e-12) * self._cfg.reg_grow
        return True

    def reshard(self, mesh):
        raise NotImplementedError(_MESH_UNPORTED)

    def to_host(self, state: IPMState) -> IPMState:
        return IPMState(*(v.detach().cpu().numpy() for v in state))

    def from_host(self, state: IPMState) -> IPMState:
        return IPMState(*(torch.tensor(np.asarray(v, dtype=np.float64), dtype=self._dtype,
                                       device=self.device) for v in state))

    def block_until_ready(self, obj) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- telemetry & guards ----------------------------------------------

    def cg_report(self) -> dict:
        """cg_iters telemetry: total + per-IPM-iteration counts, the
        resolved preconditioner, and the host reads of CG's exit flag."""
        return {
            "cg_iters": self._cg_iters_total,
            "cg_per_iteration": list(self._cg_per_iter),
            "precond": self.precond,
            "cg_cap": self._cg_cap,
            "warm_precond_steps": self._frozen_used,
            "shards": 1,
            "psum_per_iter": 0,
            "newton_solves": self._newton_solves,
            "host_syncs": self._host_syncs,
        }

    def memory_report(self) -> dict:
        """Every device tensor this backend holds, name → {shape, nbytes}
        — the never-materialized-ADAᵀ guard."""
        rep = {f"operator.{k}": v for k, v in self._op.memory_report().items()}
        if self._prec is not None:
            rep.update({f"precond.{k}": v for k, v in self._prec.memory_report().items()})
        for name in ("c", "b", "u_f", "hub"):
            a = getattr(self._data, name)
            rep[f"data.{name}"] = {"shape": tuple(int(s) for s in a.shape),
                                   "nbytes": int(a.numel()) * a.element_size()}
        return rep

    def max_operand_nbytes(self, per_device: bool = False) -> int:
        """Largest live device operand (one device: ``per_device`` changes
        nothing)."""
        return max(v["nbytes"] for v in self.memory_report().values())
