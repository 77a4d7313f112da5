"""Distributed backend: the constraint matrix split by columns over a
mesh.

The port of the JAX package's ``backends/sharded.py`` — the north-star
distributed path (BASELINE.json:5): the reference row-partitions the
constraint matrix across MPI ranks and all-reduces the per-rank Schur
contributions every iteration. Each member of the mesh
(``parallel/mesh.py``) holds the column block ``A_k`` (m × n/K, on its
device): a rank of a process-group mesh its own, a local mesh every
member's in one process (``self._blocks``). ``M = Σ_k
A_k·diag(d_k)·A_kᵀ`` is K1 on each block plus one sum over the axis
(:meth:`Mesh.sum_parts`: the reference's ``MPI_Allreduce`` of Schur
blocks, called by hand where the JAX package lets GSPMD insert it).

The collectives live inside the step's ``core.LinOps`` and nowhere else,
so ``core.mehrotra_step`` stays the one step every backend runs
(:func:`split_ops`):

* ``factorize(d)``: K1 on ``(A_k, d[cols_k])``, the sum of M, the
  relative regularization, and ``cholesky_ex`` on every rank
  (replicated, as in the JAX package and the reference);
* ``matvec(v)`` = the sum of ``A_k @ v[cols_k]``;
* ``rmatvec(y)``: each block writes ``A_kᵀ·y`` into its slot of a zeroed
  (n,) vector, then the sum — a sum with zeros is exact, so the slots
  keep their bits.

Placement differs from the JAX package on purpose: c, b, u and the
iterate x, s, w, z, y stay REPLICATED (O(n) a rank against A_k's
O(m·n/K)), so none of the step's reductions (ratio tests, μ, the norms)
needs a collective. A collective hands every rank the same bits, so
every rank holds the same iterate and takes the same branches (status,
stall, regularization, CG's exit) with no extra collective.

PCG (``solve_mode="pcg"``, and the automatic PCG plan of
``schedule_platform="tpu"`` for 2²⁶ ≤ m·n < 2²⁸; :func:`sharded_pcg_ops`,
the JAX package's ``_pcg_ops(prec_shard=…)``): a factorization is K1 in
f32 on each block's f32 copy, one sum of M, the Jacobi scaling and
``reg·I`` in f32, and ``ops/dist_chol.py::chol_tri_inv_mesh`` at the
reference's panel (256): ``L⁻¹`` split by columns over the axis
(:meth:`~ShardedTorchBackend.prec_sharding`), each member's (mp, w) slab
cast to the iterate dtype once. A factorization makes 1 + 2·P sums (P:
``dist_chol.slab_plan``'s panel count). CG runs in the iterate dtype on
the true operator ``A·(d∘Aᵀv) + reg·diag(M)∘v`` with the preconditioner
``s∘L⁻ᵀ·(L⁻¹·(s∘r))``: 4 sums a CG iteration (the operator's two, the
slabs' two). M stays replicated where the reference reduce-scatters it
into column slabs (ROADMAP Queue 3): each rank holds one f32 M (m²·4
bytes) beside its f64 slabs (mp·w·8). The primal-row closure of a
segmented PCG plan factors ``G = Σ_k K1(A32_k, 1)`` (one sum, then
``_scaled_inverse`` replicated, as the reference's ``_closure_from_G``)
and applies it with the sharded ``matvec``/``rmatvec``. A failed panel
factor is NaN, which the sums carry to every rank: the step is flagged
bad and the regularization escalated, as on one device.

The fused loop: NCCL collectives are captured into the loop's CUDA graph
(the PCG body's panels and CG iterations among them); gloo's cannot be,
so a gloo world on a card runs the loop uncaptured (``phase_report``
rows say ``captured: False`` with the reason). A failed collective or
kernel raises.

Setting ``clock`` to a :class:`StageClock` times the step's parts on the
host clock, synchronizing the device around each: for measurement runs
only (it turns capture off while it is set). The spans: ``k1`` (K1 on
a block), ``allreduce_M``, ``factorize`` (the whole factorization),
``allreduce_vec`` (the step's products); on PCG also ``chol_inv`` (the
panel factorization and inverse, with their sums ``allreduce_panel``),
``pcg_solve`` (a Newton solve's CG, with its sums ``allreduce_cg`` for
the operator and ``allreduce_prec`` for the slabs).

:meth:`ShardedTorchBackend.reshard` is the elastic shrink's seam: a fresh
instance on the re-formed mesh (``parallel.mesh.reform_mesh``), whose
``setup`` pads the columns to the new mesh's multiple and whose
``from_host`` re-pads the host-canonical checkpoint onto the new column
blocks; the supervisor resumes from it (a PCG solve too: ``solve_mode``
travels in the config, ``schedule_platform`` in the backend).

``schedule_platform="tpu"`` is the dense backend's parity seam (see
``backends/dense.py``): the reference's TPU schedule on the mesh, whose
two-phase plans run phase 1 with K1 in f32 on each block's f32 copy and
the same sum of M. Not ported: the dense endgame of a PCG plan at m·n ≥
2²⁸ (``setup`` raises, as on one device; ROADMAP Queue 1 item 5b).
"""

from __future__ import annotations

import collections
import time
from typing import Optional, Tuple

import torch

from distributedlpsolver_tpu_torch.backends.base import register_backend
from distributedlpsolver_tpu_torch.backends.dense import (
    DenseTorchBackend,
    _cholesky_ops,
    _closure_factors,
    _closure_project,
    _pcg_ops,
)
from distributedlpsolver_tpu_torch.ipm import core
from distributedlpsolver_tpu_torch.ops import dist_chol
from distributedlpsolver_tpu_torch.ops.normal_eq import normal_eq
from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib
from distributedlpsolver_tpu_torch.parallel import runtime


# The panel width of the PCG preconditioner's distributed factorization
# (the reference's chol_tri_inv_mesh default, which its _pcg_ops takes).
PCG_PANEL = 256


class StageClock:
    """Host-clock milliseconds of the sharded step's parts. Each span
    synchronizes the device before and after (so the time is the part's
    own), which is why a clocked loop runs uncaptured."""

    def __init__(self, device: torch.device):
        self.device = device
        self.ms = collections.Counter()
        self.calls = collections.Counter()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name, fn, *args):
        self._sync()
        t0 = time.perf_counter()
        out = fn(*args)
        self._sync()
        self.ms[name] += 1e3 * (time.perf_counter() - t0)
        self.calls[name] += 1
        return out

    def report(self) -> dict:
        return {"ms": dict(self.ms), "calls": dict(self.calls)}


class _ClockedSums:
    """``mesh`` with its :meth:`~Mesh.sum_parts` in a span ``name`` of
    ``clock`` (for ``ops/dist_chol.py``, which sums through the mesh it
    is given)."""

    def __init__(self, mesh: mesh_lib.Mesh, clock: StageClock, name: str):
        self._mesh, self._clock, self._name = mesh, clock, name

    def __getattr__(self, attr):
        return getattr(self._mesh, attr)

    def sum_parts(self, parts, axis=None):
        return self._clock.span(self._name, self._mesh.sum_parts, parts, axis)


def _timed(clock: Optional[StageClock]):
    return (lambda name, fn, *args: fn(*args)) if clock is None else clock.span


def split_ops(blocks_as, dtype, n, mesh, axis=None, clock: Optional[StageClock] = None,
              vec_name: str = "allreduce_vec") -> Tuple:
    """``(assemble, matvec, rmatvec)`` over the column blocks this process
    holds: ``blocks_as(dt)`` gives ``[(lo, hi, A_k)]`` in dtype ``dt``
    (columns ``[lo, hi)`` of the n-wide, padded matrix), the products run
    on ``dtype``'s. Each is one sum over ``axis`` (see the module note);
    the products' sums are spans ``vec_name`` of ``clock``."""
    timed = _timed(clock)

    def assemble(src, d):
        parts = [timed("k1", normal_eq, A_k, d[lo:hi].to(A_k.device))
                 for lo, hi, A_k in blocks_as(src.dtype)]
        return timed("allreduce_M", mesh.sum_parts, parts, axis)

    def matvec(v):
        parts = [A_k @ v[lo:hi].to(A_k.device) for lo, hi, A_k in blocks_as(dtype)]
        return timed(vec_name, mesh.sum_parts, parts, axis)

    def rmatvec(y):
        parts = []
        for lo, hi, A_k in blocks_as(dtype):
            out = torch.zeros(n, dtype=y.dtype, device=A_k.device)
            out[lo:hi] = A_k.T @ y.to(A_k.device)
            parts.append(out)
        return timed(vec_name, mesh.sum_parts, parts, axis)

    return assemble, matvec, rmatvec


def sharded_pcg_ops(A, Af, blocks_as, n, mesh, axis, cg_tol, cg_iters, counts=None,
                    clock: Optional[StageClock] = None) -> Tuple:
    """factorize/solve closures of the PCG mode on a mesh (the JAX
    package's ``_pcg_ops(prec_shard=P(None, axis))``): the dense
    backend's :func:`~backends.dense._pcg_ops` with the assembly summed
    over the blocks, ``L⁻¹`` built by ``dist_chol.chol_tri_inv_mesh`` in
    column slabs over ``axis`` and applied by ``dist_chol.apply`` /
    ``apply_t``, and the operator's products summed over the blocks (see
    the module note). ``A``/``Af`` are this process's first block in the
    iterate dtype and in f32."""
    timed = _timed(clock)
    assemble, matvec, rmatvec = split_ops(blocks_as, A.dtype, n, mesh, axis, clock,
                                          "allreduce_cg")
    panels = mesh if clock is None else _ClockedSums(mesh, clock, "allreduce_panel")
    slabs = mesh if clock is None else _ClockedSums(mesh, clock, "allreduce_prec")

    def invert(Ms, dt):
        inv = timed("chol_inv", dist_chol.chol_tri_inv_mesh, Ms, panels, axis, PCG_PANEL)
        return inv._replace(slabs=tuple(S.to(dt) for S in inv.slabs))

    def apply_prec(inv, v):
        return dist_chol.apply_t(inv, dist_chol.apply(inv, v, slabs), slabs)

    factorize, solve = _pcg_ops(A, Af, cg_tol, cg_iters, counts, assemble, invert, apply_prec,
                                matvec, rmatvec)
    return factorize, lambda factors, rhs: timed("pcg_solve", solve, factors, rhs)


@register_backend("sharded", "tpu-sharded", "mesh")
class ShardedTorchBackend(DenseTorchBackend):
    """The dense backend's step over a column-split mesh: same
    ``core.mehrotra_step``, the collectives in its ``LinOps``.

    ``mesh`` defaults to :func:`parallel.mesh.make_mesh` of
    ``SolverConfig.mesh_shape`` over ``mesh_axis`` at setup: every rank of
    the ``torch.distributed`` world, or a world of one without one. A
    local mesh (``make_mesh(devices=[...])``) holds every member's block
    in this process. ``device`` defaults to the mesh's (the world's)
    device."""

    def __init__(self, mesh: Optional[mesh_lib.Mesh] = None, device=None,
                 schedule_platform: Optional[str] = None):
        if device is None:
            device = mesh.device if mesh is not None else runtime.world_device()
        super().__init__(device, schedule_platform)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"mesh device {mesh.device} != backend device {self.device}")
        self._mesh = mesh
        self._axis: Optional[str] = None
        # dtype -> [(lo, hi, A_k)]: the column blocks this process holds.
        self._blocks: dict = {}
        self.clock = None

    @property
    def clock(self) -> Optional[StageClock]:
        """The stage clock, or None. Setting it decides capture again: a
        clocked step synchronizes inside, so it runs uncaptured."""
        return self._clock

    @clock.setter
    def clock(self, clock: Optional[StageClock]) -> None:
        self._clock = clock
        self._decide_capture()

    def _decide_capture(self) -> None:
        reason = mesh_lib.capture_off_reason(self._mesh, self.device)
        if reason is None and self._clock is not None:
            reason = "the stage clock synchronizes inside the step"
        self.capture = reason is None
        self.capture_off_reason = reason

    def setup(self, inf, config):
        if self._mesh is None:
            self._mesh = mesh_lib.make_mesh(
                config.mesh_shape, axis_names=(config.mesh_axis,), device=self.device
            )
        # Split the variables over config.mesh_axis when the mesh has it;
        # else over its last (innermost) axis.
        self._axis = (
            config.mesh_axis if config.mesh_axis in self._mesh.axis_names
            else self._mesh.axis_names[-1]
        )
        self._decide_capture()
        super().setup(inf, config)
        if self._Af is not None:  # the factor dtype's copy: block 0's is the dense backend's
            (lo, hi, _), *rest = self._blocks[self._dtype]
            self._blocks[self._Af.dtype] = [(lo, hi, self._Af)] + [
                (lo_k, hi_k, A_k.to(self._Af.dtype)) for lo_k, hi_k, A_k in rest]
        self._cols = self._blocks[self._dtype][0][:2]

    def _place(self, A_host, dtype):
        """Every column block this process holds (one a position of the
        axis it executes: this rank's, or every member's on a local mesh),
        each on its member's device; returns the first."""
        width = A_host.shape[1] // self._mesh.shape[self._axis]
        self._blocks = {dtype: [
            (k * width, (k + 1) * width, torch.as_tensor(
                A_host[:, k * width:(k + 1) * width], dtype=dtype, device=dev).contiguous())
            for k, dev in self._mesh.axis_members(self._axis)]}
        return self._blocks[dtype][0][2]

    def _blocks_as(self, dtype) -> list:
        """The column blocks in ``dtype``, each cast once at its first use."""
        if dtype not in self._blocks:
            self._blocks[dtype] = [(lo, hi, A_k.to(dtype))
                                   for lo, hi, A_k in self._blocks[self._dtype]]
        return self._blocks[dtype]

    def _ensure_A32(self) -> torch.Tensor:
        if self._A32 is None:
            self._A32 = self._blocks_as(torch.float32)[0][2]
        return self._A32

    def _ensure_closure(self):
        """The closure's f32 factor of ``G = A·Aᵀ`` over the whole split
        A: K1 with d = 1 on each f32 block, one sum, then the dense
        backend's replicated factorization (the reference's
        ``_closure_from_G``)."""
        if self._closure is None:
            assemble, _, _ = split_ops(self._blocks_as, self._dtype, self._shape[1], self._mesh,
                                       self._axis)
            self._closure = _closure_factors(self._ensure_A32(), assemble, self._shape[1])
        return self._closure

    def pad_multiple(self) -> int:
        return self._mesh.shape[self._axis]

    def shardings(self, m: int, n: int) -> Tuple:
        return (
            mesh_lib.col_sharding(self._mesh, self._axis),
            mesh_lib.replicated(self._mesh),
            mesh_lib.replicated(self._mesh),
        )

    def prec_sharding(self) -> mesh_lib.Sharding:
        """The PCG preconditioner's ``L⁻¹`` split by columns over the
        variables' axis: each member builds and holds its (mp, w) slab
        (``ops/dist_chol.py``). Known from ``setup`` on."""
        if self._axis is None:
            raise RuntimeError("prec_sharding: the mesh axis is chosen in setup")
        return mesh_lib.col_sharding(self._mesh, self._axis)

    def _make_linops(self, reg, spec) -> core.LinOps:
        n, clock = self._shape[1], self.clock
        assemble, matvec, rmatvec = split_ops(self._blocks_as, self._dtype, n, self._mesh,
                                              self._axis, clock)
        if spec.cg_iters > 0:
            factorize, solve = sharded_pcg_ops(
                self._A, spec.Af, self._blocks_as, n, self._mesh, self.prec_sharding().axis,
                spec.cg_tol, spec.cg_iters, self._cg_counts, clock)
        else:
            factorize, solve = _cholesky_ops(self._A, spec.factor_dtype, spec.refine, spec.Af,
                                             assemble=assemble)
        project = None if spec.closure is None else _closure_project(
            self._A, spec.closure, spec.closure_sweeps, matvec, rmatvec)
        timed = _timed(clock)
        return core.LinOps(matvec=matvec, rmatvec=rmatvec,
                           factorize=lambda d: timed("factorize", factorize, d, reg),
                           solve=solve, primal_project=project)

    @property
    def mesh(self) -> Optional[mesh_lib.Mesh]:
        return self._mesh

    def reshard(self, mesh: mesh_lib.Mesh) -> "ShardedTorchBackend":
        """A fresh instance of this backend on ``mesh`` — the elastic
        recovery seam. Everything layout-dependent (the column padding,
        the blocks, the capture decision) is derived in ``setup`` and
        ``from_host`` from the mesh alone, so re-placement is
        re-construction; the supervisor resumes the IPM from the last
        host-canonical checkpoint, which ``from_host`` re-pads."""
        return type(self)(mesh=mesh, device=self.device, schedule_platform=self.schedule_platform)
