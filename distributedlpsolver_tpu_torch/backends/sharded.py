"""Distributed backend: the constraint matrix split by columns over a
process-group mesh.

The port of the JAX package's ``backends/sharded.py`` — the north-star
distributed path (BASELINE.json:5): the reference row-partitions the
constraint matrix across MPI ranks and all-reduces the per-rank Schur
contributions every iteration. Each rank of the mesh
(``parallel/mesh.py``) holds the column block ``A_k`` (m × n/K, on its
device); ``M = Σ_k A_k·diag(d_k)·A_kᵀ`` is K1 on the block plus one
all-reduce — the reference's ``MPI_Allreduce`` of Schur blocks, called
by hand where the JAX package lets GSPMD insert it.

The collectives live inside the step's ``core.LinOps`` and nowhere else,
so ``core.mehrotra_step`` stays the one step every backend runs:

* ``factorize(d)``: K1 on ``(A_k, d[cols_k])``, ``all_reduce`` of M,
  the relative regularization, and ``cholesky_ex`` on every rank
  (replicated, as in the JAX package and the reference);
* ``matvec(v)`` = ``all_reduce(A_k @ v[cols_k])``;
* ``rmatvec(y)``: each rank writes ``A_kᵀ·y`` into its slot of a zeroed
  (n,) vector, then ``all_reduce`` — a sum with zeros is exact, so the
  slots keep their bits.

Placement differs from the JAX package on purpose: c, b, u and the
iterate x, s, w, z, y stay REPLICATED (O(n) a rank against A_k's
O(m·n/K)), so none of the step's reductions (ratio tests, μ, the norms)
needs a collective. A collective hands every rank the same bits, so
every rank holds the same iterate and takes the same branches (status,
stall, regularization) with no extra collective.

The fused loop: NCCL collectives are captured into the loop's CUDA graph;
gloo's cannot be, so a gloo world on a card runs the loop uncaptured
(``phase_report`` rows say ``captured: False`` with the reason). A
failed collective or kernel raises.

Setting ``clock`` to a :class:`StageClock` times each factorization's
parts (K1 on the block, the all-reduce, the rest of the factorization —
the Cholesky) and the matvecs' all-reduces on the host clock,
synchronizing the device around each: for measurement runs only (it
turns capture off while it is set).

:meth:`ShardedTorchBackend.reshard` is the elastic shrink's seam: a fresh
instance on the re-formed mesh (``parallel.mesh.reform_mesh``), whose
``setup`` pads the columns to the new mesh's multiple and whose
``from_host`` re-pads the host-canonical checkpoint onto the new column
blocks; the supervisor resumes from it.

``schedule_platform="tpu"`` is the dense backend's parity seam (see
``backends/dense.py``): the reference's TPU schedule on the mesh, whose
two-phase direct plan runs phase 1 with K1 in f32 on each rank's f32
copy of its block and the same all-reduce of M.

Not ported yet: the PCG schedule on a mesh (``solve_mode="pcg"`` raises
in ``setup``, and so does the automatic PCG of a two-phase schedule
under ``schedule_platform="tpu"``; its column-sharded preconditioner
``prec_sharding``, the reference's ``_tri_inv_mesh`` and the distributed
Cholesky under it, ROADMAP Queue 1 item 5b). The dense backend runs that
schedule on one device.
"""

from __future__ import annotations

import collections
import time
from typing import Optional, Tuple

import torch

from distributedlpsolver_tpu_torch.backends.base import register_backend
from distributedlpsolver_tpu_torch.backends.dense import DenseTorchBackend, _cholesky_ops
from distributedlpsolver_tpu_torch.ipm import core
from distributedlpsolver_tpu_torch.ops.normal_eq import normal_eq
from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib
from distributedlpsolver_tpu_torch.parallel import runtime


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


def sharded_ops(A_k, lo, hi, n, mesh, reg, factor_dtype, refine_steps, Af_k=None,
                axis=None, clock: Optional[StageClock] = None) -> core.LinOps:
    """The step's ``LinOps`` on rank k of ``mesh``: ``A_k`` holds columns
    ``[lo, hi)`` of the n-wide (padded) matrix; every vector is
    replicated (see the module note)."""

    def timed(name, fn, *args):
        return fn(*args) if clock is None else clock.span(name, fn, *args)

    def reduce(t, name):
        return timed(name, mesh.all_reduce, t, axis)

    def assemble(src, d):
        M = timed("k1", normal_eq, src, d[lo:hi])
        return reduce(M, "allreduce_M")

    factorize, solve = _cholesky_ops(A_k, factor_dtype, refine_steps, Af_k, assemble=assemble)

    def factorize_at(d):
        return timed("factorize", factorize, d, reg)

    def matvec(v):
        return reduce(A_k @ v[lo:hi], "allreduce_vec")

    def rmatvec(y):
        out = torch.zeros(n, dtype=y.dtype, device=y.device)
        out[lo:hi] = A_k.T @ y
        return reduce(out, "allreduce_vec")

    return core.LinOps(matvec=matvec, rmatvec=rmatvec, factorize=factorize_at, solve=solve)


@register_backend("sharded", "tpu-sharded", "mesh")
class ShardedTorchBackend(DenseTorchBackend):
    """The dense backend's step over a column-split mesh: same
    ``core.mehrotra_step``, the collectives in its ``LinOps``.

    ``mesh`` defaults to :func:`parallel.mesh.make_mesh` of
    ``SolverConfig.mesh_shape`` over ``mesh_axis`` at setup: every rank of
    the ``torch.distributed`` world, or a world of one without one.
    ``device`` defaults to the mesh's (the world's) device."""

    def __init__(self, mesh: Optional[mesh_lib.Mesh] = None, device=None,
                 schedule_platform: Optional[str] = None):
        if device is None:
            device = mesh.device if mesh is not None else runtime.world_device()
        super().__init__(device, schedule_platform)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"mesh device {mesh.device} != backend device {self.device}")
        self._mesh = mesh
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
        if config.solve_mode == "pcg":
            raise NotImplementedError(
                "solve_mode='pcg' on the sharded backend (the column-sharded preconditioner, "
                "prec_sharding) is not ported to the torch package yet (ROADMAP Queue 1 item 5b)"
            )
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
        if self._pcg:  # the automatic PCG of a two-phase schedule
            raise NotImplementedError(
                "PCG on the sharded backend (the column-sharded preconditioner, prec_sharding), "
                "which the two-phase schedule engages at this size, is not ported to the torch "
                "package yet (ROADMAP Queue 1 item 5b)"
            )
        m, n = self._shape
        self._cols = self._mesh.col_range(n, self._axis)

    def pad_multiple(self) -> int:
        return self._mesh.shape[self._axis]

    def shardings(self, m: int, n: int) -> Tuple:
        return (
            mesh_lib.col_sharding(self._mesh, self._axis),
            mesh_lib.replicated(self._mesh),
            mesh_lib.replicated(self._mesh),
        )

    def _make_linops(self, reg, spec) -> core.LinOps:
        lo, hi = self._cols
        return sharded_ops(self._A, lo, hi, self._shape[1], self._mesh, reg, spec.factor_dtype,
                           spec.refine, spec.Af, axis=self._axis, clock=self.clock)

    def prec_sharding(self):
        raise NotImplementedError(
            "prec_sharding (the column-sharded PCG preconditioner) is not ported to the "
            "torch package yet (ROADMAP Queue 1 item 5b)"
        )

    @property
    def mesh(self) -> Optional[mesh_lib.Mesh]:
        return self._mesh

    def reshard(self, mesh: mesh_lib.Mesh) -> "ShardedTorchBackend":
        """A fresh instance of this backend on ``mesh`` — the elastic
        recovery seam. Everything layout-dependent (the column padding,
        the block, the capture decision) is derived in ``setup`` and
        ``from_host`` from the mesh alone, so re-placement is
        re-construction; the supervisor resumes the IPM from the last
        host-canonical checkpoint, which ``from_host`` re-pads."""
        return type(self)(mesh=mesh, device=self.device, schedule_platform=self.schedule_platform)
