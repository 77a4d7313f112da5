"""Process-group meshes — the communication layer of the port.

The counterpart of the JAX package's ``parallel/mesh.py``. There, a mesh
is a ``jax.sharding.Mesh`` over the devices of every process, arrays
carry ``NamedSharding`` placements, and GSPMD inserts the all-reduce
that ``(A_sharded * d) @ A_sharded.T`` needs. Torch has no GSPMD: here a
:class:`Mesh` is a ``torch.distributed`` world of processes, one device
each (torch's idiom), laid out in a shape with named axes, and a backend
calls the collectives itself (``backends/sharded.py`` does so inside its
``LinOps``, nowhere else).

A mesh knows its ranks, shape and axis names, this rank's device and
coordinates, and this rank's column range for a given n (the contiguous
block GSPMD gives a device on a ``PartitionSpec(None, axis)`` of an
evenly divisible axis). :class:`Sharding` is the port of a
``NamedSharding``: a mesh plus the axis a dimension is split over, or
none (replicated); ``local`` cuts this rank's block out of a host array.

``make_mesh()`` with no ``torch.distributed`` world gives a world of one
over the process's device (the ``mpirun -np 1`` analogue). The one
collective is ``all_reduce`` (with ``broadcast``, the only two that gloo
carries for CUDA tensors); without a process group it is the identity.

Not ported yet (ROADMAP Queue 1 item 13b): ``reform_mesh`` and
``shard_map_compat`` (the elastic shrink and the batch-axis mesh).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """A process-group mesh: ``shape`` over ``axis_names``, one device per
    rank, ranks laid out row-major (rank r sits at ``np.unravel_index(r,
    shape)``). ``group`` is the ``torch.distributed`` process group of the
    whole mesh, or None for a world of one with no process group."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 device: torch.device, rank: int = 0, group=None,
                 pg_backend: Optional[str] = None, axis_groups=None):
        self.shape_tuple = tuple(int(k) for k in shape)
        self.axis_names = tuple(axis_names)
        self.device = torch.device(device)
        self.rank = int(rank)
        self.group = group
        self.pg_backend = pg_backend
        # axis name -> process group of the fiber along that axis holding
        # this rank (None: the whole mesh's group).
        self._axis_groups = dict(axis_groups or {})

    @property
    def size(self) -> int:
        return int(np.prod(self.shape_tuple))

    @property
    def shape(self) -> dict:
        """Axis name -> extent, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.shape_tuple))

    @property
    def device_ids(self) -> Tuple[int, ...]:
        """The mesh's participants: its ranks (one device each)."""
        return tuple(range(self.size))

    def coords(self) -> dict:
        """This rank's coordinate on each axis."""
        return dict(zip(self.axis_names, np.unravel_index(self.rank, self.shape_tuple)))

    def col_range(self, n: int, axis: Optional[str] = None) -> Tuple[int, int]:
        """This rank's columns ``[lo, hi)`` of an n-wide axis split evenly
        over ``axis`` (default the innermost); n must divide evenly (the
        backend pads it to :meth:`shape`'s extent first)."""
        axis = axis or self.axis_names[-1]
        k = self.shape[axis]
        if n % k:
            raise ValueError(f"{n} columns do not split evenly over {k} shards of axis {axis!r}")
        w = n // k
        i = int(self.coords()[axis])
        return i * w, (i + 1) * w

    # -- collectives --------------------------------------------------------
    def _group(self, axis: Optional[str]):
        if axis is None or len(self.axis_names) == 1:
            return self.group
        return self._axis_groups[axis]

    def all_reduce(self, t: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """Sum ``t`` in place over the ranks of ``axis``'s fiber (the
        whole mesh when None) and return it. Every rank gets the same
        bits: the collective reduces each element once and hands the sum
        to all."""
        if self.group is not None:
            import torch.distributed as dist

            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self._group(axis))
        return t

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, rank={self.rank}, device={self.device}, "
                f"backend={self.pg_backend})")


class Sharding(NamedTuple):
    """The port of a ``NamedSharding``: dimension ``dim`` of an array is
    split over mesh axis ``axis``, or the array is replicated when
    ``axis`` is None."""

    mesh: Mesh
    axis: Optional[str]
    dim: int = 0

    def local(self, arr):
        """This rank's block of the host array ``arr`` (all of it when
        replicated)."""
        if self.axis is None:
            return arr
        lo, hi = self.mesh.col_range(arr.shape[self.dim], self.axis)
        index = [slice(None)] * arr.ndim
        index[self.dim] = slice(lo, hi)
        return arr[tuple(index)]


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("cols",),
    device=None,
) -> Mesh:
    """A mesh over every rank of the ``torch.distributed`` world (a
    world of one over this process's device when there is none).

    ``shape=None`` is a 1-D mesh over every rank, the ``mpirun -np N``
    analogue. A shape whose product is not the world size, or whose rank
    differs from ``axis_names``'s, raises ``ValueError`` (the JAX
    package's rule). ``device`` is this rank's device: by default the
    world's (``parallel.runtime.world_device``), else the first card."""
    import torch.distributed as dist

    from distributedlpsolver_tpu_torch.parallel import runtime

    if dist.is_available() and dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        group, pg_backend = dist.group.WORLD, str(dist.get_backend())
    else:
        size, rank, group, pg_backend = 1, 0, None, None
    if shape is None:
        shape = (size,)
    shape = tuple(int(k) for k in shape)
    if int(np.prod(shape)) != size:
        raise ValueError(f"mesh shape {shape} != device count {size}")
    if len(shape) != len(tuple(axis_names)):
        raise ValueError(f"shape {shape} vs axis names {tuple(axis_names)}")
    dev = runtime.world_device(device)
    axis_groups = {}
    if group is not None and len(shape) > 1:
        # One process group per fiber of each axis. Every rank creates
        # every group, in the same order (new_group is collective).
        grid = np.arange(size).reshape(shape)
        for a, name in enumerate(axis_names):
            fibers = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
            for fiber in fibers:
                g = dist.new_group([int(r) for r in fiber])
                if rank in fiber:
                    axis_groups[name] = g
    return Mesh(shape, tuple(axis_names), dev, rank=rank, group=group,
                pg_backend=pg_backend, axis_groups=axis_groups)


def make_hybrid_mesh(
    ici_parallelism: int,
    dcn_parallelism: int = 1,
    axis_names: Sequence[str] = ("hosts", "cols"),
) -> Mesh:
    """The JAX package's ICI×DCN mesh, shape ``(dcn, ici)``: the inner
    axis carries the per-iteration Schur all-reduce. A torch world has
    one kind of link per process group, so this is :func:`make_mesh` of
    that shape."""
    return make_mesh((dcn_parallelism, ici_parallelism), axis_names)


def reform_mesh(mesh: Mesh, exclude: Sequence = (), axis_name: Optional[str] = None) -> Mesh:
    raise NotImplementedError(
        "reform_mesh (the elastic shrink of a mesh) is not ported to the torch "
        "package yet (ROADMAP Queue 1 item 13b)"
    )


def shard_map_compat(f, mesh: Mesh, in_specs, out_specs):
    raise NotImplementedError(
        "shard_map_compat (per-shard programs over a batch-axis mesh) is not ported "
        "to the torch package yet (ROADMAP Queue 1 item 13b)"
    )


def is_multiprocess(mesh: Optional[Mesh]) -> bool:
    """True iff ``mesh`` spans more than one process."""
    return mesh is not None and mesh.size > 1


def host_values(arrays: Sequence) -> list:
    """Host numpy copies of a batch of arrays or tensors. The port keeps
    every vector it hands back replicated on each rank, so a fetch needs
    no collective."""
    out = []
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        out.append(np.asarray(a))
    return out


def host_value(arr):
    """:func:`host_values` of one array."""
    return host_values([arr])[0]


def col_sharding(mesh: Mesh, axis: str = "cols") -> Sharding:
    """(m, n) matrix split along its variable (column) dimension."""
    return Sharding(mesh, axis, dim=1)


def vec_sharding(mesh: Mesh, axis: str = "cols") -> Sharding:
    """(n,) vector split along the same variable axis."""
    return Sharding(mesh, axis, dim=0)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)
