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
evenly divisible axis). :meth:`Mesh.row_blocks` splits m rows the JAX
package's ``ops/sparse.py::shard_rows`` way: ⌈m/R⌉ a member, contiguous,
the last block possibly shorter (the row-sharded matrix-free tier). :class:`Sharding` is the port of a
``NamedSharding``: a mesh plus the axis a dimension is split over, or
none (replicated); ``local`` cuts this rank's block out of a host array.

``make_mesh()`` with no ``torch.distributed`` world gives a world of one
over the process's device (the ``mpirun -np 1`` analogue). The one
collective is ``all_reduce`` (with ``broadcast``, the only two that gloo
carries for CUDA tensors); without a process group it is the identity.

A mesh has one of two kinds, and every member carries an id (the
``device_ids`` the supervisor and the fault injector name):

* a **process-group mesh** (above): one rank a member; its ids are the
  ranks of the ``torch.distributed`` world;
* a **local mesh** (``make_mesh(devices=[...])``): several devices of ONE
  process and no process group — the counterpart of the JAX package's
  single-process mesh over local devices (``ServiceConfig.mesh_devices``).
  On cards it names distinct cards (ids: the card indices); on the CPU it
  may name the CPU device K times (ids 0..K-1), the counterpart of the
  JAX harness's virtual host devices.

The batch axis (``batch_sharding``, :meth:`Mesh.lane_blocks`) gives each
member the contiguous block of lanes GSPMD gives a device on a
``PartitionSpec("batch")``. Each executor (a rank, or a device of a
local mesh) runs its own block; ``backends/batched.py`` gathers.

:func:`reform_mesh` is the elastic shrink: a local mesh drops the
excluded devices; a process-group mesh builds ``dist.new_group`` over the
surviving ranks — a collective of the whole world, so every rank enters
it in the same order, the excluded ranks too (an excluded rank gets a
mesh it is not a member of, and leaves).

No path of the port runs per-shard programs, so ``shard_map_compat`` has
no counterpart: each path holds its members' blocks as tensors and calls
the collectives itself, with the vectors replicated —
``backends/sharded.py``, ``ops/sparse.py::RowShardedOperator``, and the
block tier with its distributed linking factor (``ops/dist_chol.py``).
:meth:`Mesh.sum_parts` is the sum of the latter two: the members'
partials over an axis, an all-reduce on a process-group mesh and a sum
in member order on a local mesh; :meth:`Mesh.axis_members` says which
positions of an axis this process executes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """A mesh: ``shape`` over ``axis_names``, members laid out row-major
    (member i sits at ``np.unravel_index(i, shape)``).

    A process-group mesh has one device per rank: ``group`` is the
    ``torch.distributed`` process group of the whole mesh (None for a
    world of one), ``rank`` this process's position in it, ``ids`` the
    members' world ranks. A local mesh (``devices`` given) runs every
    member in this process: ``devices[i]`` is member i's device, ``ids``
    its device id, and ``device`` the first member's."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 device: torch.device, rank: int = 0, group=None,
                 pg_backend: Optional[str] = None, axis_groups=None,
                 devices: Optional[Sequence] = None, ids: Optional[Sequence[int]] = None,
                 member: bool = True):
        self.shape_tuple = tuple(int(k) for k in shape)
        self.axis_names = tuple(axis_names)
        self.device = torch.device(device)
        self.rank = int(rank)
        self.group = group
        self.pg_backend = pg_backend
        # axis name -> process group of the fiber along that axis holding
        # this rank (None: the whole mesh's group).
        self._axis_groups = dict(axis_groups or {})
        self.devices = None if devices is None else tuple(torch.device(d) for d in devices)
        self._ids = tuple(range(self.size)) if ids is None else tuple(int(i) for i in ids)
        # False on a rank that a reform excluded: it holds the survivors'
        # mesh but takes no part in it.
        self.member = bool(member)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape_tuple))

    @property
    def shape(self) -> dict:
        """Axis name -> extent, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.shape_tuple))

    @property
    def is_local(self) -> bool:
        """A mesh of this process's devices, with no process group."""
        return self.devices is not None

    @property
    def device_ids(self) -> Tuple[int, ...]:
        """The mesh's participants: world ranks, or a local mesh's device
        ids."""
        return self._ids

    @property
    def key(self) -> tuple:
        """Hashable identity of the mesh, for program and warm-cache keys:
        its kind, its members and their devices."""
        if self.is_local:
            return ("local", self._ids, tuple(str(d) for d in self.devices))
        return ("group", self.pg_backend, self._ids)

    @property
    def collective_device(self) -> torch.device:
        """Where this mesh's collectives take their buffers: the card
        under NCCL, else the host."""
        return self.device if self.pg_backend == "nccl" else torch.device("cpu")

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

    def row_blocks(self, m: int, axis: Optional[str] = None) -> list:
        """``[(device, lo, hi)]``: the row blocks of an m-row axis split
        over ``axis`` (default the innermost) that THIS process holds —
        every member's on a local mesh, this rank's on a process-group
        mesh. Member r owns ``[r·⌈m/R⌉, min((r+1)·⌈m/R⌉, m))``, the JAX
        package's ``shard_rows`` split; fewer rows than members raises
        ``ValueError``."""
        axis = axis or self.axis_names[-1]
        k = self.shape[axis]
        if m < k:
            raise ValueError(f"cannot shard {m} rows over {k} devices")
        per = -(-m // k)
        span = lambda i: (min(i * per, m), min((i + 1) * per, m))  # noqa: E731
        if self.is_local:
            if k != self.size:
                raise ValueError(f"a local mesh splits rows over all its {self.size} members, "
                                 f"not axis {axis!r} of {k}")
            return [(d, *span(i)) for i, d in enumerate(self.devices)]
        return [(self.device, *span(int(self.coords()[axis])))]

    def lane_blocks(self, batch: int, axis: str = "batch") -> list:
        """``[(device, lo, hi)]``: the lane blocks of a ``batch``-lane axis
        split over ``axis`` that THIS process executes — every member's on
        a local mesh, this rank's on a process-group mesh. A batch that
        does not divide the axis raises ``ValueError``."""
        name = axis if axis in self.axis_names else self.axis_names[-1]
        k = self.shape[name]
        if batch % k:
            raise ValueError(f"bucket batch {batch} not divisible by mesh axis {k}")
        w = batch // k
        if self.is_local:
            return [(d, i * w, (i + 1) * w) for i, d in enumerate(self.devices)]
        lo, hi = self.col_range(batch, name)
        return [(self.device, lo, hi)]

    def axis_members(self, axis: Optional[str] = None) -> list:
        """``[(i, device)]``: the positions along ``axis`` (default the
        innermost) that THIS process executes, each with its device. On a
        local mesh every position, on the device of the first member at it
        (members are row-major, so a position's replicas along the other
        axes are not run again); on a process-group mesh this rank's."""
        axis = axis or self.axis_names[-1]
        if not self.is_local:
            return [(int(self.coords()[axis]), self.device)]
        at = np.unravel_index(np.arange(self.size), self.shape_tuple)[self.axis_names.index(axis)]
        return [(i, self.devices[int(np.flatnonzero(at == i)[0])])
                for i in range(self.shape[axis])]

    # -- collectives --------------------------------------------------------
    def sum_parts(self, parts: Sequence[torch.Tensor], axis: Optional[str] = None) -> torch.Tensor:
        """The sum over ``axis``'s members of their partials, on this
        process's device: on a process-group mesh this rank's one part
        all-reduced (in place), on a local mesh the parts (one a position
        of :meth:`axis_members`) added in member order. Either way one call
        of :meth:`all_reduce`, the identity without a process group."""
        total = parts[0].to(self.device).contiguous()
        for p in parts[1:]:
            total = total + p.to(self.device)
        return self.all_reduce(total, axis)

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

    def barrier(self) -> None:
        """Wait for every member (a no-op without a process group): one
        all-reduce of one element, the collective every backend carries."""
        if self.group is None or self.size == 1:
            return
        t = self.all_reduce(torch.zeros(1, device=self.collective_device))
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)

    @property
    def is_primary(self) -> bool:
        """Whether this process is the mesh's first member (the one that
        writes a solve's checkpoint)."""
        return self.member and self.rank == 0

    def __repr__(self) -> str:
        if self.is_local:
            return f"Mesh(shape={self.shape}, devices={[str(d) for d in self.devices]})"
        return (f"Mesh(shape={self.shape}, rank={self.rank}, device={self.device}, "
                f"backend={self.pg_backend}, ranks={list(self._ids)})")


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
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A mesh over every rank of the ``torch.distributed`` world (a
    world of one over this process's device when there is none), or,
    with ``devices``, a local mesh over those devices of this process.

    ``shape=None`` is a 1-D mesh over every member, the ``mpirun -np N``
    analogue. A shape whose product is not the member count, or whose
    rank differs from ``axis_names``'s, raises ``ValueError`` (the JAX
    package's rule). ``device`` is this rank's device: by default the
    world's (``parallel.runtime.world_device``), else the first card."""
    if devices is not None:
        return _local_mesh(shape, axis_names, devices)
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


def _local_mesh(shape, axis_names, devices, ids=None) -> Mesh:
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a local mesh needs at least one device")
    kinds = {d.type for d in devs}
    if len(kinds) != 1:
        raise ValueError(f"a local mesh mixes device kinds {sorted(kinds)}")
    if kinds == {"cuda"}:
        devs = [torch.device("cuda", d.index if d.index is not None else 0) for d in devs]
        if len(set(devs)) != len(devs):
            raise ValueError(f"a local mesh over cards names each card once: {devs}")
    if shape is None:
        shape = (len(devs),)
    shape = tuple(int(k) for k in shape)
    if int(np.prod(shape)) != len(devs):
        raise ValueError(f"mesh shape {shape} != device count {len(devs)}")
    if len(shape) != len(tuple(axis_names)):
        raise ValueError(f"shape {shape} vs axis names {tuple(axis_names)}")
    if ids is None:
        ids = [d.index for d in devs] if kinds == {"cuda"} else range(len(devs))
    return Mesh(shape, tuple(axis_names), devs[0], devices=devs, ids=ids)


def local_devices(k: int, device=None) -> list:
    """``k`` devices of this process for a local batch mesh: the first k
    cards (raising, with the JAX package's message, when there are fewer),
    or on the CPU the CPU device k times. ``device`` picks the kind (the
    card unless it names the CPU)."""
    from distributedlpsolver_tpu_torch.backends.dense import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * k
    n = torch.cuda.device_count()
    if k > n:
        raise ValueError(f"mesh_devices={k} but only {n} local devices are present")
    return [torch.device("cuda", i) for i in range(k)]


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
    """Re-form ``mesh`` over its surviving members (elastic recovery).

    ``exclude`` lists lost participants by id (``Mesh.device_ids``: world
    ranks, or a local mesh's device ids; objects with an ``id`` are read
    by it). The survivors keep their order and become a 1-D mesh named
    ``axis_name`` (default: the old mesh's innermost axis), so a 2-D mesh
    collapses to 1-D, as in the JAX package. An empty survivor set raises
    ``ValueError``.

    A local mesh drops the excluded devices. A process-group mesh builds
    ``dist.new_group(survivors)``: a collective of the whole world, which
    every rank calls in the same order, the excluded ranks too; on an
    excluded rank the result has ``member`` False. Only a mesh over the
    whole world re-forms this way — the ranks a shrink excluded have left,
    so they cannot enter a second ``new_group`` (``ValueError``)."""
    exclude_ids = {int(getattr(d, "id", d)) for d in exclude}
    name = axis_name or mesh.axis_names[-1]
    keep = [i for i, d in enumerate(mesh.device_ids) if d not in exclude_ids]
    if not keep:
        raise ValueError(f"reform_mesh: excluding {sorted(exclude_ids)} leaves no devices")
    survivors = [mesh.device_ids[i] for i in keep]
    if mesh.is_local:
        return _local_mesh(None, (name,), [mesh.devices[i] for i in keep], ids=survivors)
    if mesh.group is None:  # a world of one with no process group
        return Mesh((1,), (name,), mesh.device, pg_backend=mesh.pg_backend)
    import torch.distributed as dist

    if mesh.size != dist.get_world_size():
        raise ValueError(
            f"reform_mesh: the mesh holds {mesh.size} of the world's {dist.get_world_size()} "
            "ranks; ranks that left cannot enter the collective new_group")
    me = dist.get_rank()
    group = dist.new_group(survivors)
    member = me in survivors
    return Mesh((len(survivors),), (name,), mesh.device,
                rank=survivors.index(me) if member else 0,
                group=group if member else None, pg_backend=mesh.pg_backend,
                ids=survivors, member=member)


def shard_map_compat(f, mesh: Mesh, in_specs, out_specs):
    raise NotImplementedError(
        "shard_map_compat (per-shard programs) has no counterpart in the torch package: no "
        "path of it runs one; each mesh path holds its members' blocks as tensors and calls "
        "the collectives itself (Mesh.sum_parts), the block tier's distributed linking "
        "Cholesky (ops/dist_chol.py) included"
    )


def capture_off_reason(mesh: Optional[Mesh], device) -> Optional[str]:
    """Why a fused loop whose step sums over ``mesh`` cannot be captured
    into a CUDA graph on ``device``, or None when it can: gloo's
    collectives cannot be captured, and a local mesh over several cards
    copies between them inside the step."""
    if mesh is None or torch.device(device).type != "cuda":
        return None
    if not mesh.is_local and mesh.pg_backend == "gloo":
        return "gloo collectives cannot be captured into a CUDA graph"
    if mesh.is_local and len(set(mesh.devices)) > 1:
        return "a local mesh over several cards copies between them inside the step"
    return None


def is_multiprocess(mesh: Optional[Mesh]) -> bool:
    """True iff ``mesh`` spans more than one process."""
    return mesh is not None and not mesh.is_local and mesh.size > 1


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


def batch_sharding(mesh: Mesh, ndim: int, axis: str = "batch") -> Sharding:
    """Leading-axis placement of an ``ndim``-dim array: the batch axis
    split over ``axis`` in contiguous blocks, the trailing dims whole —
    the data-parallel placement of the batched and serving paths
    (``Mesh.lane_blocks`` gives each executor's block)."""
    return Sharding(mesh, axis, dim=0)


def col_sharding(mesh: Mesh, axis: str = "cols") -> Sharding:
    """(m, n) matrix split along its variable (column) dimension."""
    return Sharding(mesh, axis, dim=1)


def vec_sharding(mesh: Mesh, axis: str = "cols") -> Sharding:
    """(n,) vector split along the same variable axis."""
    return Sharding(mesh, axis, dim=0)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)
