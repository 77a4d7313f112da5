"""The port's block-angular tier on a mesh (``BlockAngularBackend(mesh=)``)
against the JAX package's, on the CPU: twins of the mesh cases of the JAX
package's ``tests/test_block_angular.py`` and ``tests/test_parallel.py``.

The JAX package shards the K axis over a mesh of the harness's virtual
devices and factors the link×link Schur complement with
``chol_tri_inv_mesh``; the port splits the blocks over a local mesh that
names the CPU device K times, each member its K/R blocks, and factors
the linking system with its own ``chol_tri_inv_mesh`` (``ops/dist_chol.py``).
Held: the JAX mesh solve's status and iterations and its objective within
1e-8 — K = 8 on widths 2 and 4, the ragged K = 6 over 8 and K = 5 over 4,
3 and 2 (dead blocks), the hybrid (2, 4) mesh with the blocks on its outer
axis; the mesh ``LinOps`` against the JAX ``_block_ops(link_shard=)`` at
seeded vectors (≤ 1e-12); the collectives a factorization, a Newton solve
and a product, counted through ``Mesh.all_reduce`` (the reference's HLO
``all-reduce`` check); ``reshard``; ``SolverConfig(mesh_shape=)`` solved
unsharded, as the reference does. The gloo world is in
``test_torch_block_world.py``, the shrink in ``test_torch_shrink.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from distributedlpsolver_tpu.backends import block_angular as jba
from distributedlpsolver_tpu.ipm import solve as jax_solve
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.models.problem import to_interior_form as jax_interior
from distributedlpsolver_tpu.parallel import mesh as jmesh_lib
from distributedlpsolver_tpu_torch.backends import block_angular as tba
from distributedlpsolver_tpu_torch.ipm import solve
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.models import generators as tgen
from distributedlpsolver_tpu_torch.models.problem import to_interior_form
from distributedlpsolver_tpu_torch.ops import dist_chol
from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"
OBJ_TOL = 1e-8
OPS_TOL = 1e-12
# (generator args, seed) of the reference's mesh cases: K = 8
# (test_block_sharded_over_mesh), the ragged K = 6 over 8
# (test_block_mesh_ragged_tail_accepts_indivisible_K), K = 5 over 4, 3, 2,
# and the hybrid mesh's (test_parallel.py).
K8 = ((8, 10, 24, 6), 3)
K6 = ((6, 8, 16, 4), 0)
K5 = ((5, 8, 20, 5), 1)
HYBRID = ((4, 10, 24, 6), 2)


def _mesh(width):
    return mesh_lib.make_mesh(axis_names=("blocks",), devices=[CPU] * width)


def _hybrid():
    return mesh_lib.make_mesh((2, 4), axis_names=("hosts", "cols"), devices=[CPU] * 8)


def _jmesh(width):
    if width == "hybrid":
        return jmesh_lib.make_hybrid_mesh(ici_parallelism=4, dcn_parallelism=2)
    return jmesh_lib.make_mesh((width,), axis_names=("blocks",), devices=jax.devices()[:width])


def _problem(case):
    args, seed = case
    return tgen.block_angular_lp(*args, seed=seed, sparse=False)


@functools.lru_cache(maxsize=None)
def _jax_mesh_solve(case, width):
    """The JAX package's mesh solve, shared by the tests (each JAX mesh
    program compiles for a few seconds)."""
    args, seed = case
    be = jba.BlockAngularBackend(mesh=_jmesh(width))
    r = jax_solve(jgen.block_angular_lp(*args, seed=seed, sparse=False), backend=be, tol=1e-8)
    return r, be._lay.K


def _close(a, b, tol=OBJ_TOL):
    return abs(a - b) <= tol * (1.0 + abs(b))


@pytest.mark.parametrize("case,width", [(K8, 2), (K8, 4), (K6, 8), (K5, 4), (K5, 3), (K5, 2),
                                        (HYBRID, "hybrid")],
                         ids=["K8-2way", "K8-4way", "K6-8way", "K5-4way", "K5-3way", "K5-2way",
                              "hybrid-2x4"])
def test_matches_the_jax_mesh_solve(case, width):
    rj, K_jax = _jax_mesh_solve(case, width)
    be = tba.BlockAngularBackend(mesh=_hybrid() if width == "hybrid" else _mesh(width))
    r = solve(_problem(case), backend=be, tol=1e-8)
    assert r.status.value == rj.status.value == "optimal"
    assert r.iterations == rj.iterations
    assert _close(r.objective, rj.objective)
    assert be.layout.K == K_jax  # the dead blocks the reference pads with
    assert r.backend == "block" and be.phase_report[0]["captured"] is True


def test_members_hold_their_blocks_and_the_border_once():
    """K = 6 over 4: padded to 8 (two dead blocks on the last member), two
    blocks a member, the border's columns on member 0 alone; the dead
    blocks' maps are all sentinel and their pad diagonal all ones."""
    be = tba.BlockAngularBackend(mesh=_mesh(4))
    be.setup(to_interior_form(_problem(K6)), SolverConfig())
    K, mb, nb, link, n0, n, m = be.layout
    assert K == 8
    assert [tuple(t.B_all.shape) for t in be._parts] == [(2, mb, nb)] * 4
    assert [t.L_cat.shape[1] for t in be._parts] == [2 * nb + n0] + [2 * nb] * 3
    assert [t.border_idx.numel() for t in be._parts] == [n0, 0, 0, 0]
    dead = be._parts[3]
    assert bool((dead.col_idx == n).all() and (dead.row_idx == m).all())
    assert bool((dead.pad_diag == 1).all() and (dead.B_all == 0).all())
    # Every interior column and row is owned by exactly one member.
    cols = sorted(int(c) for t in be._parts for c in t.cat_idx if c < n)
    rows = sorted(int(i) for t in be._parts for i in t.row_idx.ravel() if i < m)
    assert cols == list(range(n)) and len(rows) == m - link


@pytest.mark.parametrize("width", [2, 4])
def test_linops_match_the_jax_link_shard_ops(width):
    it = to_interior_form(tgen.block_angular_lp(6, 10, 24, 6, seed=4, sparse=True, density=0.3))
    ij = jax_interior(jgen.block_angular_lp(6, 10, 24, 6, seed=4, sparse=True, density=0.3))
    be = tba.BlockAngularBackend(mesh=_mesh(width))
    be.setup(it, SolverConfig())
    lay = be.layout
    jt, jlay = jba.build_tensors(ij, np.float64, pad_blocks=lay.K - 6)
    assert tuple(jlay) == tuple(lay)
    jmesh = _jmesh(width)
    reg = 1e-9
    jops = jba._block_ops(jt, jlay, jnp.asarray(reg), jnp.float64,
                          link_shard=NamedSharding(jmesh, PartitionSpec(None, "blocks")))
    ops = be._make_ops(reg)
    rng = np.random.default_rng(11)
    x, y = rng.standard_normal(lay.n), rng.standard_normal(lay.m)
    d, r = np.exp(rng.uniform(-4, 4, lay.n)), rng.standard_normal(lay.m)

    def close(a, b):
        a, b = np.asarray(a), np.asarray(b)
        assert np.linalg.norm(a - b) <= OPS_TOL * np.linalg.norm(b), (
            np.linalg.norm(a - b) / np.linalg.norm(b))

    tt = lambda v: torch.as_tensor(v, dtype=torch.float64)  # noqa: E731
    close(ops.matvec(tt(x)).numpy(), jops.matvec(jnp.asarray(x)))
    close(ops.rmatvec(tt(y)).numpy(), jops.rmatvec(jnp.asarray(y)))
    fac = ops.factorize(tt(d))
    jfac = jops.factorize(jnp.asarray(d))
    jLk, jLinv, jGk = (np.asarray(f) for f in jfac)
    blocks, inv = fac
    close(torch.cat([Lk for Lk, _ in blocks]).numpy(), jLk)
    close(torch.cat([GT for _, GT in blocks]).numpy().transpose(0, 2, 1), jGk)
    close(torch.cat(list(inv.slabs), dim=1)[: lay.link, : lay.link].numpy(), jLinv)
    close(ops.solve(fac, tt(r)).numpy(), jops.solve(jfac, jnp.asarray(r)))


def test_collectives_a_factorization_a_solve_and_a_product(monkeypatch):
    """One sum of S over the block axis and 2·P panel sums a
    factorization; four a Newton solve; one a product — each a call of
    ``Mesh.all_reduce`` (on a local mesh the identity after the sum in
    member order), the reference's HLO all-reduce check."""
    calls = []
    real = mesh_lib.Mesh.all_reduce

    def counted(self, t, axis=None):
        calls.append((axis, tuple(t.shape)))
        return real(self, t, axis)

    monkeypatch.setattr(mesh_lib.Mesh, "all_reduce", counted)
    panels = []
    for width, panel in ((2, 256), (2, 2), (4, 256)):
        be = tba.BlockAngularBackend(mesh=_mesh(width))
        be.link_panel = panel
        be.setup(to_interior_form(_problem(K8)), SolverConfig())
        link = be.layout.link
        P = dist_chol.slab_plan(link, width, panel)[3]
        panels.append(P)
        ops = be._ops()
        d = torch.ones(be.layout.n, dtype=torch.float64)
        calls.clear()
        fac = ops.factorize(d)
        assert len(calls) == 1 + 2 * P, (width, panel, calls)
        assert calls[0] == ("blocks", (link, link))
        calls.clear()
        ops.solve(fac, torch.ones(be.layout.m, dtype=torch.float64))
        assert len(calls) == 4
        calls.clear()
        ops.matvec(d)
        ops.rmatvec(torch.ones(be.layout.m, dtype=torch.float64))
        assert len(calls) == 2
    assert panels == [2, 4, 4]  # link 6: pb 3, then 2 over 2 members; pb 2 over 4


def test_a_world_of_one_is_the_local_mesh_of_one():
    """What the card's NCCL world of one is held to: the same code on a
    process-group mesh of one (its all-reduces the identity) and on a local
    mesh of one gives the same bits."""
    world = mesh_lib.make_mesh(axis_names=("blocks",), device=CPU)
    a = solve(_problem(K8), backend=tba.BlockAngularBackend(mesh=world), tol=1e-8)
    b = solve(_problem(K8), backend=tba.BlockAngularBackend(mesh=_mesh(1)), tol=1e-8)
    assert a.status.value == "optimal" and np.array_equal(a.x, b.x)
    assert a.iterations == b.iterations


def test_reshard_to_width_3_solves():
    be = tba.BlockAngularBackend(mesh=_mesh(4))
    new = be.reshard(_mesh(3))
    assert isinstance(new, tba.BlockAngularBackend) and new is not be
    assert new.mesh.size == 3 and new.device.type == "cpu"
    r = solve(_problem(K8), backend=new, tol=1e-8)
    rj, _ = _jax_mesh_solve(K8, 4)
    assert r.status.value == "optimal" and new.layout.K == 9
    assert _close(r.objective, rj.objective)


def test_mesh_shape_solves_unsharded_as_the_reference():
    """The reference's setup never reads ``config.mesh_shape``: a config
    with it solves on one device, in both packages."""
    args = (3, 6, 12, 3)
    rj = jax_solve(jgen.block_angular_lp(*args, seed=0, sparse=False), backend="block",
                   mesh_shape=(2,))
    be = tba.BlockAngularBackend(device=CPU)
    r = solve(tgen.block_angular_lp(*args, seed=0, sparse=False), backend=be, mesh_shape=(2,))
    assert be.mesh is None
    assert r.status.value == rj.status.value == "optimal"
    assert r.iterations == rj.iterations
    assert _close(r.objective, rj.objective)

