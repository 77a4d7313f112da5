"""The port's distributed linking Cholesky (``ops/dist_chol.py::
chol_tri_inv_mesh``) against the JAX package's, on the CPU: the twin of
the JAX package's ``tests/test_dist_chol.py`` accuracy cases.

The JAX package splits L⁻¹ by columns over a mesh of the harness's
virtual devices inside ``shard_map``; the port over a local mesh that
names the CPU device K times, each member a (mp, w) column slab of its
own. Held, at the reference's four ``(m, panel, dtype, tol)`` cases on
widths 2, 4 and 8: both packages within ``tol`` of ``inv(cholesky)`` and
of each other, every slab (mp, w) with the reference's padding rules,
and the slab products (``apply``, ``apply_t``) against L⁻¹·v and L⁻ᵀ·u.
A process-group mesh with no process group (a world of one) gives the
local mesh of one's bits, and a failed panel factor gives NaN.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from distributedlpsolver_tpu.ops.dist_chol import chol_tri_inv_mesh as jax_chol_tri_inv_mesh
from distributedlpsolver_tpu.parallel import mesh as jmesh_lib
from distributedlpsolver_tpu_torch.ops import dist_chol
from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# The reference's cases (tests/test_dist_chol.py): divisible, ragged (the
# slab padded to a panel multiple), f32, and one column a member.
CASES = [(96, 8, "float64", 1e-12), (130, 16, "float64", 1e-12), (200, 32, "float32", 5e-6),
         (8, 4, "float64", 1e-12)]
WIDTHS = (2, 4, 8)


def _spd(m, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((m, m))
    return G @ G.T + m * np.eye(m)


def _mesh(width):
    return mesh_lib.make_mesh(axis_names=("cols",), devices=["cpu"] * width)


@functools.lru_cache(maxsize=None)
def _jax_inv(m, panel, dtype, width):
    mesh = jmesh_lib.make_mesh((width,), axis_names=("cols",), devices=jax.devices()[:width])
    sh = NamedSharding(mesh, PartitionSpec(None, "cols"))
    return np.asarray(jax.jit(lambda M: jax_chol_tri_inv_mesh(M, sh, panel=panel))(
        jnp.asarray(_spd(m), getattr(jnp, dtype))))


def _whole(inv):
    return torch.cat(list(inv.slabs), dim=1)[: inv.m, : inv.m].numpy()


def _err(a, b):
    return np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max()


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("m,panel,dtype,tol", CASES)
def test_matches_inverse_cholesky_and_the_jax_package(m, panel, dtype, tol, width):
    Ms = _spd(m)
    ref = np.linalg.inv(np.linalg.cholesky(Ms))
    inv = dist_chol.chol_tri_inv_mesh(torch.as_tensor(Ms, dtype=getattr(torch, dtype)),
                                      _mesh(width), panel=panel)
    pb, w, mp, P = dist_chol.slab_plan(m, width, panel)
    assert (inv.m, inv.mp, inv.w) == (m, mp, w) and mp == w * width and w % pb == 0
    assert inv.cols == tuple(k * w for k in range(width))
    assert all(tuple(S.shape) == (mp, w) for S in inv.slabs)
    got = _whole(inv)
    assert _err(got, ref) < tol
    jgot = _jax_inv(m, panel, dtype, width)
    assert _err(jgot, ref) < tol
    assert _err(got, jgot) < tol
    # The identity tail past m is inert.
    tail = torch.cat(list(inv.slabs), dim=1)[m:, m:].numpy()
    assert np.array_equal(tail, np.eye(mp - m))


@pytest.mark.parametrize("width", [1, 3])
def test_slab_products(width):
    m = 130
    Ms = _spd(m, seed=2)
    inv = dist_chol.chol_tri_inv_mesh(torch.as_tensor(Ms), _mesh(width), panel=16)
    Linv = np.linalg.inv(np.linalg.cholesky(Ms))
    rng = np.random.default_rng(3)
    v, u = rng.standard_normal(m), rng.standard_normal(m)
    mesh = _mesh(width)
    got = dist_chol.apply(inv, torch.as_tensor(v), mesh).numpy()
    got_t = dist_chol.apply_t(inv, torch.as_tensor(u), mesh).numpy()
    assert np.linalg.norm(got - Linv @ v) <= 1e-12 * np.linalg.norm(Linv @ v)
    assert np.linalg.norm(got_t - Linv.T @ u) <= 1e-12 * np.linalg.norm(Linv.T @ u)


def test_a_world_of_one_is_the_local_mesh_of_one():
    """A process-group mesh without a process group (a world of one): its
    sums are the identity all-reduce, so the slab is the local mesh of
    one's bit for bit."""
    Ms = torch.as_tensor(_spd(130, seed=4))
    world = mesh_lib.make_mesh(axis_names=("cols",), device="cpu")
    assert not world.is_local and world.group is None
    a = dist_chol.chol_tri_inv_mesh(Ms, world, panel=16)
    b = dist_chol.chol_tri_inv_mesh(Ms, _mesh(1), panel=16)
    assert len(a.slabs) == len(b.slabs) == 1 and torch.equal(a.slabs[0], b.slabs[0])


def test_a_failed_panel_gives_nan():
    Ms = _spd(24)
    Ms[20, 20] = -1e6  # indefinite in the last panel
    inv = dist_chol.chol_tri_inv_mesh(torch.as_tensor(Ms), _mesh(2), panel=4)
    assert torch.isnan(torch.cat(list(inv.slabs), dim=1)).any()
