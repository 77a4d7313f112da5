"""The PDHG engine's column mesh (``FirstOrderBackend(mesh=)`` and
``SolverConfig.mesh_shape`` on a dense A) against the JAX package's, on
the CPU.

* The reference's ``test_mesh_sharded_matches_single_device``: its mesh
  over the conftest's 8 virtual devices against the port's local mesh of
  8 (the CPU named 8 times), both padded to a multiple of 8 columns; the
  objectives within 1e-4·(1 + |obj|), x of the problem's width.
* ``mesh_shape=(1,)`` (a world of one, no ``torch.distributed``) solves
  bit for bit with ``mesh=None`` and within 1e-4·(1 + |obj|) of the
  reference's ``mesh_shape=(8,)`` solve.
* The reference's rules: a config-made mesh leaves a sparse A on the
  single-device path; an explicit one densifies it, and refuses one past
  2²⁶ entries with the reference's message.
* η over the padded width within 1e-12 of the reference's; two
  all-reduces an inner PDHG step.
* A gloo world of 2 at an odd n (``sharded_solve`` with ``backend: pdlp,
  mesh_shape: [2]``): both ranks the same x bits, the local mesh of 2's.
"""

import hashlib

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from distributedlpsolver_tpu.backends.first_order import FirstOrderBackend as JaxFirstOrder
from distributedlpsolver_tpu.ipm import solve as jax_solve
from distributedlpsolver_tpu.ipm.config import SolverConfig as JaxConfig
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.models.problem import LPProblem as JaxLPProblem
from distributedlpsolver_tpu.models.problem import to_interior_form as jax_interior
from distributedlpsolver_tpu.parallel import make_mesh as jax_make_mesh
from distributedlpsolver_tpu_torch.backends import first_order as tfo
from distributedlpsolver_tpu_torch.distributed.launcher import run_world
from distributedlpsolver_tpu_torch.ipm import Status, solve
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.models import generators as tgen
from distributedlpsolver_tpu_torch.models.problem import LPProblem, to_interior_form
from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
KW = dict(tol=1e-6, max_iter=100)
# The reference's mesh_shape=(8,) solve of random_general_lp(24, 50, seed=7).
JAX_MESH8_OBJECTIVE = -28.304206381501512


def _local(k):
    return mesh_lib.make_mesh(axis_names=("cols",), devices=[CPU] * k)


def _sha(a):
    return hashlib.sha256(np.asarray(a).tobytes()).hexdigest()


def _near(a, b):
    return abs(a - b) <= 1e-4 * (1.0 + abs(b))


@pytest.fixture(scope="module")
def jax_mesh8():
    """The reference's explicit mesh over 8 virtual devices and its
    config-made ``mesh_shape=(8,)`` solve."""
    p = jgen.random_general_lp(24, 50, seed=7)
    mesh = jax_make_mesh(devices=jax.devices()[:8])
    explicit = jax_solve(p, backend=JaxFirstOrder(mesh=mesh), **KW)
    config = jax_solve(p, backend="pdlp", mesh_shape=(8,), **KW)
    return explicit, config


def test_a_local_mesh_of_8_matches_the_jax_mesh_solve(jax_mesh8):
    rj, _ = jax_mesh8
    p = tgen.random_general_lp(24, 50, seed=7)
    be = tfo.FirstOrderBackend(mesh=_local(8))
    r = solve(p, backend=be, **KW)
    assert r.status == Status.OPTIMAL and rj.status.value == "optimal"
    assert _near(r.objective, rj.objective)
    assert r.x.shape == (p.n,)
    n = be._n_orig
    assert (n + be._n_pad) % 8 == 0 and be._n_pad == (-n) % 8
    assert [tuple(A.shape) for _, _, A in be._blocks] == [(be._data.b.shape[0], (n + be._n_pad) // 8)] * 8


def test_mesh_shape_solves_as_mesh_none_and_as_the_reference(jax_mesh8):
    """The repaired fault: ``mesh_shape`` on a dense A used to raise."""
    _, rj = jax_mesh8
    assert rj.status.value == "optimal" and rj.objective == JAX_MESH8_OBJECTIVE
    p = tgen.random_general_lp(24, 50, seed=7)
    r0 = solve(p, backend=tfo.FirstOrderBackend(device=CPU), **KW)
    be = tfo.FirstOrderBackend(device=CPU)
    r1 = solve(p, backend=be, mesh_shape=(1,), **KW)
    assert be.mesh is not None and be.mesh.size == 1
    assert r1.status == Status.OPTIMAL and r1.iterations == r0.iterations
    assert _sha(r1.x) == _sha(r0.x) and _sha(r1.y) == _sha(r0.y)
    assert _near(r1.objective, JAX_MESH8_OBJECTIVE)


def _sparse_form(problem_cls, to_form, m, n, nnz=64):
    """The interior form of an equality LP whose sparse A has m·n > 2²⁶."""
    rng = np.random.default_rng(0)
    A = sp.csr_matrix((rng.uniform(1, 2, nnz), (rng.integers(0, m, nnz), rng.integers(0, n, nnz))),
                      shape=(m, n))
    return to_form(problem_cls(c=np.ones(n), A=A, rlb=np.ones(m), rub=np.ones(m),
                               lb=np.zeros(n), ub=np.full(n, np.inf), name="sparse"))


def test_the_sparse_and_explicit_mesh_rules():
    p = tgen.random_sparse_lp(16, 40, density=0.2, seed=1)
    inf = to_interior_form(p)
    assert sp.issparse(inf.A)
    be = tfo.FirstOrderBackend(device=CPU)
    be.setup(inf, SolverConfig(mesh_shape=(1,)))
    assert be.mesh is None and be._sparse  # a config mesh leaves sparse A alone
    be = tfo.FirstOrderBackend(mesh=_local(2))
    be.setup(inf, SolverConfig())
    assert be.mesh is not None and not be._sparse and be._n_pad == inf.n % 2
    r = solve(p, backend=tfo.FirstOrderBackend(mesh=_local(2)), tol=1e-6)
    r0 = solve(p, backend=tfo.FirstOrderBackend(device=CPU), tol=1e-6)
    assert r.status == r0.status == Status.OPTIMAL and _near(r.objective, r0.objective)
    # Past 2²⁶ entries an explicit mesh refuses, in the reference's words.
    m, n = 8193, 8193
    with pytest.raises(ValueError) as ej:
        JaxFirstOrder(mesh=jax_make_mesh(devices=jax.devices()[:2])).setup(
            _sparse_form(JaxLPProblem, jax_interior, m, n), JaxConfig())
    with pytest.raises(ValueError) as et:
        tfo.FirstOrderBackend(mesh=_local(2)).setup(
            _sparse_form(LPProblem, to_interior_form, m, n), SolverConfig())
    assert str(et.value) == str(ej.value) and "too large to densify" in str(et.value)


def test_eta_runs_over_the_padded_width():
    jp, tp = jgen.random_general_lp(24, 50, seed=7), tgen.random_general_lp(24, 50, seed=7)
    jbe = JaxFirstOrder(mesh=jax_make_mesh(devices=jax.devices()[:8]))
    jbe.setup(jax_interior(jp), JaxConfig())
    tbe = tfo.FirstOrderBackend(mesh=_local(8))
    tbe.setup(to_interior_form(tp), SolverConfig())
    assert tbe._n_pad == jbe._n_pad > 0
    assert abs(tbe._eta - jbe._eta) <= 1e-12 * jbe._eta


def test_two_all_reduces_an_inner_step(monkeypatch):
    calls = []
    real = mesh_lib.Mesh.all_reduce
    monkeypatch.setattr(mesh_lib.Mesh, "all_reduce",
                        lambda self, t, axis=None: calls.append(t.shape) or real(self, t, axis))
    p = tgen.random_dense_lp(12, 31, seed=3)
    be = tfo.FirstOrderBackend(mesh=_local(2))
    be.setup(to_interior_form(p), SolverConfig(tol=1e-6))
    m, n = be._data.b.shape[0], be._data.c.shape[0]
    del calls[:]
    x, y = torch.zeros(n, dtype=torch.float64), torch.zeros(m, dtype=torch.float64)
    be._matvec(x)
    be._rmatvec(y)
    assert calls == [(m,), (n,)]  # A·x and Aᵀ·y: one each
    del calls[:]
    rep = {}
    be._run(x, y, 1.0, float("inf"), tfo.CHECK_EVERY, rep)
    # The start's error (2), each body's 40 steps and two errors, the end's two errors.
    assert rep["eager"] == 1
    assert len(calls) == 2 + (2 * tfo.CHECK_EVERY + 4) * rep["eager"] + 4


def test_a_gloo_world_of_2_at_an_odd_n(tmp_path):
    spec = {"backend": "pdlp", "mesh_shape": [2], "instance": "dense", "m": 12, "n": 31,
            "seed": 3, "tol": 1e-6}
    res = run_world("sharded_solve", spec, world_size=2, workdir=str(tmp_path / "w"),
                    device="cpu", timeout=240, retries=0)
    r = solve(tgen.random_dense_lp(12, 31, seed=3), backend=tfo.FirstOrderBackend(mesh=_local(2)),
              tol=1e-6)
    assert sorted(res) == [0, 1]
    for rank, o in res.items():
        assert o["status"] == "optimal" and o["world_size"] == 2, rank
        assert o["x_sha256"] == _sha(r.x) and o["iterations"] == r.iterations, rank
        assert o["shard_shape"] == [12, 16]  # 31 columns + 1 pad over 2
        assert o["phase_report"][0]["capture_off_reason"] is None  # the CPU runs eagerly
