"""The scenario tier's lane mesh (``ScenarioBackend(mesh=)``, world task
``scenario_lanes``) against the JAX package's, on the CPU.

* Over a local mesh of 2 (the CPU named twice), the reference's
  ``test_mesh_sharded_lane_axis_matches_unsharded`` instance: status and
  iterations equal to the JAX mesh solve over 2 of the conftest's virtual
  devices, the objective within 1e-8 relative.
* A local mesh of one is ``mesh=None`` bit for bit (x's bytes, the CG
  count); a factorization sums once over the members and an application
  twice (``Mesh.all_reduce`` counted).
* Dead lanes (K = 5 over 2: member 1 holds 1 live lane of 4) factor as the
  identity and add nothing; a mesh that does not divide the lane chunk
  (R = 3) keeps every lane on every member, the reference's rule.
* A gloo world of 2 through ``run_world("scenario_lanes")``: each rank the
  local mesh of 2's x bits, the objective within 1e-8 of the JAX
  package's ``ScenarioBackend()`` on the task's default instance.
"""

import hashlib

import jax
import numpy as np
import pytest
import torch

from distributedlpsolver_tpu.backends.scenario import ScenarioBackend as JaxScenarioBackend
from distributedlpsolver_tpu.ipm import solve as jax_solve
from distributedlpsolver_tpu.models import scenario as jms
from distributedlpsolver_tpu.parallel import mesh as jmesh
from distributedlpsolver_tpu_torch.backends import scenario as tsc
from distributedlpsolver_tpu_torch.distributed.launcher import run_world
from distributedlpsolver_tpu_torch.ipm import Status, solve
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.models import scenario as tms
from distributedlpsolver_tpu_torch.models.problem import to_interior_form
from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
OBJ_TOL = 1e-8


def _rel(a, b):
    return abs(a - b) / (1.0 + abs(b))


def _sha(a):
    return hashlib.sha256(np.asarray(a).tobytes()).hexdigest()


def _small(mod, K, seed):
    """The reference's ``_small_storm`` instance, lowered."""
    return mod.two_stage_storm(K, block_m=6, block_n=10, first_stage_n=6, first_stage_m=2,
                               seed=seed).to_block_angular()


def _local(k):
    return mesh_lib.make_mesh(axis_names=("batch",), devices=[CPU] * k)


def _solve(p, mesh=None):
    be = tsc.ScenarioBackend(device=CPU) if mesh is None else tsc.ScenarioBackend(mesh=mesh)
    return solve(p, backend=be, tol=1e-8), be


@pytest.fixture
def count_reduces(monkeypatch):
    """The shapes handed to ``Mesh.all_reduce``, in call order."""
    calls = []
    real = mesh_lib.Mesh.all_reduce

    def counted(self, t, axis=None):
        calls.append(tuple(t.shape))
        return real(self, t, axis)

    monkeypatch.setattr(mesh_lib.Mesh, "all_reduce", counted)
    return calls


def test_a_local_mesh_of_2_matches_the_jax_mesh_solve():
    mesh = jmesh.make_mesh((2,), axis_names=("batch",), devices=jax.devices()[:2])
    rj = jax_solve(_small(jms, 8, 50), backend=JaxScenarioBackend(mesh=mesh), tol=1e-8)
    rt, be = _solve(_small(tms, 8, 50), _local(2))
    assert be.lane_ranges == [(0, 4), (4, 8)]
    assert [t.W.shape[0] for t in be._parts] == [4, 4]
    assert rt.status.value == rj.status.value == "optimal"
    assert rt.iterations == rj.iterations
    assert _rel(rt.objective, rj.objective) <= OBJ_TOL


def test_a_local_mesh_of_one_is_mesh_none_bit_for_bit():
    p = _small(tms, 8, 50)
    r0, be0 = _solve(p)
    r1, be1 = _solve(p, _local(1))
    assert _sha(r1.x) == _sha(r0.x) and _sha(r1.y) == _sha(r0.y)
    assert r1.iterations == r0.iterations
    assert be1.cg_report()["cg_per_iteration"] == be0.cg_report()["cg_per_iteration"]
    assert be1.member_nbytes() == be0.member_nbytes()


@pytest.mark.parametrize("k", [1, 2])
def test_one_sum_a_factorization_and_two_an_application(k, count_reduces):
    inf = to_interior_form(_small(tms, 8, 50))
    be = tsc.ScenarioBackend(mesh=_local(k))
    be.setup(inf, SolverConfig())
    lay = be.layout
    assert count_reduces == [(lay.n0, lay.n0)]  # setup's unit-diagonal factorization
    del count_reduces[:]
    rng = np.random.default_rng(4)
    d = torch.tensor(rng.uniform(0.1, 10.0, lay.n))
    factors = be._factorize(d, 1e-10)
    assert count_reduces == [(lay.n0, lay.n0)]
    del count_reduces[:]
    be._apply_decomp(factors, torch.tensor(rng.standard_normal(lay.m)))
    assert count_reduces == [(lay.n0,), (lay.m,)]


def test_dead_lanes_on_a_member_add_nothing(count_reduces):
    """K = 5 pads to 8 lanes; over 2 members the second holds lanes 4..7,
    of which only lane 4 is a scenario."""
    p = _small(tms, 5, 21)
    r0, _ = _solve(p)
    r2, be = _solve(p, _local(2))
    assert be.layout.K == 5 and be.lane_ranges == [(0, 4), (4, 8)]
    t1 = be._parts[1]
    m = be.layout.m
    live = (t1.rows_idx < m).any(dim=1)
    assert live.tolist() == [True, False, False, False]
    assert not t1.W[1:].any() and not t1.T[1:].any() and bool((t1.pad_row[1:] == 1).all())
    # No row of A maps into a dead lane's slots, and member 1 leaves the
    # first stage's rows to member 0.
    slots = t1.row_pos[t1.row_pos < 4 * be.layout.mb]
    assert bool((slots < be.layout.mb).all())
    assert bool((t1.row_pos[be._parts[0].rows0] == t1.W.shape[0] * be.layout.mb + be.layout.m0).all())
    # A dead lane's factor is the identity and its share of C is zero.
    d = torch.rand(be.layout.n, dtype=torch.float64) + 0.1
    (L0, L1), *_ = be._factorize(d, 1e-10)
    eye = torch.eye(be.layout.mb, dtype=torch.float64)
    assert all(torch.equal(L1[k], eye) for k in (1, 2, 3))
    Y = torch.linalg.solve_triangular(L1, t1.T, upper=False)
    assert not Y[1:].any()  # Σ_k Y_kᵀ·Y_k takes nothing from them
    dK = tsc._pad(d)[t1.cols_idx]
    only = t1._replace(W=t1.W[:1], T=t1.T[:1], pad_row=t1.pad_row[:1])
    _, C_live = be._schur_factor(only, dK[:1], 1e-10)
    _, C_all = be._schur_factor(t1, dK, 1e-10)
    torch.testing.assert_close(C_all, C_live, rtol=1e-14, atol=0.0)
    assert r2.status == r0.status == Status.OPTIMAL and r2.iterations == r0.iterations
    assert _rel(r2.objective, r0.objective) <= OBJ_TOL


def test_a_mesh_that_does_not_divide_the_chunk_replicates(count_reduces):
    """R = 3 does not divide the 8-lane chunk: every member holds every
    lane (the reference's replicated placement), no sum runs, and the
    answer is mesh=None's bit for bit."""
    p = _small(tms, 8, 50)
    r0, _ = _solve(p)
    del count_reduces[:]
    r3, be = _solve(p, _local(3))
    assert be.lane_ranges == [(0, 8)] and len(be._parts) == 1
    assert count_reduces == []
    assert _sha(r3.x) == _sha(r0.x)


def test_scenario_lanes_over_a_gloo_world_of_2(tmp_path):
    res = run_world("scenario_lanes", {"return_xy": True}, world_size=2,
                    workdir=str(tmp_path / "w"), device="cpu", timeout=240, retries=0)
    assert sorted(res) == [0, 1]
    # The task's default instance (the reference's spec defaults).
    p = tms.two_stage_storm(8, block_m=6, block_n=14, seed=3).to_block_angular()
    local, be = _solve(p, _local(2))
    rj = jax_solve(jms.two_stage_storm(8, block_m=6, block_n=14, seed=3).to_block_angular(),
                   backend=JaxScenarioBackend(), tol=1e-8)
    for rank, o in res.items():
        assert o["status"] == "optimal" and o["world_size"] == 2, (rank, o["status"])
        assert o["x_sha256"] == _sha(local.x) and o["y_sha256"] == _sha(local.y), rank
        assert o["iterations"] == local.iterations
        assert o["cg_iters"] == be.cg_report()["cg_iters"]
        assert o["lanes"] == [[4 * rank, 4 * rank + 4]]  # K1 counts card launches only
        assert o["member_bytes"] == be.member_nbytes() // 2
        assert _rel(o["objective"], rj.objective) <= OBJ_TOL
    assert res[0]["x"] == res[1]["x"]
