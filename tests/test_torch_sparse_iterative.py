"""The port's matrix-free inexact-IPM backend (``sparse-iterative``)
against the JAX package's, on the CPU (``device="cpu"``, the kernel's
plain versions).

The same seeded problems go through both packages' ``solve``: the small
storm instances end with the same status and IPM iterations and the
objective within 1e-8 relative, on the same preconditioner. The CG totals
are not pinned: the endgame's ill-conditioned solves run to the stall
window, and there the reduction orders' rounding moves each solve's exit
(storm_s: 97 here against the JAX package's 98; storm_m: 1,295 against
497; the chip smoke's 20,480-row instance: 4,312 on the H100 against
2,870, at the same 32 IPM iterations). Also pinned as the reference's
tests pin them: the memory-shape guard, explicit preconditioner
selection, the ILDL escalation, the CPU-placed degradation to
``cpu-sparse``, the warm-cache preconditioner seam and its shape guard,
the routes and the degradation chain, and the service's solo path on this
backend.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from distributedlpsolver_tpu.backends.base import get_backend as jget
from distributedlpsolver_tpu.ipm import driver as jdriver
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.backends.sparse_iterative import SparseIterativeBackend
from distributedlpsolver_tpu_torch.ipm import solve
from distributedlpsolver_tpu_torch.models import generators as tgen
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"
# The objective against the JAX package's: both stop at a 1e-8 gap.
OBJ_TOL = 1e-8


def _close(a, b, tol=OBJ_TOL):
    return abs(a - b) <= tol * (1 + abs(b))


def _both(gen, *args, backend_kw=None, **kw):
    """The same generated problem through both packages' sparse-iterative
    backends at tol 1e-8; returns (port result, port backend, JAX result,
    JAX backend)."""
    bkw = backend_kw or {}
    be = SparseIterativeBackend(device=CPU, **bkw)
    r = solve(getattr(tgen, gen)(*args, **kw), backend=be, tol=1e-8)
    from distributedlpsolver_tpu.backends.sparse_iterative import SparseIterativeBackend as JB

    jb = JB(**bkw)
    rj = jdriver.solve(getattr(jgen, gen)(*args, **kw), backend=jb, tol=1e-8)
    return r, be, rj, jb


def _no_normal_matrix(be, m):
    for name, info in be.memory_report().items():
        shp = info["shape"]
        assert not (len(shp) >= 2 and min(shp[-2:]) >= m), (name, info)


@pytest.mark.parametrize("args, seed", [((8, 16, 24, 16), 9), ((12, 24, 32, 16), 10)],
                         ids=["storm_s", "storm_m"])
def test_small_storm_solves_match_the_jax_backend(args, seed):
    r, be, rj, jb = _both("storm_sparse_lp", *args, seed=seed)
    assert r.status.value == rj.status.value == "optimal"
    assert r.rel_gap <= 1e-8 and r.pinf <= 1e-8 and r.dinf <= 1e-8
    assert r.iterations == rj.iterations
    assert _close(r.objective, rj.objective)
    rep = be.cg_report()
    assert rep["precond"] == jb.cg_report()["precond"] == "bordered"
    assert rep["cg_iters"] > 0 and len(rep["cg_per_iteration"]) >= r.iterations + 1
    # On the CPU every CG iteration reads the exit flag; each Newton solve
    # is counted.
    assert rep["host_syncs"] >= rep["cg_iters"] and rep["newton_solves"] > 0
    _no_normal_matrix(be, args[0] * args[1])
    assert be.max_operand_nbytes() < args[0] * args[1] * args[0] * args[1] * 8


def test_explicit_precond_selection_matches_the_jax_backend():
    r, be, rj, _ = _both("storm_sparse_lp", 8, 16, 24, 16, seed=11, backend_kw={"precond": "block"})
    assert r.status.value == "optimal" and be.cg_report()["precond"] == "block"
    assert _close(r.objective, rj.objective)
    # jacobi: exact on a diagonally dominant program.
    rng = np.random.default_rng(33)
    m, n = 150, 260
    A = sp.eye(m, n, format="csr") + 0.01 * sp.random(m, n, density=0.02, random_state=33,
                                                      format="csr")
    x0, y0, s0 = rng.uniform(0.5, 2.0, n), rng.standard_normal(m), rng.uniform(0.5, 2.0, n)
    b = np.asarray(A @ x0).ravel()
    from distributedlpsolver_tpu_torch.models.problem import LPProblem

    q = LPProblem(c=np.asarray(A.T @ y0).ravel() + s0, A=A, rlb=b, rub=b, lb=np.zeros(n),
                  ub=np.full(n, np.inf), name="diagdom")
    be = SparseIterativeBackend(precond="jacobi", device=CPU)
    r = solve(q, backend=be, tol=1e-8)
    assert r.status.value == "optimal" and be.cg_report()["precond"] == "jacobi"
    with pytest.raises(ValueError):
        SparseIterativeBackend(precond="nope", device=CPU)


def test_ildl_escalation_rescues_the_unstructured_endgame():
    """Under precond "auto" the Jacobi CG streak escalates to incomplete
    LDLᵀ mid-solve and the solve finishes on sparse-iterative itself, as
    in the JAX package (its tests/test_sparse_dist.py instance)."""
    r, be, rj, jb = _both("netlib_sparse_lp", 60, 110, seed=10)
    assert r.status.value == rj.status.value == "optimal"
    assert be.precond == jb.precond == "ildl" and be.cg_report()["precond"] == "ildl"
    assert r.iterations == rj.iterations and _close(r.objective, rj.objective)


def test_unstructured_endgame_degrades_to_cpu_sparse():
    """Pinned to Jacobi, the unstructured endgame breaks CG down as a
    structured numerical fault and the supervisor degrades a CPU-placed
    backend along the chain to the sparse-direct host rung, which finishes
    to 1e-8 (the reference's honest failure ladder)."""
    from distributedlpsolver_tpu_torch.supervisor import supervised_solve

    p = tgen.netlib_sparse_lp(120, 220, seed=10)
    r = supervised_solve(p, backend=SparseIterativeBackend(precond="jacobi", device=CPU),
                         tol=1e-8)
    assert r.status.value == "optimal"
    assert r.backend == "cpu-sparse" and r.faults[-1].action == "degrade:cpu-sparse"
    # The JAX package's answer (its own test pins the same ladder).
    ref = jdriver.solve(jgen.netlib_sparse_lp(120, 220, seed=10), backend="cpu-sparse", tol=1e-8)
    assert _close(r.objective, ref.objective)


def test_warm_precond_hit_path():
    """A correlated re-solve draws its preconditioner factors from the warm
    cache and freezes them for the early iterations: fewer IPM iterations,
    frozen steps > 0 — as the JAX package's seam does."""
    from distributedlpsolver_tpu_torch.serve.warmcache import WarmCache

    cache = WarmCache(8)
    p = tgen.storm_sparse_lp(8, 16, 24, 16, seed=3)
    be_cold = get_backend("sparse-iterative", device=CPU)
    r_cold = solve(p, backend=be_cold, tol=1e-8, warm_cache=cache)
    assert r_cold.status.value == "optimal"
    assert be_cold.cg_report()["warm_precond_steps"] == 0
    (entry,) = cache._entries.values()
    assert entry.precond_d["precond"] == "bordered" and entry.precond_d["d"].shape == (p.n,)
    p2 = tgen.storm_sparse_lp(8, 16, 24, 16, seed=3)
    p2.c = p2.c * 1.01
    be_warm = get_backend("sparse-iterative", device=CPU)
    r_warm = solve(p2, backend=be_warm, tol=1e-8, warm_cache=cache)
    assert r_warm.status.value == "optimal"
    assert be_warm.cg_report()["warm_precond_steps"] > 0
    assert r_warm.iterations < r_cold.iterations


def test_offer_precond_is_shape_guarded():
    from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
    from distributedlpsolver_tpu_torch.models.problem import to_interior_form

    inf = to_interior_form(tgen.storm_sparse_lp(8, 16, 24, 16, seed=12))
    be = get_backend("sparse-iterative", device=CPU)
    assert not be.offer_precond(np.ones(inf.n))  # before setup
    be.setup(inf, SolverConfig(tol=1e-8))
    assert not be.offer_precond(np.ones(inf.n + 1))  # wrong shape
    assert not be.offer_precond(np.zeros(inf.n))  # nonpositive
    assert not be.offer_precond(np.full(inf.n, np.nan))  # nonfinite
    assert not be.offer_precond({"precond": "bordered"})  # no vector
    assert be.offer_precond(np.ones(inf.n))
    assert be.offer_precond({"d": np.ones(inf.n), "precond": "bordered"})
    assert be.export_precond() is None  # no step yet


def test_routes_and_the_degradation_chain_match_the_jax_package():
    from distributedlpsolver_tpu.backends.auto import choose_backend_name as jchoose
    from distributedlpsolver_tpu.backends.auto import degradation_chain as jchain
    from distributedlpsolver_tpu.models.problem import to_interior_form as jinterior
    from distributedlpsolver_tpu_torch.backends.auto import choose_backend_name, degradation_chain
    from distributedlpsolver_tpu_torch.models.problem import to_interior_form

    inf = to_interior_form(tgen.storm_sparse_lp(16, 32, 48, 24, seed=13))
    jinf = jinterior(jgen.storm_sparse_lp(16, 32, 48, 24, seed=13))
    for platform, jplatform in (("cpu", "cpu"), ("cuda", "tpu")):
        assert choose_backend_name(inf, platform)[0] == jchoose(jinf, jplatform)[0] == (
            "sparse-iterative")
    assert degradation_chain("cuda")[0] == jchain("tpu")[0] == "sparse-iterative"
    assert degradation_chain("sparse-iterative") == jchain("sparse-iterative") == [
        "cpu-sparse", "cpu"]
    assert degradation_chain("inexact-ipm") == degradation_chain("sparse-iterative")


def test_registered_names_device_and_the_unported_mesh_tier():
    """Every name of the tier, on the device asked for; the row-sharded
    tier (item 13c, once refused) takes its device from its mesh, and
    ``reshard`` hands back a fresh backend on the new mesh
    (``test_torch_sparse_dist.py`` solves on it)."""
    from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib

    for name in ("sparse-iterative", "inexact-ipm", "sparse-pcg"):
        be = get_backend(name, device=CPU)
        assert isinstance(be, SparseIterativeBackend) and be.device.type == "cpu"
        assert be.name == "sparse-iterative" and be.mesh is None
    mesh2 = mesh_lib.make_mesh(axis_names=("batch",), devices=[CPU] * 2)
    be = SparseIterativeBackend(precond="jacobi", mesh=mesh2)
    assert be.mesh is mesh2 and be.device.type == "cpu"
    be1 = be.reshard(mesh_lib.reform_mesh(mesh2, exclude=[1]))
    assert be1 is not be and be1.mesh.size == 1 and be1._precond_req == "jacobi"
    assert SparseIterativeBackend(device=CPU).reshard(mesh2).mesh is mesh2


def test_auto_on_the_cpu_solves_a_bordered_problem_as_the_jax_auto():
    p = tgen.storm_sparse_lp(8, 16, 24, 16, seed=14)
    be = get_backend("auto", device=CPU)
    r = solve(p, backend=be, tol=1e-8)
    rj = jdriver.solve(jgen.storm_sparse_lp(8, 16, 24, 16, seed=14), backend=jget("auto"), tol=1e-8)
    assert r.backend == rj.backend == "auto(sparse-iterative)"
    assert be.inner.cg_report()["precond"] == "bordered"
    assert r.iterations == rj.iterations and _close(r.objective, rj.objective)


def test_the_solve_emits_its_cg_span():
    """With a tracer on, the driver adds one ``cg.solve`` span carrying the
    backend's CG report, and the backend one ``cg.step`` instant a step."""
    import json

    from distributedlpsolver_tpu_torch.obs import trace as obs_trace

    class Memory(obs_trace.Tracer):
        def __init__(self):
            super().__init__(path="unused")

    tr = Memory()
    prev = obs_trace.set_tracer(tr)
    try:
        r = solve(tgen.storm_sparse_lp(4, 16, 24, 8, seed=15),
                  backend=get_backend("sparse-iterative", device=CPU), tol=1e-8)
    finally:
        obs_trace.set_tracer(prev)
    events = json.loads(json.dumps(tr._events))
    spans = [e for e in events if e.get("name", "").startswith("cg.solve")]
    steps = [e for e in events if e.get("name") == "cg.step"]
    assert len(spans) == 1 and spans[0]["args"]["precond"] == "bordered"
    assert spans[0]["args"]["cg_iters"] == sum(e["args"]["cg_iters"] for e in steps) > 0
    assert len(steps) >= r.iterations + 1


def test_service_solo_path_on_sparse_iterative():
    """``ServiceConfig(solo_backend="sparse-iterative")``: a sparse request
    that no bucket takes is solved alone on this backend."""
    from distributedlpsolver_tpu_torch.serve.service import ServiceConfig, SolveService

    svc = SolveService(ServiceConfig(batch=4, flush_s=0.02, solo_backend="sparse-iterative"),
                       device=CPU)
    svc.start()
    try:
        p = tgen.storm_sparse_lp(8, 16, 24, 16, seed=9)
        res = svc.submit(p, tol=1e-8).result(timeout=300)
    finally:
        svc.shutdown()
    ref = jdriver.solve(jgen.storm_sparse_lp(8, 16, 24, 16, seed=9), backend="sparse-iterative",
                        tol=1e-8)
    assert res.status.value == "optimal" and res.bucket is None
    assert res.backend == "sparse-iterative"
    assert _close(res.objective, ref.objective)
