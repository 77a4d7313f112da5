"""The dense backend's two-phase schedule under ``schedule_platform="tpu"``
against the JAX package's on the CPU.

The JAX side runs as its own tests run it (``tests/test_two_phase.py``):
``jax.default_backend`` patched to ``"tpu"`` and ``use_pallas=False``,
so phase 1 is its plain-XLA f32 branch. The port side is
``DenseTorchBackend(device="cpu", schedule_platform="tpu")``. Checked:

* whole solves of seeded instances on the segmented route (the TPU's
  auto), the fused two-phase program (``segment_iters=0``) and the host
  loop, and the three-phase PCG plan: the JAX package's status, total
  and per-phase iterations, objectives within 1e-8 relative, one
  history record an iteration;
* the two-phase direct starting point: the f32 factorization's bit for
  bit, and within 1e-5 of the JAX package's (f32 noise);
* each route's phase-1 params (no μ-vs-pinf floor on the unsegmented
  route, 0.03 on the segmented plan), auto PCG, the endgame boundary,
  and the default schedule left as it was;
* the sharded backend on a local mesh of one under ``"tpu"`` against the
  JAX package's two-phase sharded solve.
"""

import numpy as np
import pytest
import torch

import jax

from distributedlpsolver_tpu.backends.dense import DenseJaxBackend
from distributedlpsolver_tpu.backends.sharded import ShardedJaxBackend
from distributedlpsolver_tpu.ipm import solve as jax_solve
from distributedlpsolver_tpu.ipm.config import SolverConfig as JaxConfig
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.models.problem import to_interior_form as jax_interior
from distributedlpsolver_tpu_torch.backends import dense as tdense
from distributedlpsolver_tpu_torch.backends.dense import DenseTorchBackend
from distributedlpsolver_tpu_torch.backends.sharded import ShardedTorchBackend
from distributedlpsolver_tpu_torch.ipm import SolverConfig, Status, solve
from distributedlpsolver_tpu_torch.ipm import core as tcore
from distributedlpsolver_tpu_torch.models import generators as tgen
from distributedlpsolver_tpu_torch.models import to_interior_form
from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-8
OBJ_TOL = 1e-8
# The f32 starts of the two packages differ by f32 factorization noise: up
# to 1.6e-6 (elementwise, in s) on these instances, as far as either lies
# from the f64 start. Which start it is, is checked bit for bit instead.
START_TOL = 1e-5
PHASE1_TOL = 3e-5  # SolverConfig.phase1_tol, the handoff tol at tol 1e-8

INSTANCES = [(30, 80, 5), (12, 30, 2), (40, 100, 1)]
LOOPS = {"segmented": {}, "fused": {"segment_iters": 0}, "host": {"fused_loop": False}}
PCG_CASES = {"pcg": ((40, 100, 1), {}), "pcg_seg2": ((40, 100, 2), {"segment_iters": 2})}


@pytest.fixture
def tpu_gate(monkeypatch):
    """The JAX package's platform gate forced open, as its tests do."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _phase1_exit(history):
    """The first iteration whose rel_gap, pinf and dinf reach the handoff
    tol: where the fused two-phase program's phase 1 ends on convergence
    (the JAX package keeps no phase report on that route)."""
    for i, h in enumerate(history):
        if max(h.rel_gap, h.pinf, h.dinf) <= max(TOL, PHASE1_TOL):
            return i + 1
    return None


def _phases(be, r, loop):
    """[(mode, iterations)] of a solve: the phase report where the
    backend keeps one, the history's handoff on the fused two-phase
    program, None on the host loop (one f64 loop after an f32 start)."""
    if loop == "host":
        return None
    rep = getattr(be, "phase_report", None)
    if rep:
        return [(ph["mode"], ph["iters"]) for ph in rep]
    it1 = _phase1_exit(r.history)
    return [("f32", it1), ("f64", r.iterations - it1)]


def _jax_solve(inst, **kw):
    m, n, seed = inst
    be = DenseJaxBackend()
    r = jax_solve(jgen.random_dense_lp(m, n, seed=seed), backend=be, tol=TOL, use_pallas=False,
                  **kw)
    return r, be


def _port_solve(inst, **kw):
    m, n, seed = inst
    be = DenseTorchBackend(device="cpu", schedule_platform="tpu")
    r = solve(tgen.random_dense_lp(m, n, seed=seed), backend=be, tol=TOL, **kw)
    return r, be


def _same_verdict(rj, rt):
    assert rt.status.value == rj.status.value == "optimal"
    assert rt.iterations == rj.iterations
    assert abs(rt.objective - rj.objective) <= OBJ_TOL * (1.0 + abs(rj.objective))
    assert len(rt.history) == rt.iterations
    assert [h.iter for h in rt.history] == list(range(1, rt.iterations + 1))


@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("inst", INSTANCES, ids=lambda i: f"{i[0]}x{i[1]}s{i[2]}")
def test_two_phase_direct_matches_the_reference(tpu_gate, inst, loop):
    rj, bj = _jax_solve(inst, **LOOPS[loop])
    rt, bt = _port_solve(inst, **LOOPS[loop])
    assert bj._two_phase and bt._two_phase and not bt._pcg
    _same_verdict(rj, rt)
    pt = _phases(bt, rt, loop)
    assert pt == _phases(bj, rj, loop)
    if pt is not None:
        assert [mode for mode, _ in pt] == ["f32", "f64"]
        assert sum(it for _, it in pt) == rt.iterations
    if loop == "fused":
        # The port's own phase report agrees with the history's handoff.
        assert bt.phase_report[0]["iters"] == _phase1_exit(rt.history)


@pytest.mark.parametrize("case", list(PCG_CASES))
def test_two_phase_pcg_matches_the_reference(tpu_gate, case):
    inst, kw = PCG_CASES[case]
    rj, bj = _jax_solve(inst, solve_mode="pcg", **kw)
    rt, bt = _port_solve(inst, solve_mode="pcg", **kw)
    assert bt._two_phase and bt._pcg and bt._closure is not None
    _same_verdict(rj, rt)
    pt = _phases(bt, rt, "segmented")
    assert [mode for mode, _ in pt] == ["f32", "pcg", "f64"]
    assert pt == _phases(bj, rj, "segmented")
    assert bt.cg_report()["solves"] > 0


def _setup(be, inst, **kw):
    m, n, seed = inst
    be.setup(to_interior_form(tgen.random_dense_lp(m, n, seed=seed)), SolverConfig(tol=TOL, **kw))
    return be


def test_two_phase_start_is_the_f32_one(tpu_gate):
    m, n, seed = INSTANCES[0]
    bj = DenseJaxBackend()
    bj.setup(jax_interior(jgen.random_dense_lp(m, n, seed=seed)), JaxConfig(tol=TOL, use_pallas=False))
    bt = _setup(DenseTorchBackend(device="cpu", schedule_platform="tpu"), INSTANCES[0])
    sj, st = bj.starting_point(), bt.starting_point()
    for a, b in zip(st, sj):
        assert _rel(a.numpy(), b) <= START_TOL
    # It is the start of the f32 direct factorization on the f32 copy, not
    # the f64 start of the default schedule.
    assert bt._A32 is not None and bt._A32.dtype == torch.float32
    ops32 = tdense._make_ops(bt._A, bt._reg, torch.float32, 0, bt._A32)
    s32 = tcore.starting_point(ops32, bt._data, bt._params)
    assert all(torch.equal(a, b) for a, b in zip(st, s32))
    s64 = _setup(DenseTorchBackend(device="cpu"), INSTANCES[0]).starting_point()
    assert not torch.equal(st.x, s64.x)


def test_phase_one_params_of_each_route(monkeypatch):
    seen = []
    orig = tdense._dense_solve_two_phase

    def spy(step32, step64, state0, reg0, params, params_p1, *args, **kw):
        seen.append(params_p1)
        return orig(step32, step64, state0, reg0, params, params_p1, *args, **kw)

    monkeypatch.setattr(tdense, "_dense_solve_two_phase", spy)
    r, be = _port_solve(INSTANCES[1], segment_iters=0)
    assert r.status == Status.OPTIMAL and len(seen) == 1
    assert seen[0].mu_pinf_floor == 0.0 and seen[0].tol == PHASE1_TOL
    plan = be._phase_plan()
    assert plan[0].params.mu_pinf_floor == 0.03 and plan[0].params.tol == PHASE1_TOL
    assert [s.mode for s in plan] == ["f32", "f64"] and plan[1].params.tol == TOL
    assert (plan[0].window, plan[0].patience) == (8, 0.0)
    assert (plan[1].window, plan[1].patience) == (16, 1e3 * TOL)


def test_auto_pcg_resolves_to_the_three_phase_plan(monkeypatch):
    inst, _ = PCG_CASES["pcg"]
    m, n, _ = inst
    be = _setup(DenseTorchBackend(device="cpu", schedule_platform="tpu"), inst)
    assert be._two_phase and not be._pcg  # m·n far below 2²⁶
    monkeypatch.setattr(tdense, "_PCG_AUTO_ENTRIES", m * n)
    r_auto, b_auto = _port_solve(inst)
    r_pcg, _ = _port_solve(inst, solve_mode="pcg")
    assert b_auto._pcg
    plan = b_auto._phase_plan()
    assert [s.mode for s in plan] == ["f32", "pcg", "f64"]
    assert [s.closure_sweeps for s in plan] == [0, 2, 2]
    assert plan[1].params.tol == 1e-6 and plan[1].window == 3
    assert r_auto.iterations == r_pcg.iterations
    assert np.array_equal(np.asarray(r_auto.x), np.asarray(r_pcg.x))
    # solve_mode="direct" keeps the two-phase direct plan at any size.
    bd = _setup(DenseTorchBackend(device="cpu", schedule_platform="tpu"), inst,
                solve_mode="direct")
    assert [s.mode for s in bd._phase_plan()] == ["f32", "f64"]


def test_endgame_boundary_raises(monkeypatch):
    monkeypatch.setattr(tdense, "_ENDGAME_ENTRIES", 1)
    inst = INSTANCES[1]
    with pytest.raises(NotImplementedError, match="item 5b"):
        _setup(DenseTorchBackend(device="cpu", schedule_platform="tpu"), inst, solve_mode="pcg")
    monkeypatch.setattr(tdense, "_PCG_AUTO_ENTRIES", 1)
    with pytest.raises(NotImplementedError, match="item 5b"):
        _setup(DenseTorchBackend(device="cpu", schedule_platform="tpu"), inst)
    # The direct plan has no endgame; the card's own schedule is unchanged.
    _setup(DenseTorchBackend(device="cpu", schedule_platform="tpu"), inst, solve_mode="direct")
    _setup(DenseTorchBackend(device="cpu"), inst, solve_mode="pcg")


def test_default_schedule_is_unchanged():
    inst = INSTANCES[2]
    rs = {}
    for platform in (None, "cpu", "cuda"):
        m, n, seed = inst
        be = DenseTorchBackend(device="cpu", schedule_platform=platform)
        rs[platform] = solve(tgen.random_dense_lp(m, n, seed=seed), backend=be, tol=TOL)
        assert not be._two_phase and not be._pcg and be._A32 is None
        assert [ph["mode"] for ph in be.phase_report] == ["f64"]
    assert rs[None].status == Status.OPTIMAL
    for platform in ("cpu", "cuda"):
        assert rs[platform].iterations == rs[None].iterations
        assert np.array_equal(np.asarray(rs[platform].x), np.asarray(rs[None].x))
    with pytest.raises(ValueError, match="schedule_platform"):
        DenseTorchBackend(device="cpu", schedule_platform="gpu")


def test_sharded_two_phase_on_a_local_mesh_of_one(tpu_gate, monkeypatch):
    # The JAX package's test_two_phase_sharded_on_mesh case, on its mesh
    # of the conftest's 8 virtual devices.
    bj = ShardedJaxBackend()
    rj = jax_solve(jgen.random_dense_lp(24, 64, seed=11), backend=bj, tol=TOL)
    mesh = mesh_lib.make_mesh(axis_names=("cols",), devices=["cpu"])
    bt = ShardedTorchBackend(mesh=mesh, schedule_platform="tpu")
    rt = solve(tgen.random_dense_lp(24, 64, seed=11), backend=bt, tol=TOL)
    assert bj._two_phase and bt._two_phase
    _same_verdict(rj, rt)
    assert [(ph["mode"], ph["iters"]) for ph in bt.phase_report] == \
        [(ph["mode"], ph["iters"]) for ph in bj.phase_report]
    assert bt.reshard(mesh).schedule_platform == "tpu"
    # Its automatic PCG is the sharded PCG (item 5b-1, once refused): the
    # three-phase plan over the column-split preconditioner. The dense
    # endgame past 2²⁸ entries is still refused (item 5b).
    monkeypatch.setattr(tdense, "_PCG_AUTO_ENTRIES", 1)
    ba = ShardedTorchBackend(mesh=mesh, schedule_platform="tpu")
    ra = solve(tgen.random_dense_lp(24, 64, seed=11), backend=ba, tol=TOL)
    assert ba._pcg and [ph["mode"] for ph in ba.phase_report] == ["f32", "pcg", "f64"]
    assert ra.status == Status.OPTIMAL and ba.prec_sharding().axis == "cols"
    monkeypatch.setattr(tdense, "_ENDGAME_ENTRIES", 1)
    with pytest.raises(NotImplementedError, match="item 5b"):
        ShardedTorchBackend(mesh=mesh, schedule_platform="tpu").setup(
            to_interior_form(tgen.random_dense_lp(24, 64, seed=11)), SolverConfig(tol=TOL))
