"""The port's batched solver (``backends/batched.py::solve_batched``) on the
CPU, against the JAX package's batched solver and the port's own dense
solo solves.

Batches are made once with numpy (the JAX package's generator, which the
port's equals) and handed to both packages. Every test runs with
``torch.func.vmap``'s per-sample fallback switched off, as the batched
path runs on the card: an operation of the vmapped step without a
batching rule raises instead of looping the lanes.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

from distributedlpsolver_tpu.backends import batched as jbatched
from distributedlpsolver_tpu.models.generators import BatchedLP as JaxBatchedLP
from distributedlpsolver_tpu.models.generators import random_batched_lp as jax_random_batched_lp
from distributedlpsolver_tpu_torch.backends import batched as tbatched
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.ipm import Status, solve
from distributedlpsolver_tpu_torch.ipm import core as tcore
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.ipm.state import IPMState
from distributedlpsolver_tpu_torch.interop import batched_lp_from_arrays
from distributedlpsolver_tpu_torch.models import random_batched_lp
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")


@contextlib.contextmanager
def _vmap_fallback_off():
    was = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(was)


@pytest.fixture(autouse=True)
def no_vmap_fallback():
    with _vmap_fallback_off():
        yield


def _pair(A, b, c, name):
    """The same batch for both packages, from one set of arrays."""
    return (batched_lp_from_arrays(A, b, c, name),
            JaxBatchedLP(c=np.asarray(c), A=np.asarray(A), b=np.asarray(b), name=name))


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)) / (1.0 + np.abs(np.asarray(b)))


def _statuses(r):
    return [s.value for s in r.status]


@pytest.fixture(scope="module")
def batch12():
    jb = jax_random_batched_lp(12, 16, 40, seed=3)
    return _pair(jb.A, jb.b, jb.c, jb.name)


@pytest.fixture(scope="module")
def results12(batch12):
    tb, jb = batch12
    with _vmap_fallback_off():
        return tbatched.solve_batched(tb, device="cpu"), jbatched.solve_batched(jb)


def _staggered():
    """Per-member column scaling staggers convergence (the JAX package's
    compaction case, tests/test_batched.py)."""
    b = jax_random_batched_lp(64, 16, 40, seed=11)
    rng = np.random.default_rng(0)
    A = np.asarray(b.A) * 10.0 ** rng.uniform(-1, 1, (64, 1, 40))
    return A, b.b, b.c


def test_generator_matches_the_jax_package():
    t, j = random_batched_lp(5, 6, 11, seed=2), jax_random_batched_lp(5, 6, 11, seed=2)
    for f in ("A", "b", "c"):
        assert np.array_equal(getattr(t, f), getattr(j, f))
    assert t.name == j.name and (t.batch, t.m, t.n) == (5, 6, 11)
    assert np.array_equal(t.problem(3).A, j.problem(3).A)


def test_matches_the_jax_package_member_for_member(results12):
    rt, rj = results12
    assert _statuses(rt) == _statuses(rj) == ["optimal"] * 12
    assert np.array_equal(rt.iterations, rj.iterations)
    assert len(set(rt.iterations.tolist())) > 1  # genuinely ragged
    assert (_rel(rt.objective, rj.objective) <= 1e-9).all()
    assert (rt.rel_gap <= 1e-8).all() and (rt.pinf <= 1e-7).all()
    assert rt.x.shape == (12, 40) and rt.y is None and rt.warm_used is None
    (row,) = rt.phase_report
    assert row["chunk"] == 0 and row["iters"] == rt.iterations.max()
    assert row["sizes"] == [12] and row["bodies"] == row["iters"] + row["masked"]


def test_matches_the_ports_dense_solo_solves(batch12, results12):
    tb, _ = batch12
    rt, _ = results12
    for k in [0, 4, 9]:
        r = solve(tb.problem(k), backend=get_backend("cuda", device="cpu"))
        assert r.status == Status.OPTIMAL
        assert _rel(rt.objective[k], r.objective) <= 1e-9


def _lanes(B=5, m=8, n=20, seed=4):
    tb = random_batched_lp(B, m, n, seed=seed)
    A = torch.as_tensor(tb.A)
    data = tbatched._batched_data(torch.as_tensor(tb.c), torch.as_tensor(tb.b))
    params = SolverConfig().step_params()
    states = tbatched._batched_start(A, data, 1e-10, params, torch.float64)
    return A, data, params, states


def test_one_vmapped_step_equals_the_unbatched_step_lane_by_lane():
    A, data, params, states = _lanes()
    regs = torch.full((A.shape[0],), 1e-10, dtype=torch.float64)
    new, stats = tbatched._vstep(params, torch.float64, False)(A, None, data, states, regs)
    for i in range(A.shape[0]):
        lane = lambda t: type(t)(*(v[i] for v in t))
        ref, ref_stats = tbatched._single_step(A[i], lane(data), lane(states), regs[i], params,
                                               torch.float64)
        for v, r in zip(new, ref):
            torch.testing.assert_close(v[i], r, rtol=1e-12, atol=1e-12 * float(r.abs().max()))
        for v, r in zip(stats, ref_stats):
            if r.dtype == torch.bool:
                assert bool(v[i]) == bool(r)
            else:
                torch.testing.assert_close(v[i], r, rtol=1e-12, atol=1e-14)


def _drive(carry, s, step, params, window, bodies_past=3):
    while bool(tbatched._guard(carry[1], carry[2], s)):
        carry = tbatched._batched_body(carry, s, step, params, window, tbatched._STALL)
    before, _ = tcore.device_loop.flatten(carry)
    for _ in range(bodies_past):
        carry = tbatched._batched_body(carry, s, step, params, window, tbatched._STALL)
    after, _ = tcore.device_loop.flatten(carry)
    return carry, before, after


@pytest.mark.parametrize("exit_by", ["settled", "max_iter", "it_stop"])
def test_a_body_past_the_exit_leaves_the_carry_bit_for_bit(exit_by):
    A, data, params, states = _lanes()
    B = A.shape[0]
    cfg = SolverConfig()
    carry = tbatched._fresh_batch_carry(states, torch.zeros(B, dtype=torch.int32), B,
                                        cfg.reg_dual, torch.float64)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    s = {"max_iter": i32(4 if exit_by == "max_iter" else cfg.max_iter),
         "it_stop": i32(3 if exit_by == "it_stop" else cfg.max_iter),
         "max_refactor": i32(cfg.max_refactor),
         "reg_grow": torch.tensor(cfg.reg_grow, dtype=torch.float64)}
    vstep = tbatched._vstep(params, torch.float64, False)
    step = lambda st, rg: vstep(A, None, data, st, rg)
    carry, before, after = _drive(carry, s, step, params, 2 * cfg.stall_window)
    if exit_by == "settled":
        assert not bool(carry[1].any()) and (carry[5] == tbatched._OPTIMAL).all()
    else:
        assert int(carry[2]) == (4 if exit_by == "max_iter" else 3) and bool(carry[1].all())
    assert len(carry) == 9 and len(before) == len(after) == 13
    for a, b in zip(before, after):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_explicit_f32_factor_matches_the_jax_package(batch12):
    """``factor_dtype="float32"``: the assembly and the factor in f32 on
    the precast copy of A, as in the JAX package. Same statuses and
    iterations; objectives within 1e-8 (f32 factors round differently in
    the two, and both stop at a 1e-8 gap)."""
    tb, jb = batch12
    rt = tbatched.solve_batched(tb, device="cpu", factor_dtype="float32")
    rj = jbatched.solve_batched(jb, factor_dtype="float32")
    assert _statuses(rt) == _statuses(rj) == ["optimal"] * 12
    assert np.array_equal(rt.iterations, rj.iterations)
    assert (_rel(rt.objective, rj.objective) <= 1e-8).all()
    assert rt.phase_report[0]["mode"] == "float32"


def test_fused_iters_gives_the_bits_of_one(batch12, results12):
    tb, _ = batch12
    r1, _ = results12
    r3 = tbatched.solve_batched(tb, device="cpu", fused_iters=3)
    assert r3.fused_iters == 3 and r1.fused_iters == 1
    assert _statuses(r3) == _statuses(r1)
    assert np.array_equal(r3.iterations, r1.iterations)
    assert np.array_equal(r3.x, r1.x) and np.array_equal(r3.objective, r1.objective)
    (row,) = r3.phase_report
    assert row["bodies"] == -(-r1.iterations.max() // 3)


def test_fresh_batch_carry_keeps_optimal_members_settled():
    """The JAX package's keep-optimal reset (tests/test_batched.py): with
    a status, optimal members stay inactive and settled and everyone else
    re-enters RUNNING; without one, everyone re-enters."""
    B = 6
    states = IPMState(*[torch.zeros(B, 3, dtype=torch.float64)] * 5)
    iters = torch.arange(B, dtype=torch.int32)
    t = tbatched
    status = torch.tensor([t._OPTIMAL, t._RUNNING, t._OPTIMAL, t._STALL, t._NUMERR, t._RUNNING],
                          dtype=torch.int32)
    carry = t._fresh_batch_carry(states, iters, B, 1e-10, torch.float64, status=status)
    assert carry[1].tolist() == [False, True, False, True, True, True]
    assert carry[5].tolist() == [t._OPTIMAL, t._RUNNING, t._OPTIMAL, t._RUNNING, t._RUNNING,
                                 t._RUNNING]
    assert carry[5].dtype == torch.int32 and torch.equal(carry[6], iters)
    carry2 = t._fresh_batch_carry(states, iters, B, 1e-10, torch.float64)
    assert bool(carry2[1].all()) and bool((carry2[5] == t._RUNNING).all())
    jcarry = jbatched._fresh_batch_carry(np.zeros((B, 3)), np.arange(B, dtype=np.int32), B, 1e-10,
                                         np.float64, status=status.numpy())
    assert np.array_equal(np.asarray(jcarry[1]), carry[1].numpy())
    assert np.array_equal(np.asarray(jcarry[5]), carry[5].numpy())


def test_cast_batch_carry_casts_only_the_floating_leaves():
    B = 4
    states = IPMState(*[torch.full((B, 3), 1.0 / 3.0, dtype=torch.float64)] * 5)
    carry = tbatched._fresh_batch_carry(states, torch.arange(B, dtype=torch.int32), B, 1e-10,
                                        torch.float64)
    cast = tbatched._cast_batch_carry(carry, torch.float32)
    jcast = jbatched._cast_batch_carry(
        tuple(np.asarray(v) if isinstance(v, torch.Tensor) else
              type(v)(*(np.asarray(x) for x in v)) for v in carry), np.float32)
    for got, ref in zip([*cast[0], *cast[1:]], [*jcast[0], *jcast[1:]]):
        assert got.dtype == getattr(torch, np.asarray(ref).dtype.name)
        assert np.array_equal(got.numpy(), np.asarray(ref))


def test_final_phase_compaction_matches_plain_and_the_jax_package():
    A, b, c = _staggered()
    tb, jb = _pair(A, b, c, "staggered")
    r_plain = tbatched.solve_batched(tb, device="cpu", segment_iters=0)
    calls = []
    orig = tbatched._compact_gather
    with mock.patch.object(
        tbatched, "_compact_gather",
        side_effect=lambda *a, **k: calls.append(a[3]) or orig(*a, **k),
    ):
        r_comp = tbatched.solve_batched(tb, device="cpu", segment_iters=2)
    assert calls, "compaction never triggered — the staggered batch no longer staggers"
    assert all(s <= 32 for s in calls)
    (row,) = r_comp.phase_report
    assert row["sizes"] == [64] + calls and row["runs"] > 1
    assert r_comp.n_optimal == r_plain.n_optimal
    assert _statuses(r_comp) == _statuses(r_plain)
    np.testing.assert_allclose(r_comp.objective, r_plain.objective, rtol=1e-6)
    rj = jbatched.solve_batched(jb, segment_iters=0)
    assert _statuses(rj) == _statuses(r_plain) and np.array_equal(rj.iterations, r_plain.iterations)
    np.testing.assert_allclose(r_comp.objective, rj.objective, rtol=1e-6)


@pytest.mark.parametrize("case", ["stalled", "max_iter"])
def test_unfinished_members_and_the_solo_cleanup_match_the_jax_package(case):
    """``stalled``: ten members that converge and two that stall in the
    batched loop (under the cleanup bound of 4), which re-solve alone,
    warm-started from their batched iterates. ``max_iter``: members cut
    at the iteration limit keep that verdict (no budget is left for a
    solo solve)."""
    A, b, c = _staggered()
    if case == "stalled":
        sel = np.array([1, 4, 5, 8, 22, 24, 25, 26, 32, 37, 0, 2])
        kw = {}
    else:
        sel = np.arange(12)
        kw = {"max_iter": 12}
    tb, jb = _pair(A[sel], b[sel], c[sel], case)
    rt = tbatched.solve_batched(tb, device="cpu", **kw)
    rj = jbatched.solve_batched(jb, **kw)
    assert _statuses(rt) == _statuses(rj)
    assert np.array_equal(rt.iterations, rj.iterations)
    assert (_rel(rt.objective, rj.objective) <= 1e-8).all()
    cleanup = [row for row in rt.phase_report if row["phase"] == "cleanup"]
    if case == "stalled":
        assert [row["member"] for row in cleanup] == [10, 11]
        assert _statuses(rt)[:10] == ["optimal"] * 10
    else:
        assert cleanup == [] and "iteration_limit" in _statuses(rt)
        assert rt.iterations.max() == 12


def test_chunked_gives_the_unchunked_answers(batch12, results12):
    tb, _ = batch12
    r_whole, _ = results12
    r = tbatched.solve_batched(tb, device="cpu", chunk=5)
    assert _statuses(r) == _statuses(r_whole)
    assert np.array_equal(r.iterations, r_whole.iterations)
    assert (_rel(r.objective, r_whole.objective) <= 1e-9).all()
    assert [row["chunk"] for row in r.phase_report] == [0, 1, 2]
    assert [row["sizes"] for row in r.phase_report] == [[5], [5], [2]]
    assert r.solve_time > 0 and r.setup_time >= 0


def test_chunked_cleanup_rows_name_members_of_the_whole_batch():
    """The stalled case of the cleanup test in chunks of 6: its two
    cleanup solves are members 10 and 11 of the batch (chunk 1), with the
    unchunked answers."""
    A, b, c = _staggered()
    sel = np.array([1, 4, 5, 8, 22, 24, 25, 26, 32, 37, 0, 2])
    tb, _ = _pair(A[sel], b[sel], c[sel], "stalled")
    r_whole = tbatched.solve_batched(tb, device="cpu")
    r = tbatched.solve_batched(tb, device="cpu", chunk=6)
    cleanup = [row for row in r.phase_report if row["phase"] == "cleanup"]
    assert [(row["member"], row["chunk"]) for row in cleanup] == [(10, 1), (11, 1)]
    assert _statuses(r) == _statuses(r_whole)
    assert np.array_equal(r.iterations, r_whole.iterations)
    assert (_rel(r.objective, r_whole.objective) <= 1e-9).all()


def test_what_is_not_ported_raises(batch12):
    """The PCG schedule is still refused; ``mesh`` (once refused) splits
    the batch: 12 members over a local mesh of 3 are the unsharded ones."""
    from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib

    tb, _ = batch12
    with pytest.raises(NotImplementedError):
        tbatched.solve_batched(tb, device="cpu", solve_mode="pcg")
    r = tbatched.solve_batched(tb, mesh=mesh_lib.make_mesh(axis_names=("batch",),
                                                           devices=["cpu"] * 3))
    np.testing.assert_array_equal(r.objective, tbatched.solve_batched(tb, device="cpu").objective)


def test_phase_plan_and_cleanup_budget_match_the_jax_package():
    for cfg in (SolverConfig(), SolverConfig(max_iter=50), SolverConfig(solve_mode="pcg"),
                SolverConfig(factor_dtype="float32")):
        for entries in (None, 128 * 512, 1 << 24):
            assert tbatched._phase_plan(cfg, entries, "cpu") == jbatched._phase_plan(cfg, entries)
            assert (tbatched.cleanup_solo_max_iter(cfg, entries)
                    == jbatched.cleanup_solo_max_iter(cfg, entries))
    for B in (1, 12, 64, 1024):
        assert tbatched._cleanup_cap(B) == jbatched._cleanup_cap(B)


def test_member_interior_form_matches_the_jax_package(batch12):
    tb, jb = batch12
    ti, ji = tbatched.member_interior_form(tb, 7), jbatched.member_interior_form(jb, 7)
    for f in ("c", "A", "b", "u", "col_kind", "col_orig", "col_shift", "col_sign"):
        assert np.array_equal(getattr(ti, f), getattr(ji, f))
    assert ti.name == ji.name and ti.orig_n == ji.orig_n


def test_entry_point_raises_without_a_card(batch12, monkeypatch):
    tb, _ = batch12
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatched.solve_batched(tb)
