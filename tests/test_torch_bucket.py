"""The torch bucket engine (``backends/batched.py::solve_bucket``) against
the JAX package's, on the CPU: padded buckets with padding slots frozen,
the in-program warm selection slot by slot, the segmented drive, the
one-program-per-key cache, the refusals, and ``solve(warm_cache=...)``.

The same seeded inputs go through both packages; the JAX side runs on
the CPU as its own tests run it. Tolerances: equal statuses, iterations
and ``warm_used``; objectives within 1e-8 relative; x within 1e-7.
"""

import numpy as np
import pytest

from distributedlpsolver_tpu.backends import batched as jbatched
from distributedlpsolver_tpu.ipm import solve as jsolve
from distributedlpsolver_tpu.ipm.config import SolverConfig as JConfig
from distributedlpsolver_tpu.ipm.state import IPMState as JState
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.serve.warmcache import WarmCache as JWarmCache
from distributedlpsolver_tpu_torch.backends import batched as tbatched
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.ipm import solve
from distributedlpsolver_tpu_torch.ipm.state import IPMState, Status
from distributedlpsolver_tpu_torch.models.generators import (
    BatchedLP,
    correlated_request_stream,
    random_dense_lp,
)
from distributedlpsolver_tpu_torch.serve import pad_standard_form, standard_form
from distributedlpsolver_tpu_torch.serve.warmcache import WarmCache
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"


def _bucket(problems, m, n, B):
    """The service's packing: each request padded onto (m, n), padding
    slots filled with copies of slot 0."""
    rows = [pad_standard_form(*standard_form(p), m, n) for p in problems]
    rows += [rows[0]] * (B - len(rows))
    c, A, b = (np.stack(v) for v in zip(*rows))
    return BatchedLP(c=c, A=A, b=b, name="bucket"), np.arange(B) < len(problems)


def _jax_batch(batch):
    return jgen.BatchedLP(c=batch.c, A=batch.A, b=batch.b, name=batch.name)


def _assert_same(rt, rj, mask=None):
    sel = slice(None) if mask is None else mask
    assert [s.value for s in rt.status] == [s.value for s in rj.status]
    assert np.array_equal(rt.iterations, np.asarray(rj.iterations))
    ot, oj = rt.objective[sel], np.asarray(rj.objective)[sel]
    assert np.all(np.abs(ot - oj) <= 1e-8 * (1 + np.abs(oj)))
    assert np.abs(rt.x[sel] - np.asarray(rj.x)[sel]).max() <= 1e-7


def _mixed_bucket(seed=0, B=8, live=6):
    probs = [random_dense_lp(12 if k % 2 else 8, 32 if k % 2 else 24, seed=seed + k)
             for k in range(live)]
    return _bucket(probs, 16, 64, B)


def test_solve_bucket_matches_the_jax_package_with_padding_frozen():
    batch, act = _mixed_bucket()
    rt = tbatched.solve_bucket(batch, act, device=CPU)
    rj = jbatched.solve_bucket(_jax_batch(batch), act)
    _assert_same(rt, rj, act)
    assert all(s is Status.OPTIMAL for s in rt.status)
    assert np.all(rt.iterations[~act] == 0) and np.all(rt.iterations[act] > 0)
    (row,) = rt.phase_report
    assert (row["engine"], row["tol"]) == ("f64", 1e-8)
    assert row["iters"] == rt.iterations.max() == int(np.asarray(rj.phase_report[0]["iters"]))


def test_solve_bucket_inactive_slots_frozen():
    """Padding slots (mask False) never iterate: zero iterations, the
    placeholder OPTIMAL, and the active slots' answers whatever the mask
    tail holds (the counterpart of the JAX package's test)."""
    base = random_dense_lp(8, 24, seed=2)
    batch, _ = _bucket([base] * 4, 8, 32, 4)
    res = tbatched.solve_bucket(batch, np.array([True, False, True, False]), device=CPU)
    assert res.status[0] == Status.OPTIMAL and res.status[2] == Status.OPTIMAL
    assert res.iterations[1] == 0 and res.iterations[3] == 0
    assert res.iterations[0] > 0
    np.testing.assert_allclose(res.x[0], res.x[2], rtol=1e-12)


def _correlated_bucket(seed):
    probs = list(correlated_request_stream(8, shapes=((12, 32),), n_models=2, seed=seed))
    return _bucket(probs, 16, 64, 8)


@pytest.mark.parametrize("scale", [1.0, 1e9])
def test_warm_select_takes_the_jax_packages_slots(scale):
    """The in-program safeguard picks, slot by slot, what the JAX
    package's picks: a correlated prior is accepted where offered, a
    far-off (1e9-scaled) one rejected; the solves then agree."""
    batch, act = _correlated_bucket(seed=31)
    cold_t = tbatched.solve_bucket(batch, act, device=CPU)
    cold_j = jbatched.solve_bucket(_jax_batch(batch), act)
    # Each slot is offered the iterate of the slot before it (same model
    # every other slot), the last few not offered at all.
    roll = lambda v: np.roll(np.asarray(v), 1, axis=0) * scale
    mask = np.array([True] * 6 + [False] * 2)
    wt = tbatched.solve_bucket(
        batch, act, device=CPU, warm_mask=mask,
        warm=IPMState(*(roll(getattr(cold_t, f)) for f in IPMState._fields)))
    wj = jbatched.solve_bucket(
        _jax_batch(batch), act, warm_mask=mask,
        warm=JState(*(roll(getattr(cold_j, f)) for f in JState._fields)))
    assert np.array_equal(wt.warm_used, np.asarray(wj.warm_used))
    assert wt.warm_used.any() == (scale == 1.0)
    assert not wt.warm_used[~mask].any()
    _assert_same(wt, wj)


def test_segmented_drive_matches_the_jax_package_and_the_whole_run():
    batch, act = _mixed_bucket(seed=40)
    whole = tbatched.solve_bucket(batch, act, device=CPU)
    seg = tbatched.solve_bucket(batch, act, device=CPU, segment_iters=3)
    rj = jbatched.solve_bucket(_jax_batch(batch), act, JConfig(segment_iters=3))
    _assert_same(seg, rj, act)
    assert np.array_equal(seg.x, whole.x) and np.array_equal(seg.iterations, whole.iterations)
    assert seg.phase_report[0]["runs"] > 1


def test_second_dispatch_reuses_the_program_and_a_fresh_one_gives_its_bits():
    """One program per bucket key: a second dispatch (new data, a new
    budget) builds nothing, and its answer is bit for bit what a freshly
    built program gives on the same inputs."""
    tbatched.release_bucket_programs()
    b1, a1 = _mixed_bucket(seed=50)
    b2, a2 = _mixed_bucket(seed=60, live=5)
    tbatched.solve_bucket(b1, a1, device=CPU)
    size = tbatched.bucket_cache_size()
    second = tbatched.solve_bucket(b2, a2, device=CPU, max_iter=150, reg_grow=50.0)
    assert tbatched.bucket_cache_size() == size
    assert second.phase_report[0]["built"] is False
    tbatched.release_bucket_programs()
    fresh = tbatched.solve_bucket(b2, a2, device=CPU, max_iter=150, reg_grow=50.0)
    assert fresh.phase_report[0]["built"] is True
    for f in ("x", "y", "s", "w", "z", "iterations", "objective", "warm_used"):
        assert np.array_equal(getattr(second, f), getattr(fresh, f)), f
    # A new tolerance is a new key.
    tbatched.solve_bucket(b2, a2, device=CPU, tol=1e-7)
    assert tbatched.bucket_cache_size() == 2


@pytest.mark.parametrize("kw, item", [
    ({"mesh": object()}, "item 13"),
    ({"bucket_schedule": "df32"}, "Queue 2"),
    ({"fused_iters": 2}, "item 5b"),
])
def test_unported_bucket_options_raise(kw, item):
    """The unported schedules raise naming their items. ``mesh`` (item 13,
    once refused) is ported: a local mesh gives the one-device bits, and
    an object that is not a mesh is refused."""
    batch, act = _mixed_bucket()
    if "mesh" in kw:
        from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib

        with pytest.raises(AttributeError):
            tbatched.solve_bucket(batch, act, **kw)
        mesh = mesh_lib.make_mesh(axis_names=("batch",), devices=[CPU] * 2)
        np.testing.assert_array_equal(tbatched.solve_bucket(batch, act, mesh=mesh).x,
                                      tbatched.solve_bucket(batch, act, device=CPU).x)
        return
    with pytest.raises(NotImplementedError, match=item):
        tbatched.solve_bucket(batch, act, device=CPU, **kw)


def test_bucket_donation_report_is_none_on_the_cpu():
    assert tbatched.bucket_donation_report(16, 64, 4, device=CPU) is None


def test_solve_with_a_warm_cache_matches_the_jax_driver():
    """``solve(warm_cache=...)``: the first solve stores its iterate and
    Ruiz scaling, the next same-structure request starts warm from them,
    in the JAX driver's iterations and objective."""
    reqs = list(correlated_request_stream(3, n_models=1, seed=15))
    jreqs = list(jgen.correlated_request_stream(3, n_models=1, seed=15))
    cache, jcache = WarmCache(4), JWarmCache(4)
    be = get_backend("cuda", device=CPU)
    for k, (p, pj) in enumerate(zip(reqs, jreqs)):
        rt = solve(p, backend=be, warm_cache=cache)
        rj = jsolve(pj, backend="tpu", warm_cache=jcache)
        assert rt.warm == rj.warm == ("cold" if k == 0 else "warm")
        assert rt.status is Status.OPTIMAL and rt.iterations == rj.iterations
        assert abs(rt.objective - rj.objective) <= 1e-8 * (1 + abs(rj.objective))
    entry = next(iter(cache._entries.values()))
    assert entry.scaling is not None and entry.scaled_A is not None
    cold = solve(reqs[2], backend=be)
    assert rt.iterations < cold.iterations
