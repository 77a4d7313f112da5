"""Warm starts in the port (``ipm/warm.py`` and ``solve(warm_start=...)``)
against the JAX package, on the CPU.

The prior iterate is the port's own optimum of a random general LP; the
warm-started problem is the same structure with b and c perturbed by a
seeded 1e-3 relative noise (the correlated re-solve warm starts exist
for). Both packages get the same numpy inputs.
"""

import dataclasses

import numpy as np
import pytest

from distributedlpsolver_tpu.ipm import solve as jax_solve
from distributedlpsolver_tpu.ipm import warm as jwarm
from distributedlpsolver_tpu.ipm.state import IPMState as JaxState
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.models.problem import to_interior_form as jax_to_interior_form
from distributedlpsolver_tpu.obs import metrics as jax_metrics
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.ipm import Status, solve
from distributedlpsolver_tpu_torch.ipm import warm as twarm
from distributedlpsolver_tpu_torch.ipm.state import IPMState
from distributedlpsolver_tpu_torch.models import generators as tgen
from distributedlpsolver_tpu_torch.models.problem import to_interior_form
from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics


def _cpu():
    return get_backend("cuda", device="cpu")


def _rel(a, b):
    return abs(a - b) / (1.0 + abs(b))


@pytest.fixture(scope="module")
def case():
    """(port interior form, JAX interior form, prior host state) of the
    perturbed problem and the prior optimum."""
    pt, pj = tgen.random_general_lp(12, 30, seed=1), jgen.random_general_lp(12, 30, seed=1)
    it, ij = to_interior_form(pt), jax_to_interior_form(pj)
    r0 = solve(it, backend=_cpu(), tol=1e-8)
    assert r0.status == Status.OPTIMAL
    rng = np.random.default_rng(7)
    b1 = it.b * (1.0 + 1e-3 * rng.standard_normal(it.b.shape))
    c1 = it.c * (1.0 + 1e-3 * rng.standard_normal(it.c.shape))
    it1 = dataclasses.replace(it, b=b1, c=c1)
    ij1 = dataclasses.replace(ij, b=b1.copy(), c=c1.copy())
    hub = np.isfinite(it.u)
    x = np.asarray(r0.x)
    prior = dict(x=x, y=np.asarray(r0.y), s=np.asarray(r0.s),
                 w=np.where(hub, np.where(hub, it.u, 1.0) - x, 1.0),
                 z=np.where(hub, 1e-3, 0.0))
    return it1, ij1, prior


def _states(prior, scale=1.0):
    host = {k: scale * np.asarray(v, dtype=np.float64) for k, v in prior.items()}
    return IPMState(**host), JaxState(**{k: v.copy() for k, v in host.items()})


def test_host_helpers_equal_the_jax_package_bit_for_bit(case):
    it1, ij1, _ = case
    rng = np.random.default_rng(3)
    n, m = it1.c.shape[0], it1.b.shape[0]
    host = dict(x=rng.uniform(0.1, 2.0, n), y=rng.standard_normal(m), s=rng.uniform(0.1, 2.0, n),
                w=rng.uniform(0.1, 2.0, n), z=rng.uniform(0.1, 2.0, n))
    st, sj = _states(host)
    ct, cj = twarm.interior_candidate(st, it1), jwarm.interior_candidate(sj, ij1)
    for a, b in zip(ct, cj):
        assert np.array_equal(a, b)
    assert twarm.residual_merit(it1, st) == jwarm.residual_merit(ij1, sj)
    assert twarm.state_mu(st, it1.u) == jwarm.state_mu(sj, ij1.u)
    assert twarm.residual_merit(it1, ct) == jwarm.residual_merit(ij1, cj)
    for name in ("WARM_ACCEPT_FACTOR", "MU_ACCEPT_FACTOR", "INTERIOR_FLOOR", "CENTRALITY_BETA",
                 "MERIT_MU_FLOOR", "PROJECT_MAX_M"):
        assert getattr(twarm, name) == getattr(jwarm, name)


@pytest.mark.parametrize("kind", ["WarmStart", "IPMState"])
def test_warm_solve_matches_the_jax_driver(case, kind):
    """A safeguarded ``WarmStart``, and a raw ``IPMState`` (trusted
    verbatim; here the safeguard's own interior candidate): same status,
    iterations and start label as the JAX driver, objective within 1e-9;
    and fewer iterations than the cold start."""
    it1, ij1, prior = case
    st, sj = _states(prior)
    if kind == "WarmStart":
        wt, wj = twarm.WarmStart(st, source="test"), jwarm.WarmStart(sj, source="test")
    else:
        wt = twarm.interior_candidate(st, it1)
        wj = JaxState(*(np.array(v) for v in wt))
    rt = solve(it1, backend=_cpu(), tol=1e-8, warm_start=wt)
    rj = jax_solve(ij1, backend="tpu", tol=1e-8, warm_start=wj)
    cold = solve(it1, backend=_cpu(), tol=1e-8)
    assert rt.status == Status.OPTIMAL and rj.status.value == "optimal"
    assert rt.iterations == rj.iterations < cold.iterations
    assert _rel(rt.objective, rj.objective) <= 1e-9
    assert _rel(rt.objective, cold.objective) <= 1e-8
    assert rt.warm == rj.warm == ("warm" if kind == "WarmStart" else "cold")


def test_scaled_prior_is_rejected_like_the_jax_driver(case):
    it1, ij1, prior = case
    st, sj = _states(prior, scale=1e9)
    counts = {}
    for name, metrics, run in (
        ("torch", obs_metrics,
         lambda: solve(it1, backend=_cpu(), tol=1e-8, warm_start=twarm.WarmStart(st))),
        ("jax", jax_metrics,
         lambda: jax_solve(ij1, backend="tpu", tol=1e-8, warm_start=jwarm.WarmStart(sj))),
    ):
        reg = metrics.MetricsRegistry()
        prev = metrics.set_registry(reg)
        try:
            r = run()
        finally:
            metrics.set_registry(prev)
        counts[name] = (int(reg.snapshot().get("warm_start_rejected_total", 0)), r)
    (nt, rt), (nj, rj) = counts["torch"], counts["jax"]
    assert nt == nj == 1
    assert rt.warm == rj.warm == "rejected"
    cold = solve(it1, backend=_cpu(), tol=1e-8)
    assert rt.status == Status.OPTIMAL and rt.iterations == cold.iterations == rj.iterations
    assert _rel(rt.objective, rj.objective) <= 1e-9


def test_warm_cache_still_raises(case):
    """The warm cache is ported now (it raised before): on an interior
    form it is left unused, as by the JAX driver — nothing looked up,
    nothing stored, the cold answer."""
    from distributedlpsolver_tpu.serve.warmcache import WarmCache as JaxWarmCache
    from distributedlpsolver_tpu_torch.serve.warmcache import WarmCache

    it1, ij1, _ = case
    cache, jcache = WarmCache(2), JaxWarmCache(2)
    rt = solve(it1, backend=_cpu(), tol=1e-8, warm_cache=cache)
    rj = jax_solve(ij1, backend="tpu", tol=1e-8, warm_cache=jcache)
    assert cache.stats() == jcache.stats()
    assert cache.stats()["stores"] == 0 and rt.warm == rj.warm == "cold"
    assert rt.iterations == rj.iterations and _rel(rt.objective, rj.objective) <= 1e-9
