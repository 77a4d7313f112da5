"""The torch package's PDHG tier (``backends/first_order.py``) against the
JAX package's, on the CPU.

* The power iteration's start vector (``utils/threefry.py``) against
  ``jax.random.normal``: the uniform draws bit for bit in f64 and f32,
  the normal within 1e-14 relative in f64; in f32 within 4 units in the
  last place (XLA's f32 ``log1p`` is not reproduced; ROADMAP Queue 3).
  The step size η within 1e-12 relative in f64.
* The solo backend (``pdlp``) on the cases of the JAX package's
  ``tests/test_first_order.py`` (the mesh case aside): equal status and
  iterations, objectives within 1e-9 relative.
* The bucket engine ``solve_pdhg_bucket``: per lane equal status and
  iterations and x within 1e-8; two dispatches bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from distributedlpsolver_tpu.backends import first_order as jfo
from distributedlpsolver_tpu.ipm import solve as jax_solve
from distributedlpsolver_tpu.ipm.config import SolverConfig as JaxConfig
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.models.problem import to_interior_form as jax_interior
from distributedlpsolver_tpu_torch.backends import batched as tbatched
from distributedlpsolver_tpu_torch.backends import first_order as tfo
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.ipm import Status, solve
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.models import generators as tgen
from distributedlpsolver_tpu_torch.models.problem import LPProblem, to_interior_form
from distributedlpsolver_tpu_torch.utils import threefry

from tests.oracle import highs_on_general
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")


def _pair(name, *args, **kw):
    jp = getattr(jgen, name)(*args, **kw)
    if hasattr(tgen, name):
        return getattr(tgen, name)(*args, **kw), jp
    return LPProblem(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(LPProblem)}), jp


def _pdlp(**kw):
    return get_backend("pdlp", device="cpu", **kw)


def _key(seed):
    return jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))


SEEDS = [0, 1, 29, 12345, 0x7FFFFFFF]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", SEEDS)
def test_start_vector_matches_jax_random_normal(seed, dtype):
    for n in (1, 7, 64, 513, 10240):
        lo = np.nextafter(np.array(-1.0, dtype), np.array(0.0, dtype), dtype=dtype)
        u_jax = np.asarray(jax.random.uniform(_key(seed), (n,), dtype, lo, 1.0))
        np.testing.assert_array_equal(threefry.uniform(seed, n, dtype, lo, 1.0), u_jax)
        v_jax = np.asarray(jax.random.normal(_key(seed), (n,), dtype))
        v = threefry.normal(seed, n, dtype)
        assert v.dtype == dtype
        if dtype == np.float64:
            assert np.max(np.abs(v - v_jax) / np.abs(v_jax)) <= 1e-14
        else:
            ulps = np.abs(v.view(np.int32).astype(np.int64) - v_jax.view(np.int32).astype(np.int64))
            assert ulps.max() <= 4


@pytest.mark.parametrize("name, args", [
    ("random_dense_lp", (16, 48)),
    ("random_general_lp", (30, 60)),
    ("random_dense_lp", (128, 512)),
])
@pytest.mark.parametrize("seed", [0, 7])
def test_step_size_matches_the_jax_package(name, args, seed):
    """η = 0.9/‖A‖₂ from 30 power iterations from the same start vector."""
    pt, pj = _pair(name, *args, seed=seed)
    it, ij = to_interior_form(pt), jax_interior(pj)
    A = np.asarray(ij.A)
    nrm_j = float(jfo._estimate_norm(lambda v: jnp.asarray(A) @ v, lambda v: jnp.asarray(A).T @ v,
                                     A.shape[1], jnp.float64, seed=seed))
    At = torch.as_tensor(A)
    nrm_t = float(tfo._estimate_norm(lambda v: At @ v, lambda v: At.T @ v, A.shape[1],
                                     torch.float64, CPU, seed=seed))
    assert abs(nrm_t - nrm_j) <= 1e-12 * nrm_j
    # And through each backend's setup (seed = crc32 of the problem's name).
    cfg_t, cfg_j = SolverConfig(), JaxConfig()
    bt, bj = _pdlp(), jfo.FirstOrderBackend()
    bt.setup(it, cfg_t)
    bj.setup(ij, cfg_j)
    assert abs(bt._eta - bj._eta) <= 1e-12 * bj._eta


def _rel(a, b):
    return abs(a - b) / (1 + abs(b))


def test_dense_matches_highs():
    pt, pj = _pair("random_general_lp", 30, 60, seed=0)
    ref = highs_on_general(pj)
    r = solve(pt, backend=_pdlp(), tol=1e-6, max_iter=100)
    rj = jax_solve(pj, backend="pdlp", tol=1e-6, max_iter=100)
    assert r.status == Status.OPTIMAL and r.backend == "pdlp"
    assert r.objective == pytest.approx(ref.fun, abs=1e-4 * (1 + abs(ref.fun)))
    assert pt.max_violation(r.x) < 1e-4
    assert r.status.value == rj.status.value and r.iterations == rj.iterations
    assert _rel(r.objective, rj.objective) <= 1e-9


def test_sparse_path_matches_dense():
    """Sparse A: a torch sparse CSR product where the JAX package uses BCOO."""
    pt, pj = _pair("block_angular_lp", 3, 12, 20, 6, seed=2, sparse=True)
    assert sp.issparse(pt.A)
    ref = highs_on_general(pj)
    be = _pdlp()
    r = solve(pt, backend=be, tol=1e-6, max_iter=200, presolve=False)
    rj = jax_solve(pj, backend="pdlp", tol=1e-6, max_iter=200, presolve=False)
    assert be._sparse and be._A.layout == torch.sparse_csr
    assert r.status == Status.OPTIMAL
    assert r.objective == pytest.approx(ref.fun, abs=1e-3 * (1 + abs(ref.fun)))
    assert r.status.value == rj.status.value and r.iterations == rj.iterations
    assert _rel(r.objective, rj.objective) <= 1e-9


def test_iteration_limit_reported_not_nan():
    pt, pj = _pair("random_general_lp", 40, 80, seed=3)
    r = solve(pt, backend=_pdlp(), tol=1e-12, max_iter=2)
    rj = jax_solve(pj, backend="pdlp", tol=1e-12, max_iter=2)
    assert r.status in (Status.ITERATION_LIMIT, Status.OPTIMAL)
    assert np.isfinite(r.rel_gap)
    assert r.status.value == rj.status.value and r.iterations == rj.iterations == 800
    assert _rel(r.objective, rj.objective) <= 1e-9


def test_registered_names():
    from distributedlpsolver_tpu_torch.backends import available_backends

    for name in ("pdlp", "first-order", "pdhg"):
        assert name in available_backends()


@pytest.mark.parametrize("kw", [
    {"segment_iters": 1},
    {"segment_iters": 0},
    {"fused_loop": False},
    {"factor_dtype": "float32"},
], ids=["segmented", "fused", "host_loop", "f32"])
def test_loops_match_the_jax_package(kw):
    """Host-segmented bursts (ω and the restart baseline carried across),
    the one fused loop, the driver's host loop over 400-step ``iterate``
    bursts, and the f32 working precision, against the JAX package's
    same paths. The f32 start vector differs from JAX's in the last place
    (see the module note), so f32 is held at the verdict and to 1e-4."""
    pt, pj = _pair("random_general_lp", 30, 60, seed=11)
    r = solve(pt, backend=_pdlp(), tol=1e-6, max_iter=100, **kw)
    rj = jax_solve(pj, backend="pdlp", tol=1e-6, max_iter=100, **kw)
    assert r.status == Status.OPTIMAL and r.status.value == rj.status.value
    if kw.get("factor_dtype") == "float32":
        assert _rel(r.objective, rj.objective) <= 1e-4
    else:
        assert r.iterations == rj.iterations
        assert _rel(r.objective, rj.objective) <= 1e-9


def test_solo_runs_are_bitwise_deterministic():
    p, tol = next(iter(tgen.sparse_request_stream(1, seed=28)))
    r1 = solve(p, backend=_pdlp(), tol=tol)
    r2 = solve(p, backend=_pdlp(), tol=tol)
    assert r1.objective == r2.objective


def test_mesh_is_not_ported():
    """The solo engine's column mesh solves (``test_torch_first_order_mesh.py``
    holds it against the JAX package): over a local mesh of 2 at an odd n
    the answer is OPTIMAL with x of the problem's width. The bucket's lane
    mesh (item 13b): over a local mesh of 2 the lanes keep their unsharded
    bits (``test_torch_batch_mesh.py`` holds the rest)."""
    from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib

    p = tgen.random_dense_lp(12, 31, seed=3)
    be = tfo.FirstOrderBackend(mesh=mesh_lib.make_mesh(devices=["cpu"] * 2))
    r = solve(p, backend=be, tol=1e-6)
    assert r.status == Status.OPTIMAL and r.x.shape == (31,) and be._n_pad == 1
    batch, act = tgen.random_batched_lp(2, 4, 8), np.ones(2, bool)
    mesh = mesh_lib.make_mesh(axis_names=("batch",), devices=["cpu"] * 2)
    r = tfo.solve_pdhg_bucket(batch, act, mesh=mesh)
    r0 = tfo.solve_pdhg_bucket(batch, act, device="cpu")
    np.testing.assert_array_equal(r.x, r0.x)
    assert r.phase_report[0]["executors"] == 2


@pytest.mark.parametrize("B, m, n, seed, tol", [
    (4, 12, 32, 29, 1e-4),
    (8, 16, 64, 3, 1e-4),
    (8, 16, 64, 5, 1e-6),
])
def test_bucket_matches_the_jax_package(B, m, n, seed, tol):
    bt, bj = tgen.random_batched_lp(B, m, n, seed=seed), jgen.random_batched_lp(B, m, n, seed=seed)
    active = np.ones(B, dtype=bool)
    active[-1] = False  # one padding slot
    rj = jfo.solve_pdhg_bucket(bj, active, JaxConfig(tol=tol))
    r1 = tfo.solve_pdhg_bucket(bt, active, SolverConfig(tol=tol), device="cpu")
    size = tbatched.bucket_cache_size()
    r2 = tfo.solve_pdhg_bucket(bt, active, SolverConfig(tol=tol), device="cpu")
    assert tbatched.bucket_cache_size() == size  # the second dispatch builds nothing
    assert [s.value for s in r1.status] == [s.value for s in rj.status]
    np.testing.assert_array_equal(r1.iterations, rj.iterations)
    np.testing.assert_allclose(r1.x, rj.x, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(r1.x, r2.x)  # slot-seeded: bit for bit
    # The contract: padding slots report the placeholder OPTIMAL at 0
    # iterations; OPTIMAL only at the request tol; no warm-cache seed.
    assert r1.status[-1] == Status.OPTIMAL and r1.iterations[-1] == 0
    opt = (r1.status == Status.OPTIMAL) & active
    assert np.all(np.maximum(r1.rel_gap, np.maximum(r1.pinf, r1.dinf))[opt] <= tol)
    assert r1.y is None and r1.fused_iters == 40
    row = r1.phase_report[0]
    assert row["engine"] == "pdhg" and row["tol"] == tol and row["iters"] == r1.iterations.max()
    assert r2.phase_report[0]["built"] is False


def test_bucket_budget_ends_at_the_iteration_limit():
    """``max_iter`` counts bursts of 400 inner steps; a lane that misses
    the request tol in its budget is ITERATION_LIMIT, as in the JAX
    package."""
    bt, bj = tgen.random_batched_lp(4, 12, 32, seed=29), jgen.random_batched_lp(4, 12, 32, seed=29)
    active = np.ones(4, dtype=bool)
    r = tfo.solve_pdhg_bucket(bt, active, SolverConfig(tol=1e-10), max_iter=1, device="cpu")
    rj = jfo.solve_pdhg_bucket(bj, active, JaxConfig(tol=1e-10), max_iter=1)
    assert [s.value for s in r.status] == [s.value for s in rj.status]
    assert set(s.value for s in r.status) == {"iteration_limit"}
    np.testing.assert_array_equal(r.iterations, rj.iterations)
    assert r.iterations.max() == 400


# -- a lane's step size follows its request, not its slot ---------------------


def _padded_requests(B, m, n, count, seed):
    """``count`` sparse-stream requests padded into one (m, n) bucket, as
    the serve layer pads them (``serve.pad_standard_form``)."""
    from distributedlpsolver_tpu_torch.serve import pad_standard_form, standard_form

    stream = list(tgen.sparse_request_stream(count, shapes=((m - 4, n - 8),), seed=seed))
    return [(p.name, tol, pad_standard_form(*standard_form(p), m, n)) for p, tol in stream]


def _bucket(lanes, B):
    """A BatchedLP of the padded ``lanes`` (name, tol, (c, A, b)), the
    remaining slots copies of lane 0 (inactive)."""
    rows = [c_A_b for _, _, c_A_b in lanes] + [lanes[0][2]] * (B - len(lanes))
    return tgen.BatchedLP(c=np.stack([r[0] for r in rows]), A=np.stack([r[1] for r in rows]),
                          b=np.stack([r[2] for r in rows]))


def test_pdhg_seed_is_the_solo_backends_crc32_modulo_the_bucket():
    import zlib

    for name in ("sparse_req_96x384_r402", "random_dense_8x24_s3", "x"):
        for B in (1, 8, 256):
            assert tfo.pdhg_seed(name, B) == (zlib.crc32(name.encode()) & 0x7FFFFFFF) % B
    # The sweep's case: r402 takes row 70 of a 256-slot bucket's table.
    assert tfo.pdhg_seed("sparse_req_96x384_r402", 256) == 70


@pytest.mark.parametrize("B, m, n, seed", [(8, 16, 40, 31), (4, 12, 32, 32)])
def test_a_lanes_step_size_is_the_jax_norm_estimate_at_its_seed(B, m, n, seed):
    """η of each lane equals 0.9 / the JAX package's ``_estimate_norm(seed=
    pdhg_seed(name, B))`` on the lane's padded A, within 1e-12 relative."""
    lanes = _padded_requests(B, m, n, B - 1, seed)
    seeds = np.arange(B)
    seeds[: len(lanes)] = [tfo.pdhg_seed(name, B) for name, _, _ in lanes]
    active = np.arange(B) < len(lanes)
    tfo.solve_pdhg_bucket(_bucket(lanes, B), active, SolverConfig(tol=1e-4), max_iter=1,
                          device="cpu", seeds=seeds)
    eta = tfo._PROGRAMS[(B, m, n, torch.float64, CPU)].eta.numpy()
    for k, (name, _, (_, A, _)) in enumerate(lanes):
        Aj = jnp.asarray(A)
        nrm = float(jfo._estimate_norm(lambda v: Aj @ v, lambda v: Aj.T @ v, n, jnp.float64,
                                       seed=int(seeds[k])))
        ref = 0.9 / max(nrm, 1e-12)
        assert abs(eta[k] - ref) <= 1e-12 * ref, (k, name)


def test_a_request_in_two_slots_gives_the_same_x_bit_for_bit():
    """The same request at slot 0 of one dispatch and slot 5 of another
    (other requests around it) gets the same seed, so the same x bit for
    bit: its verdict no longer depends on where arrival timing put it."""
    B, m, n = 8, 16, 40
    lanes = _padded_requests(B, m, n, 6, 33)
    order_a = lanes
    order_b = lanes[1:6] + [lanes[0]]
    out = []
    for order in (order_a, order_b):
        seeds = np.arange(B)
        seeds[: len(order)] = [tfo.pdhg_seed(name, B) for name, _, _ in order]
        r = tfo.solve_pdhg_bucket(_bucket(order, B), np.arange(B) < len(order),
                                  SolverConfig(tol=1e-4), device="cpu", seeds=seeds)
        out.append({name: (r.status[k].value, r.x[k].copy(), int(r.iterations[k]))
                    for k, (name, _, _) in enumerate(order)})
    for name in out[0]:
        assert out[0][name][0] == out[1][name][0]
        assert out[0][name][2] == out[1][name][2]
        np.testing.assert_array_equal(out[0][name][1], out[1][name][1])


def test_the_jax_bucket_with_the_request_at_its_seed_slot_gives_its_verdict():
    """The unedited JAX engine seeds lane k with k: a request placed at
    slot ``pdhg_seed(name, B)`` there runs the port lane's power
    iteration, so the verdicts agree and objectives within 1e-9."""
    B, m, n = 8, 16, 40
    lanes = _padded_requests(B, m, n, 6, 34)
    seeds = np.arange(B)
    seeds[: len(lanes)] = [tfo.pdhg_seed(name, B) for name, _, _ in lanes]
    r = tfo.solve_pdhg_bucket(_bucket(lanes, B), np.arange(B) < len(lanes),
                              SolverConfig(tol=1e-4), device="cpu", seeds=seeds)
    for k, (name, tol, (c, A, b)) in enumerate(lanes):
        slot = int(seeds[k])
        # The request at its seed slot, every slot filled with it.
        bj = jgen.BatchedLP(c=np.stack([c] * B), A=np.stack([A] * B), b=np.stack([b] * B))
        active = np.zeros(B, dtype=bool)
        active[slot] = True
        rj = jfo.solve_pdhg_bucket(bj, active, JaxConfig(tol=1e-4))
        assert r.status[k].value == rj.status[slot].value, name
        assert int(r.iterations[k]) == int(rj.iterations[slot]), name
        ref = float(rj.objective[slot])
        assert abs(float(r.objective[k]) - ref) <= 1e-9 * (1 + abs(ref)), name


def test_seeds_must_index_the_table():
    bt = tgen.random_batched_lp(4, 6, 12, seed=1)
    with pytest.raises(ValueError, match="seeds"):
        tfo.solve_pdhg_bucket(bt, np.ones(4, bool), SolverConfig(tol=1e-4), device="cpu",
                              seeds=[0, 1, 2, 4])


def test_service_pdhg_verdicts_do_not_depend_on_arrival_order():
    """Two services get the same loose requests in opposite orders: each
    request gets the same x bit for bit and the same verdict."""
    from distributedlpsolver_tpu_torch.serve import ServiceConfig, SolveService

    stream = list(tgen.sparse_request_stream(12, shapes=((12, 32),), seed=35))
    runs = []
    for order in (stream, stream[::-1]):
        with SolveService(ServiceConfig(batch=8, flush_s=0.01), device="cpu",
                          auto_start=False) as svc:
            futs = {p.name: svc.submit(p, tol=tol) for p, tol in order}
            svc.start()
            svc.drain(timeout=120)
            runs.append({k: f.result() for k, f in futs.items()})
    for name, r0 in runs[0].items():
        r1 = runs[1][name]
        assert r0.engine == r1.engine == "pdhg"
        assert (r0.status, r0.iterations) == (r1.status, r1.iterations)
        np.testing.assert_array_equal(r0.x, r1.x)
