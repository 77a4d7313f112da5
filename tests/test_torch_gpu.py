"""The CUDA kernel against its plain version (one matrix and a batch of
lanes), the fused loop (a captured CUDA graph of the Mehrotra step)
against the host loop, the batched solver against its CPU path, and the
bucket engine and solve service (one captured graph per bucket, reused),
the sparse tier's hybrid-ELL kernel against its plain version and a
``sparse-iterative`` solve, the block and scenario tiers' solves, and
the sharded backend (an NCCL world of one against ``cuda`` bit for bit,
a gloo world of two ranks sharing the card, NCCL refused beyond the card
count), on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card, which
skips the test where there is none. Run on a machine with a card with
``python -m pytest tests/test_torch_gpu.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from distributedlpsolver_tpu_torch.backends import batched as tbatched
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.ipm import Status, solve
from distributedlpsolver_tpu_torch.models import random_batched_lp, random_dense_lp
from distributedlpsolver_tpu_torch.models.problem import LPProblem
from distributedlpsolver_tpu_torch.obs import metrics as obs_metrics
from distributedlpsolver_tpu_torch.ops import normal_eq, normal_eq_reference

pytestmark = pytest.mark.gpu

# Frobenius-relative error of the kernel's lower triangle against the
# plain version's (the kernel computes the lower triangle and mirrors it,
# so M must also equal Mᵀ bit for bit).
TOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(m, n, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    A = torch.tensor(rng.standard_normal((m, n)), device=device).to(dtype)
    d = torch.tensor(rng.random(n) + 0.1, device=device).to(dtype)
    return A, d


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
# (129, 515) and (65, 1001) lie one row past a 64-row tile edge, (97, 333)
# halfway into a tile; odd n makes f64 take its 8-byte copies, and
# (130, 514) gives its 16-byte copies a zero-filled last k chunk.
@pytest.mark.parametrize(
    "m,n",
    [(256, 1024), (37, 101), (1000, 3001), (1, 7), (129, 515), (128, 4096), (65, 1001), (97, 333),
     (130, 514)],
)
def test_kernel_matches_plain_version(cuda, dtype, m, n):
    A, d = _inputs(m, n, dtype, cuda)
    out = torch.float32 if dtype == torch.bfloat16 else dtype
    before = normal_eq.launches
    M = normal_eq(A, d, out_dtype=out)
    torch.cuda.synchronize()
    assert normal_eq.launches == before + 1
    assert torch.equal(M, M.T)
    L, R = torch.tril(M).double(), torch.tril(normal_eq_reference(A, d, out_dtype=out)).double()
    err = ((L - R).norm() / R.norm()).item()
    assert err <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n", [(129, 515), (300, 1001)])
def test_kernel_output_is_symmetric_and_deterministic(cuda, dtype, m, n):
    """M equals Mᵀ bit for bit (each pair is stored from one value), and a
    second launch on the same inputs gives the same bits (no atomics)."""
    A, d = _inputs(m, n, dtype, cuda, seed=3)
    M1 = normal_eq(A, d)
    M2 = normal_eq(A, d)
    torch.cuda.synchronize()
    assert torch.equal(M1, M1.T)
    assert torch.equal(M1, M2)


def test_f64_kernel_on_a_misaligned_view(cuda):
    """An A that starts 8 bytes past a 16-byte boundary (n even) takes the
    kernel's 8-byte copies and gives the same M as an aligned copy."""
    m, n = 130, 514
    A, d = _inputs(m, n, torch.float64, cuda, seed=5)
    flat = torch.empty(m * n + 1, dtype=torch.float64, device=cuda)
    view = flat[1:].view(m, n)
    view.copy_(A)
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    M = normal_eq(view, d)
    torch.cuda.synchronize()
    assert torch.equal(M, normal_eq(A, d))


def test_bf16_output(cuda):
    """bf16 input gives f32 output, and the kernel rounds the scaled
    product to bf16: it is far closer to the rounded plain version than
    to the same product taken without that rounding."""
    A, d = _inputs(256, 4096, torch.bfloat16, cuda)
    M = normal_eq(A, d)
    assert M.dtype == torch.float32
    R = torch.tril(normal_eq_reference(A, d)).double()
    unrounded = torch.tril((A.double() * d.double()[None, :]) @ A.double().T)
    err = ((torch.tril(M).double() - R).norm() / R.norm()).item()
    rounding = ((unrounded - R).norm() / R.norm()).item()
    assert err <= TOL[torch.bfloat16] and err <= rounding / 10


def test_wrapper_rejects_non_contiguous(cuda):
    A, d = _inputs(16, 32, torch.float64, cuda)
    with pytest.raises(ValueError):
        normal_eq(A.T.contiguous().T, d)


def test_solve_on_the_card_launches_the_kernel(cuda):
    p = random_dense_lp(64, 192, seed=0)
    normal_eq.launches = 0
    r = solve(p, backend=get_backend("cuda"), tol=1e-8)
    assert r.status == Status.OPTIMAL
    assert normal_eq.launches >= r.iterations + 1
    rc = solve(p, backend=get_backend("cuda", device="cpu"), tol=1e-8)
    assert abs(r.objective - rc.objective) <= 1e-8 * (1 + abs(rc.objective))


def test_main_path_launches_once_per_factorization(cuda):
    """One kernel launch for each factorization of the solve: the starting
    point and one per body of the fused loop (accepted, bad, or run past
    the exit), the graph's replays included and its capture not."""
    p = random_dense_lp(256, 1024, seed=0)
    be = get_backend("cuda")
    normal_eq.launches = 0
    r = solve(p, backend=be, tol=1e-8)
    launches = normal_eq.launches
    (row,) = be.phase_report
    assert r.status == Status.OPTIMAL
    assert row["eager"] == 1 and row["replays"] >= 1 and row["capture_ms"] > 0
    assert row["bodies"] == r.iterations + row["bad_steps"] + row["masked"]
    assert row["masked"] <= 1
    assert launches == 1 + row["bodies"]


def test_host_loop_launches_once_per_factorization(cuda):
    """The host loop: the starting point, one per iteration and one per
    bad-step refactorization."""
    p = random_dense_lp(256, 1024, seed=0)
    reg = obs_metrics.MetricsRegistry()
    prev = obs_metrics.set_registry(reg)
    try:
        normal_eq.launches = 0
        r = solve(p, backend="cuda", tol=1e-8, fused_loop=False)
        launches = normal_eq.launches
    finally:
        obs_metrics.set_registry(prev)
    refactors = int(reg.snapshot().get("ipm_refactorizations_total", 0))
    assert r.status == Status.OPTIMAL
    assert launches == 1 + r.iterations + refactors


@pytest.mark.parametrize("m,n", [(256, 1024), (1000, 3001)])
def test_fused_loop_gives_the_host_loops_bits(cuda, m, n):
    """The graph replays the kernels the host loop launches, on the same
    data: same iterations, the same x bit for bit, segmented or not."""
    p = random_dense_lp(m, n, seed=0)
    rh = solve(p, backend="cuda", tol=1e-8, fused_loop=False)
    rf = solve(p, backend="cuda", tol=1e-8)
    rs = solve(p, backend="cuda", tol=1e-8, segment_iters=4)
    assert rh.status == rf.status == rs.status == Status.OPTIMAL
    assert rh.iterations == rf.iterations == rs.iterations
    assert np.array_equal(rf.x, rh.x) and np.array_equal(rs.x, rf.x)
    assert [h.rel_gap for h in rf.history] == [h.rel_gap for h in rh.history]


def test_second_solve_recaptures_and_gives_the_same_bits(cuda):
    p = random_dense_lp(256, 1024, seed=1)
    runs = []
    for _ in range(2):
        be = get_backend("cuda")
        normal_eq.launches = 0
        r = solve(p, backend=be, tol=1e-8)
        runs.append((r, normal_eq.launches, be.phase_report[0]))
    (r1, l1, row1), (r2, l2, row2) = runs
    assert row1["capture_ms"] > 0 and row2["capture_ms"] > 0
    assert l1 == 1 + row1["bodies"] and l2 == 1 + row2["bodies"]
    assert r1.iterations == r2.iterations and np.array_equal(r1.x, r2.x)


def test_bad_step_path_in_the_graph(cuda):
    """Zero row, no presolve, no regularization: every body's Cholesky
    fails on the card too, and the fused loop gives up at 0 iterations."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((4, 10))
    A[2] = 0.0
    b = A @ rng.uniform(0.5, 2.0, 10)
    c = A.T @ rng.standard_normal(4) + rng.uniform(0.5, 2.0, 10)
    p = LPProblem(c=c, A=A, rlb=b, rub=b, lb=np.zeros(10), ub=np.full(10, np.inf))
    be = get_backend("cuda")
    normal_eq.launches = 0
    r = solve(p, backend=be, presolve=False, reg_dual=0.0)
    (row,) = be.phase_report
    assert r.status == Status.NUMERICAL_ERROR and r.iterations == 0
    assert row["bad_steps"] == 6 and normal_eq.launches == 1 + row["bodies"]


def _batched_inputs(B, m, n, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    A = torch.tensor(rng.standard_normal((B, m, n)), device=device).to(dtype)
    d = torch.tensor(rng.random((B, n)) + 0.1, device=device).to(dtype)
    return A, d


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
# (3, 100, 333): odd m·n, so every odd lane of an f64 batch starts 8 bytes
# off a 16-byte boundary; (1, 130, 514): one lane; (5, 64, 3): n < a chunk.
@pytest.mark.parametrize("B,m,n", [(4, 128, 512), (3, 100, 333), (1, 130, 514), (5, 64, 3)])
def test_batched_kernel_lanes_equal_the_unbatched_kernel(cuda, dtype, B, m, n):
    """One launch for every lane; lane i is bit for bit the unbatched
    kernel on lane i's inputs, symmetric bit for bit, and within the
    tolerance of the batched plain version."""
    A, d = _batched_inputs(B, m, n, dtype, cuda)
    before = normal_eq.launches
    M = normal_eq(A, d)
    M2 = normal_eq(A, d)
    torch.cuda.synchronize()
    assert normal_eq.launches == before + 2 and M.shape == (B, m, m)
    assert torch.equal(M, M2) and torch.equal(M, M.mT)
    for i in range(B):
        assert torch.equal(M[i], normal_eq(A[i].contiguous(), d[i].contiguous()))
    L, R = torch.tril(M).double(), torch.tril(normal_eq_reference(A, d)).double()
    assert ((L - R).norm() / R.norm()).item() <= TOL[dtype]


def test_batched_kernel_takes_lanes_up_to_the_grid_y_limit(cuda):
    """65,535 lanes (the grid's y-limit) in one launch, every lane
    written; one more is refused before any launch."""
    A, d = _batched_inputs(65_536, 3, 5, torch.float64, cuda, seed=2)
    before = normal_eq.launches
    M = normal_eq(A[:-1], d[:-1])
    R = normal_eq_reference(A[:-1], d[:-1])
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.tril(M), torch.tril(R), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="65535"):
        normal_eq(A, d)
    assert normal_eq.launches == before + 1


def test_vmap_of_the_kernel_is_one_batched_launch(cuda):
    """Under ``torch.func.vmap`` (per-sample fallback off) the lanes go to
    ONE launch through the op's vmap rule, with the batched call's bits."""
    A, d = _batched_inputs(6, 40, 96, torch.float64, cuda, seed=4)
    with tbatched._no_vmap_fallback():
        before = normal_eq.launches
        M = torch.func.vmap(normal_eq)(A, d)
        torch.cuda.synchronize()
        assert normal_eq.launches == before + 1
        shared = torch.func.vmap(normal_eq, in_dims=(None, 0))(A[0], d)
        assert normal_eq.launches == before + 2
    assert torch.equal(M, normal_eq(A, d))
    assert torch.equal(shared, normal_eq(A[0].expand(6, 40, 96).contiguous(), d))


def test_batched_solve_on_the_card_matches_the_cpu_path(cuda):
    """The batched loop as one captured graph: the CPU path's statuses and
    iterations, objectives within 1e-9, and one K1 launch for the start
    plus one per body of the loop."""
    batch = random_batched_lp(12, 16, 40, seed=3)
    normal_eq.launches = 0
    r = tbatched.solve_batched(batch, tol=1e-8)
    launches = normal_eq.launches
    rc = tbatched.solve_batched(batch, device="cpu", tol=1e-8)
    (row,) = r.phase_report
    assert [s.value for s in r.status] == [s.value for s in rc.status] == ["optimal"] * 12
    assert np.array_equal(r.iterations, rc.iterations)
    assert np.all(np.abs(r.objective - rc.objective) <= 1e-9 * (1 + np.abs(rc.objective)))
    assert row["eager"] == 1 and row["replays"] >= 1 and row["capture_ms"] > 0
    assert row["iters"] == r.iterations.max() == rc.phase_report[0]["iters"]
    assert row["bodies"] == row["iters"] + row["masked"] and row["masked"] <= 1
    assert launches == 1 + row["bodies"]


def test_batched_segmented_and_fused_give_the_unsegmented_bits(cuda):
    batch = random_batched_lp(12, 16, 40, seed=3)
    r1 = tbatched.solve_batched(batch, tol=1e-8)
    r3 = tbatched.solve_batched(batch, tol=1e-8, fused_iters=3)
    rs = tbatched.solve_batched(batch, tol=1e-8, segment_iters=4)
    for r in (r3, rs):
        assert np.array_equal(r.iterations, r1.iterations)
        assert np.array_equal(r.x, r1.x)


# -- the bucket engine and the service (serve/) ------------------------------


def _bucket(B=6, m=16, n=64, live=4, seed=0):
    """A padded bucket of ``live`` standard-form requests and B - live
    padding copies, as the service packs it."""
    from distributedlpsolver_tpu_torch.models.generators import BatchedLP
    from distributedlpsolver_tpu_torch.serve import pad_standard_form, standard_form

    rows = [pad_standard_form(*standard_form(random_dense_lp(12, 40, seed=seed + k)), m, n)
            for k in range(live)]
    rows += [rows[0]] * (B - live)
    c, A, b = (np.stack(v) for v in zip(*rows))
    return BatchedLP(c=c, A=A, b=b, name="bucket"), np.arange(B) < live


def test_warm_bucket_dispatch_captures_no_graph(cuda):
    """A bucket program captures its graph at its first dispatch — even a
    one-iteration warm-up — and a later dispatch only replays: no new
    program, no capture, K1 = start + warm selection + bodies, and the CPU
    path's answer."""
    tbatched.release_bucket_programs()
    batch, act = _bucket()
    size0, caps0 = tbatched.bucket_cache_size(), tbatched.bucket_capture_count()
    tbatched.solve_bucket(batch, act, tol=1e-8, max_iter=1)
    assert tbatched.bucket_cache_size() == size0 + 1
    assert tbatched.bucket_capture_count() == caps0 + 1
    normal_eq.launches = 0
    r = tbatched.solve_bucket(batch, act, tol=1e-8)
    launches = normal_eq.launches
    (row,) = r.phase_report
    assert tbatched.bucket_cache_size() == size0 + 1
    assert tbatched.bucket_capture_count() == caps0 + 1
    assert row["captures"] == 0 and row["eager"] == 0 and row["replays"] == row["bodies"] > 0
    assert launches == row["launches"] == 2 + row["bodies"]
    rc = tbatched.solve_bucket(batch, act, tol=1e-8, device="cpu")
    assert [s.value for s in r.status] == [s.value for s in rc.status]
    assert np.array_equal(r.iterations, rc.iterations)
    assert np.all(r.iterations[~act] == 0)
    assert np.all(np.abs(r.objective - rc.objective) <= 1e-9 * (1 + np.abs(rc.objective)))
    r2 = tbatched.solve_bucket(batch, act, tol=1e-8)
    assert np.array_equal(r2.x, r.x)


def test_bucket_capture_under_a_concurrent_pack(cuda):
    """A bucket program captures (thread-local mode) while another thread
    allocates pinned memory, copies host→device on its own stream and
    records events — the service's pack stage — without failing either."""
    import threading

    tbatched.release_bucket_programs()
    stop, errors = threading.Event(), []

    def pack():
        stream = torch.cuda.Stream()
        try:
            while not stop.is_set():
                h = torch.zeros((64, 32, 128), dtype=torch.float64, pin_memory=True)
                with torch.cuda.stream(stream):
                    d = h.to("cuda", non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(stream)
                ev.synchronize()
                del d
        except Exception as e:  # reported below
            errors.append(e)

    t = threading.Thread(target=pack)
    t.start()
    try:
        for seed in range(3):
            batch, act = _bucket(B=5 + seed, seed=seed)
            r = tbatched.solve_bucket(batch, act, tol=1e-8)
            assert all(s.value == "optimal" for s in r.status)
    finally:
        stop.set()
        t.join()
    assert not errors
    assert tbatched.bucket_capture_count() == 3


def test_service_overlaps_pack_with_solve_on_two_buckets(cuda):
    """On a stream over two bucket shapes the pack of one batch runs under
    the solve of another: overlap_ms > 0; every request OPTIMAL; a second
    wave builds no program and captures no graph."""
    from distributedlpsolver_tpu_torch.models import random_request_stream
    from distributedlpsolver_tpu_torch.serve import ServiceConfig, SolveService

    cfg = ServiceConfig(batch=32, flush_s=0.005)
    shapes = ((48, 160), (96, 384))
    with SolveService(cfg) as svc:
        futs = [svc.submit(p) for p in random_request_stream(256, shapes=shapes, seed=1)]
        assert svc.drain(timeout=300)
        size0, caps0 = tbatched.bucket_cache_size(), tbatched.bucket_capture_count()
        futs += [svc.submit(p) for p in random_request_stream(256, shapes=shapes, seed=2)]
        assert svc.drain(timeout=300)
        stats = svc.stats()
    assert all(f.result().status is Status.OPTIMAL for f in futs)
    assert tbatched.bucket_cache_size() == size0 and tbatched.bucket_capture_count() == caps0
    assert stats["overlap_ms_total"] > 0


def test_bucket_donation_report_on_the_card(cuda):
    """The carry a bucket graph updates in place, its static inputs and
    its private pool, from a program built outside the cache."""
    size = tbatched.bucket_cache_size()
    rep = tbatched.bucket_donation_report(16, 64, 4)
    B, m, n = 4, 16, 64
    # The carry: five state lanes, and per lane the mask, regs, counters,
    # status, iterations, best and since, plus the phase counter.
    assert rep["alias_bytes"] >= 8 * B * (4 * n + m)
    assert rep["argument_bytes"] >= 8 * B * m * n
    assert rep["temp_bytes"] >= 0
    assert tbatched.bucket_cache_size() == size


def test_pdhg_bucket_program_captures_once_and_replays(cuda):
    """The PDHG bucket engine's program captures its graph at its first
    dispatch (a one-burst warm-up), and later dispatches only replay —
    another tol or budget is a fill — with the CPU path's verdicts and
    the same bits from two dispatches."""
    from distributedlpsolver_tpu_torch.backends.first_order import solve_pdhg_bucket

    tbatched.release_bucket_programs()
    batch, act = _bucket(B=8, live=6, seed=3)
    size0, caps0 = tbatched.bucket_cache_size(), tbatched.bucket_capture_count()
    solve_pdhg_bucket(batch, act, tol=1e-4, max_iter=1)
    assert tbatched.bucket_cache_size() == size0 + 1
    assert tbatched.bucket_capture_count() == caps0 + 1
    r = solve_pdhg_bucket(batch, act, tol=1e-4)
    r2 = solve_pdhg_bucket(batch, act, tol=1e-5)
    (row,) = r.phase_report
    assert tbatched.bucket_cache_size() == size0 + 1
    assert tbatched.bucket_capture_count() == caps0 + 1
    assert row["captures"] == 0 and row["eager"] == 0 and row["replays"] == row["bodies"] > 0
    assert not row["built"] and r.fused_iters == 40 and r.y is None
    rc = solve_pdhg_bucket(batch, act, tol=1e-4, device="cpu")
    assert [s.value for s in r.status] == [s.value for s in rc.status]
    assert np.all(r.iterations[~act] == 0) and np.all(r.status[~act] == Status.OPTIMAL)
    assert np.array_equal(solve_pdhg_bucket(batch, act, tol=1e-4).x, r.x)
    assert r2.iterations.max() >= r.iterations.max()


def test_auto_routes_a_large_dense_problem_to_the_card(cuda):
    """``auto`` on the card: ``auto(cuda)`` for a large dense problem, with
    x bit for bit that of ``solve()``'s default, ``cuda``; a tiny one stays
    on the card too (the reference sends it to the host)."""
    p = random_dense_lp(600, 1200, seed=0)
    r = solve(p, backend="auto", tol=1e-8)
    rc = solve(p, tol=1e-8)
    assert r.status is Status.OPTIMAL and r.backend == "auto(cuda)" and rc.backend == "cuda"
    assert np.array_equal(r.x, rc.x) and r.iterations == rc.iterations
    tiny = solve(random_dense_lp(12, 40, seed=0), backend="auto", tol=1e-8)
    assert tiny.status is Status.OPTIMAL and tiny.backend == "auto(cuda)"


def test_solo_pdhg_on_the_card_matches_its_cpu_path(cuda):
    """The solo PDHG loop as one captured graph: the CPU path's verdict
    and, within the reduction orders' rounding, its answer."""
    p = random_dense_lp(64, 256, seed=1)
    be = get_backend("pdlp")
    r = solve(p, backend=be, tol=1e-4)
    rc = solve(p, backend=get_backend("pdlp", device="cpu"), tol=1e-4)
    (row,) = be.phase_report
    assert r.status is Status.OPTIMAL and r.status == rc.status
    assert row["captures"] == 1 and row["replays"] > 0
    assert abs(r.objective - rc.objective) <= 1e-4 * (1 + abs(rc.objective))


# -- the sparse tier: the hybrid-ELL kernel and sparse-iterative ------------


def _ell_operator(which, dtype, device):
    import scipy.sparse as sp

    from distributedlpsolver_tpu_torch.models import netlib_sparse_lp, storm_sparse_lp
    from distributedlpsolver_tpu_torch.ops import sparse

    np_dtype = {torch.float64: np.float64, torch.float32: np.float32}[dtype]
    if which == "wide":
        # Ragged slices (1,037 rows, 4,001 columns), empty rows, and dense
        # rows and columns that span several heavy chunks in both
        # directions.
        A = sp.random(1037, 4001, density=0.002, random_state=5, format="lil")
        rng = np.random.default_rng(5)
        for i in (0, 511, 1036):
            A[i] = rng.standard_normal(4001)
        for j in (3, 3999):
            A[:, j] = rng.standard_normal((1037, 1))
        A[[17, 600]] = 0.0
        A = A.tocsr()
        A.eliminate_zeros()
        return sparse.from_scipy(A, dtype=np_dtype, device=device)
    # storm K=400: Aᵀ's first-stage rows carry ~2,100 entries each, over
    # several heavy chunks; netlib: an uneven row profile with heavy rows
    # of one chunk.
    p = storm_sparse_lp(400, 32, 48, 24, seed=2) if which == "storm" else netlib_sparse_lp(
        2000, 4000, seed=3)
    return sparse.from_scipy(p.A, dtype=np_dtype, device=device)


# Relative error (max |kernel − plain| over max |plain|) of the ELL kernel:
# the same products summed in another order.
ELL_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _ell_cases(op, dtype, device, seed=0):
    from distributedlpsolver_tpu_torch.ops.ell_spmv import ell_spmv_reference

    rng = np.random.default_rng(seed)
    v = torch.tensor(rng.standard_normal(op.n), device=device).to(dtype)
    w = torch.tensor(rng.standard_normal(op.m), device=device).to(dtype)
    d = torch.tensor(rng.random(op.n) + 0.1, device=device).to(dtype)
    return [
        (lambda: op.matvec(v), ell_spmv_reference(op.vals, op.cols, v, op.tail())),
        (lambda: op.rmatvec(w), ell_spmv_reference(op.tvals, op.tcols, w, op.ttail())),
        (lambda: op.normal_diag(d, 1e-3),
         ell_spmv_reference(op.vals, op.cols, d, op.tail(), square=True, reg=1e-3)),
    ]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("which", ["storm", "netlib", "wide"])
def test_ell_kernel_matches_plain_version(cuda, which, dtype):
    from distributedlpsolver_tpu_torch.ops import ell_normal_diag, ell_spmv

    op = _ell_operator(which, dtype, cuda)
    if which != "netlib":
        # The heavy rows of Aᵀ span several chunks (the last-warp sum runs).
        assert op.tsell.n_chunks > op.tsell.n_heavy > 0
    before = (ell_spmv.launches, ell_spmv.launches_t, ell_normal_diag.launches)
    cases = [(kern(), ref) for kern, ref in _ell_cases(op, dtype, cuda)]
    after = (ell_spmv.launches, ell_spmv.launches_t, ell_normal_diag.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)
    for got, ref in cases:
        assert got.dtype == dtype and got.shape == ref.shape
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        assert rel <= ELL_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("which", ["storm", "netlib", "wide"])
def test_ell_kernel_repeats_bit_for_bit(cuda, which, dtype):
    """Two launches give the same bits, and the heavy rows' counters are
    back at zero after each."""
    op = _ell_operator(which, dtype, cuda)
    for kern, _ in _ell_cases(op, dtype, cuda, seed=1):
        assert torch.equal(kern(), kern())
    assert int(op.tsell.counters.abs().sum()) == 0


@pytest.mark.parametrize("which", ["storm", "wide"])
def test_ell_kernel_on_a_scaled_operator(cuda, which):
    """``scaled`` rescales the kernel's layout as it does the hybrid: the
    kernel's products of Dr·A·Dc match the plain version's, and differ
    from the unscaled operator's."""
    op = _ell_operator(which, torch.float64, cuda)
    rng = np.random.default_rng(2)
    sop = op.scaled(rng.uniform(0.5, 2.0, op.m), rng.uniform(0.5, 2.0, op.n))
    for (kern, ref), (kern0, _) in zip(_ell_cases(sop, torch.float64, cuda),
                                       _ell_cases(op, torch.float64, cuda)):
        got = kern()
        assert ((got - ref).abs().max() / ref.abs().max()).item() <= ELL_TOL[torch.float64]
        assert not torch.allclose(got, kern0())


def test_sparse_iterative_solve_on_the_card(cuda):
    """A small bordered solve on the card: the CPU path's status and
    iterations, its objective, the kernel launched, x the same bits on a
    second solve."""
    from distributedlpsolver_tpu_torch.models import storm_sparse_lp
    from distributedlpsolver_tpu_torch.ops import ell_spmv

    p = storm_sparse_lp(8, 16, 24, 16, seed=9)
    be = get_backend("sparse-iterative")
    ell_spmv.launches = ell_spmv.launches_t = 0
    r = solve(p, backend=be, tol=1e-8)
    assert ell_spmv.launches > 0 and ell_spmv.launches_t > 0 and be.cg_report()["precond"] == "bordered"
    r2 = solve(p, backend=get_backend("sparse-iterative"), tol=1e-8)
    rc = solve(p, backend=get_backend("sparse-iterative", device="cpu"), tol=1e-8)
    assert r.status is Status.OPTIMAL and rc.status is Status.OPTIMAL
    assert r.iterations == rc.iterations
    assert abs(r.objective - rc.objective) <= 1e-8 * (1 + abs(rc.objective))
    assert np.array_equal(r.x, r2.x)


def test_kernel_load_failure_is_not_degraded(cuda, monkeypatch, tmp_path):
    """A K1 that cannot be built ends a supervised card solve in the
    loader's KernelError: no retry, no degradation to sparse-iterative."""
    import importlib

    from distributedlpsolver_tpu_torch.ops import KernelError
    from distributedlpsolver_tpu_torch.supervisor import SupervisorConfig, supervised_solve

    ne = importlib.import_module("distributedlpsolver_tpu_torch.ops.normal_eq")

    def no_nvcc():
        raise KernelError("nvcc withheld by the test")

    monkeypatch.setattr(ne, "_lib", None)
    monkeypatch.setattr(ne, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(ne, "_nvcc", no_nvcc)
    with pytest.raises(KernelError, match="withheld"):
        supervised_solve(random_dense_lp(32, 96, seed=0), backend="cuda", tol=1e-8,
                         supervisor=SupervisorConfig(backoff_base=0.001))


@pytest.mark.parametrize("args", [(4, 12, 30, 8), (6, 10, 25, 5), (8, 96, 256, 64)])
def test_block_solve_on_the_card_matches_its_cpu_path(cuda, args):
    """The block tier on the card: its CPU path's status and iterations,
    the objective within 1e-9, the fused, host and segmented loops the
    same bits, two launches of K1 a factorization (the K lanes, one of
    them batched, and the linking matrix)."""
    from distributedlpsolver_tpu_torch.models import block_angular_lp

    p = block_angular_lp(*args, seed=1, sparse=True, density=0.3)
    ref = solve(p, backend=get_backend("block", device="cpu"), tol=1e-8)
    be = get_backend("block")
    normal_eq.launches = normal_eq.launches_batched = 0
    r = solve(p, backend=be, tol=1e-8)
    bodies = be.phase_report[0]["bodies"]
    assert normal_eq.launches_batched == 1 + bodies
    assert normal_eq.launches == 2 * (1 + bodies)
    assert be.phase_report[0]["captures"] == 1
    assert r.status == ref.status == Status.OPTIMAL and r.iterations == ref.iterations
    assert abs(r.objective - ref.objective) <= 1e-9 * (1 + abs(ref.objective))
    for kw in ({"fused_loop": False}, {"segment_iters": 3}, {}):
        r2 = solve(p, backend="block", tol=1e-8, **kw)
        assert np.array_equal(r2.x, r.x), kw


def test_auto_routes_a_block_problem_to_the_block_tier(cuda):
    from distributedlpsolver_tpu_torch.models import block_angular_lp

    p = block_angular_lp(8, 96, 256, 64, seed=0, sparse=True, density=0.05)
    r = solve(p, backend="auto", tol=1e-8)
    r_block = solve(p, backend="block", tol=1e-8)
    assert r.backend == "auto(block)" and r.status == Status.OPTIMAL
    assert np.array_equal(r.x, r_block.x)


@pytest.mark.parametrize("K", [1, 5, 32])
def test_scenario_solve_on_the_card_matches_its_cpu_path(cuda, K):
    """The scenario tier on the card: its CPU path's status and iterations,
    the objective within 1e-9, one batched K1 launch over every padded lane
    a factorization (the unit-diagonal one of setup included), x the same
    bits on a repeat."""
    from distributedlpsolver_tpu_torch.backends import scenario as tsc
    from distributedlpsolver_tpu_torch.models import two_stage_storm

    p = two_stage_storm(K, 6, 10, 6, 2, seed=K + 10).to_block_angular()
    ref = solve(p, backend=get_backend("scenario", device="cpu"), tol=1e-8)
    normal_eq.launches = normal_eq.launches_batched = 0
    r = solve(p, backend="scenario", tol=1e-8)
    rep = tsc.last_solve_report()
    assert normal_eq.launches == normal_eq.launches_batched == 1 + rep["factorizations"]
    assert rep["scenario_bucket"] == 1 << (K - 1).bit_length() and rep["chunks"] == 1
    assert r.status == ref.status == Status.OPTIMAL and r.iterations == ref.iterations
    assert abs(r.objective - ref.objective) <= 1e-9 * (1 + abs(ref.objective))
    assert np.array_equal(solve(p, backend="scenario", tol=1e-8).x, r.x)


def test_auto_routes_a_two_stage_problem_to_the_scenario_tier(cuda):
    from distributedlpsolver_tpu_torch.models import storm_sparse_lp

    p = storm_sparse_lp(8, 16, 24, 16, seed=9)
    p.block_structure = dict(p.block_structure, kind="two_stage", first_stage_m=0)
    r = solve(p, backend="auto", tol=1e-8)
    ref = solve(p, backend=get_backend("scenario", device="cpu"), tol=1e-8)
    assert r.backend == "auto(scenario)" and r.status == Status.OPTIMAL
    assert r.iterations == ref.iterations
    assert abs(r.objective - ref.objective) <= 1e-9 * (1 + abs(ref.objective))


def _nccl_world_of_one():
    from distributedlpsolver_tpu_torch.distributed import world as world_lib
    from distributedlpsolver_tpu_torch.distributed.launcher import free_port

    return world_lib.init_world(world_lib.WorldConfig(
        coordinator=f"127.0.0.1:{free_port()}", rank=0, world_size=1, device="cuda"))


@pytest.mark.parametrize("fused", [True, False])
def test_sharded_nccl_world_of_one_matches_cuda_bit_for_bit(cuda, fused):
    """A world of one reduces over one rank: the sharded solve is the
    cuda solve, bit for bit, with the same iterations and K1 launches;
    under NCCL the fused loop stays captured."""
    p = random_dense_lp(96, 320, seed=4)
    world = _nccl_world_of_one()
    try:
        assert world.pg_backend == "nccl"
        be = get_backend("sharded")
        normal_eq.launches = 0
        rs = solve(p, backend=be, tol=1e-8, fused_loop=fused)
        ls = normal_eq.launches
        if fused:
            assert be.phase_report[0]["captured"] is True and be.phase_report[0]["captures"] == 1
    finally:
        world.close()
    normal_eq.launches = 0
    rc = solve(p, backend="cuda", tol=1e-8, fused_loop=fused)
    assert rs.status == rc.status == Status.OPTIMAL
    assert rs.iterations == rc.iterations and ls == normal_eq.launches > 0
    assert np.array_equal(rs.x, rc.x)


def test_sharded_stage_clock_turns_capture_off_and_back_on(cuda):
    """Under NCCL a clocked solve runs its fused loop uncaptured and says
    why; once the clock is taken away the next solve captures again. The
    two answers agree bit for bit."""
    p = random_dense_lp(96, 320, seed=4)
    world = _nccl_world_of_one()
    try:
        from distributedlpsolver_tpu_torch.backends.sharded import StageClock

        be = get_backend("sharded")
        be.clock = StageClock(be.device)
        r1 = solve(p, backend=be, tol=1e-8)
        row = be.phase_report[0]
        assert row["captured"] is False and "stage clock" in row["capture_off_reason"]
        assert be.clock.report()["calls"]["allreduce_M"] > 0
        be.clock = None
        r2 = solve(p, backend=be, tol=1e-8)
        assert be.phase_report[0]["captured"] is True
    finally:
        world.close()
    assert r1.iterations == r2.iterations and np.array_equal(r1.x, r2.x)


def test_sharded_gloo_world_of_two_on_one_card(cuda, tmp_path):
    """Two ranks share the card over gloo: both OPTIMAL with the same x
    bits, K1 at the shard's shape, the loop uncaptured and saying why."""
    from distributedlpsolver_tpu_torch.distributed.launcher import run_world

    ref = solve(random_dense_lp(64, 256, seed=1), backend="cuda", tol=1e-8)
    res = run_world("sharded_solve", {"m": 64, "n": 256, "seed": 1, "tol": 1e-8}, world_size=2,
                    workdir=str(tmp_path), retries=0, timeout=240, device="cuda",
                    pg_backend="gloo")
    assert len({o["x_sha256"] for o in res.values()}) == 1
    for o in res.values():
        assert o["status"] == "optimal" and o["pg_backend"] == "gloo"
        assert abs(o["objective"] - ref.objective) <= 1e-8 * (1 + abs(ref.objective))
        assert o["shard_shape"] == [64, 128] and o["k1_launches"] > 0
        row = o["phase_report"][0]
        assert row["captured"] is False and "gloo" in row["capture_off_reason"]


def test_nccl_beyond_the_card_count_raises(cuda):
    from distributedlpsolver_tpu_torch.distributed import world as world_lib

    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="nccl world of"):
        world_lib.init_world(world_lib.WorldConfig(
            coordinator="127.0.0.1:1", rank=0, world_size=n, device="cuda"))
