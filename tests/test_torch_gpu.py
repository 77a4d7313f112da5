"""The CUDA kernel against its plain version (one matrix and a batch of
lanes; in f32 against the exact product, also on its 4-byte copies, and
no farther from it than cuBLAS's; in f64 split over k, and its split's
sum kernel), the fused loop (a captured CUDA graph of the Mehrotra step)
against the host loop, the batched solver against its CPU path, and the
bucket engine and solve service (one captured graph per bucket, reused),
the sparse tier's hybrid-ELL kernel against its plain version and a
``sparse-iterative`` solve, the block and scenario tiers' solves, and
the sharded backend (an NCCL world of one against ``cuda`` bit for bit,
a gloo world of two ranks sharing the card, NCCL refused beyond the card
count), and the batch mesh (K1 on a rank's lane block, a bucket over a
gloo world of two sharing the card, ``mesh_devices`` beyond the card
count refused), and the row-sharded tier (the ELL kernel on a rank's row
block, an NCCL world of one against ``mesh=None`` bit for bit, a gloo world
of two sharing the card), and the scenario tier's lane mesh and pdlp's
column mesh (a mesh of one, local and an NCCL world, against ``mesh=None``
bit for bit), on the card.

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
from distributedlpsolver_tpu_torch.ops.normal_eq import normal_eq_exact

pytestmark = pytest.mark.gpu

# Frobenius-relative error of the kernel's lower triangle against the
# plain version's, in f32 against the exact product's (the kernel computes
# the lower triangle and mirrors it, so M must also equal Mᵀ bit for bit).
TOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 1e-4}


def _held_against(A, d, out_dtype=None):
    """The lower triangle, in f64, that the kernel on (A, d) is held to:
    the plain version's, but for f32 the exact product's (the f32 plain
    version's own sum lies up to ~1e-5 from it)."""
    if A.dtype == torch.float32:
        return torch.tril(normal_eq_exact(A, d))
    return torch.tril(normal_eq_reference(A, d, out_dtype=out_dtype)).double()


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
    L, R = torch.tril(M).double(), _held_against(A, d, out)
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


def test_f32_kernel_on_its_four_byte_copies(cuda):
    """f32 takes 4-byte copies for an odd n and for an A that starts 4
    bytes past a 16-byte boundary (n a multiple of 4): the exact
    product's M within tolerance, and the misaligned view the aligned
    copy's bits."""
    for m, n in ((130, 515), (65, 1001)):
        A, d = _inputs(m, n, torch.float32, cuda, seed=6)
        M = normal_eq(A, d)
        L, R = torch.tril(M).double(), _held_against(A, d)
        assert torch.equal(M, M.T) and ((L - R).norm() / R.norm()).item() <= TOL[torch.float32]
    m, n = 130, 516
    A, d = _inputs(m, n, torch.float32, cuda, seed=5)
    flat = torch.empty(m * n + 1, dtype=torch.float32, device=cuda)
    view = flat[1:].view(m, n)
    view.copy_(A)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    M = normal_eq(view, d)
    torch.cuda.synchronize()
    assert torch.equal(M, normal_eq(A, d))


def test_f32_batched_lanes_on_either_copy_width_equal_unbatched_launches(cuda):
    """A batch whose lane stride is no multiple of 4 floats (lanes apart
    by m·n + 1) takes 4-byte copies; each lane, copied out, takes 16-byte
    ones alone. Lane i is bit for bit the one-lane launch either way."""
    B, m, n = 3, 96, 1024
    A, d = _batched_inputs(B, m, n, torch.float32, cuda, seed=4)
    buf = torch.zeros(B, m * n + 1, dtype=torch.float32, device=cuda)
    strided = buf[:, : m * n].view(B, m, n)
    strided.copy_(A)
    assert strided.stride(0) == m * n + 1
    M, Ms = normal_eq(A, d), normal_eq(strided, d)
    torch.cuda.synchronize()
    assert torch.equal(M, Ms) and torch.equal(M, M.mT)
    for i in range(B):
        assert torch.equal(M[i], normal_eq(A[i].contiguous(), d[i].contiguous()))


def _exact_errors(M, exact):
    """Frobenius-relative error of M against the exact product, and the
    largest relative error on the diagonal."""
    M = M.double()
    fro = ((M - exact).norm() / exact.norm()).item()
    diag = ((M.diagonal() - exact.diagonal()).abs() / exact.diagonal().abs()).max().item()
    return fro, diag


def test_f32_kernel_is_no_farther_from_the_exact_product_than_cublas(cuda):
    """At the main path's width, 2048×10240, K1's f32 M (3×TF32 products,
    a blocked sum) is no farther from the f64 product of the same f32
    inputs than one cuBLAS f32 product (TF32 off), Frobenius-relative and
    on the diagonal."""
    g = torch.Generator(device="cuda").manual_seed(0)
    A = torch.randn(2048, 10240, dtype=torch.float64, device=cuda, generator=g).float()
    d = (torch.rand(10240, dtype=torch.float64, device=cuda, generator=g) + 0.1).float()
    exact = normal_eq_exact(A, d)
    k1 = _exact_errors(normal_eq(A, d), exact)
    cublas = _exact_errors((A * d[None, :]) @ A.T, exact)
    assert k1[0] <= cublas[0] and k1[1] <= cublas[1], (k1, cublas)


def _ne_module():
    import importlib

    return importlib.import_module("distributedlpsolver_tpu_torch.ops.normal_eq")


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("m,n", [(200, 20001), (129, 4097)])
def test_split_launch_matches_plain_version(cuda, m, n, splits):
    """An f64 launch split ``splits`` ways over k (the launch's private
    handle): within 1e-12 of the plain version, M = Mᵀ and two launches
    bit for bit, the split launches counted, and each lane of a batch the
    one-lane launch's bits at the same split."""
    ne = _ne_module()
    A, d = _inputs(m, n, torch.float64, cuda, seed=splits)
    before, split_before = normal_eq.launches, normal_eq.launches_split
    M = ne._launch(A, d, torch.float64, splits=splits)
    M2 = ne._launch(A, d, torch.float64, splits=splits)
    torch.cuda.synchronize()
    assert normal_eq.launches == before + 2
    assert normal_eq.launches_split == split_before + (2 if splits > 1 else 0)
    assert torch.equal(M, M.T) and torch.equal(M, M2)
    L, R = torch.tril(M), torch.tril(normal_eq_reference(A, d))
    assert ((L - R).norm() / R.norm()).item() <= TOL[torch.float64]
    Ab, db = _batched_inputs(3, m, n, torch.float64, cuda, seed=splits)
    Mb = ne._launch(Ab, db, torch.float64, splits=splits)
    for i in range(3):
        assert torch.equal(Mb[i], ne._launch(Ab[i].contiguous(), db[i].contiguous(),
                                             torch.float64, splits=splits))


def test_split_sum_kernel_equals_its_plain_version(cuda):
    """The split's second kernel alone, on partial tiles of random values:
    its plain version's bits (the same sums in split order)."""
    ne = _ne_module()
    m, lanes, splits = 200, 2, 3
    work = torch.randn(ne.workspace_numel(m, lanes, splits), dtype=torch.float64, device=cuda)
    M = ne.split_sum(work, m, lanes, splits)
    torch.cuda.synchronize()
    assert torch.equal(M, ne.split_sum_reference(work, m, lanes, splits))


def test_split_launch_replays_in_a_cuda_graph(cuda):
    """A split launch captured in a CUDA graph (its workspace from the
    graph's pool) replays to the eager launch's bits."""
    ne = _ne_module()
    A, d = _inputs(129, 4097, torch.float64, cuda, seed=9)
    eager = ne._launch(A, d, torch.float64, splits=3)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        ne._launch(A, d, torch.float64, splits=3)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ne._launch(A, d, torch.float64, splits=3)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


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


# The JAX package's objectives for random_dense_lp(60, 180, seed=0) under
# solve_mode="pcg" (scripts/port_pcg_jax_verdicts.py): OPTIMAL at 12
# iterations on every loop; the segmented loop's closure moves the 11th digit.
PCG_SMALL_OBJECTIVE = {"fused": 166.05981005706167, "host": 166.05981005706167,
                       "segmented": 166.05981005718908}


def test_pcg_solve_on_the_card_on_every_loop(cuda):
    """solve_mode="pcg" on the captured fused loop (twice: the same bits),
    the host loop and the segmented loop (with the closure): OPTIMAL at
    the reference's 12 iterations (±1), its objective for the route within
    1e-8, fused and host within 1e-12; K1 f32 once a factorization, and
    once more for the closure's G on the segmented loop."""
    p = random_dense_lp(60, 180, seed=0)
    out = {}
    for name, kw in (("fused", {}), ("fused2", {}), ("host", {"fused_loop": False}),
                     ("segmented", {"segment_iters": 2})):
        be = get_backend("cuda")
        reg = obs_metrics.MetricsRegistry()
        prev = obs_metrics.set_registry(reg)
        try:
            normal_eq.launches = 0
            r = solve(p, backend=be, tol=1e-8, solve_mode="pcg", **kw)
            launches = normal_eq.launches
        finally:
            obs_metrics.set_registry(prev)
        refactors = int(reg.snapshot().get("ipm_refactorizations_total", 0))
        out[name] = (r, be, launches, refactors)
        ref = PCG_SMALL_OBJECTIVE[name.rstrip("2")]
        assert r.status == Status.OPTIMAL and abs(r.iterations - 12) <= 1
        assert abs(r.objective - ref) <= 1e-8 * (1.0 + abs(ref))
        assert be.cg_report()["solves"] > 0 and be.cg_report()["cg_live"] > 0
    (rf, bf, lf, _), (rf2, _, lf2, _) = out["fused"], out["fused2"]
    assert bf.phase_report[0]["captures"] == 1 and bf.phase_report[0]["replays"] > 0
    assert bf.phase_report[0]["mode"] == "pcg"
    assert rf2.iterations == rf.iterations and np.array_equal(rf2.x, rf.x)
    rh, bh, lh, refactors = out["host"]
    assert rh.iterations == rf.iterations
    assert np.abs(rh.x - rf.x).max() <= 1e-12 * max(np.abs(rf.x).max(), 1.0)
    # The captured body runs every CG iteration, masked past the exit.
    assert bf.cg_report()["cg_masked"] > 0
    assert lf == lf2 == 1 + bf.phase_report[0]["bodies"]
    assert lh == 1 + rh.iterations + refactors
    rs, bs, ls, _ = out["segmented"]
    assert bs._closure is not None and bf._closure is None and bh._closure is None
    assert ls == 2 + sum(row["bodies"] for row in bs.phase_report)


def test_pcg_factorize_k1_f32_matches_its_plain_version(cuda):
    """The PCG factorization on the card launches K1 once in f32 and gives
    the CPU path's preconditioner (its plain version) within f32 rounding;
    the solve gives the CPU path's x within 1e-9."""
    from distributedlpsolver_tpu_torch.backends import dense

    rng = np.random.default_rng(7)
    A = rng.standard_normal((300, 1001))
    d = 10.0 ** rng.uniform(-4, 4, 1001)
    rhs = rng.standard_normal(300)
    sols = {}
    for dev in ("cuda", "cpu"):
        At = torch.tensor(A, device=dev)
        fac, solve_ = dense._pcg_ops(At, At.to(torch.float32), 1e-11, 100)
        before = normal_eq.launches
        factors = fac(torch.tensor(d, device=dev), 1e-8)
        x = solve_(factors, torch.tensor(rhs, device=dev))
        torch.cuda.synchronize()
        assert normal_eq.launches == before + (1 if dev == "cuda" else 0)
        sols[dev] = [t.cpu() for t in factors[:3]] + [x.cpu()]
    (Lg, sg, dg, xg), (Lc, sc, dc, xc) = sols["cuda"], sols["cpu"]
    assert ((dg - dc).abs().max() / dc.abs().max()).item() <= TOL[torch.float32]
    assert ((sg - sc).abs().max() / sc.abs().max()).item() <= TOL[torch.float32]
    assert ((Lg - Lc).norm() / Lc.norm()).item() <= 1e-3
    assert ((xg - xc).abs().max() / xc.abs().max()).item() <= 1e-9


# The JAX package's verdicts for random_dense_lp(60, 180, seed=0) under its
# TPU schedule (jax.default_backend forced to "tpu", use_pallas=False; the
# rule of scripts/port_two_phase_jax_verdicts.py): OPTIMAL at 11 + 1
# iterations on the fused two-phase program, 12 + 1 on the segmented route.
TWO_PHASE_SMALL = {"fused": (12, 166.05981002046568), "segmented": (13, 166.05980881256784)}


def _two_phase_solve(p, **kw):
    """A solve under ``schedule_platform="tpu"`` with K1's counts reset
    just before and read just after: (result, backend, all, f32)."""
    from distributedlpsolver_tpu_torch.backends.dense import DenseTorchBackend

    be = DenseTorchBackend(schedule_platform="tpu")
    normal_eq.launches = normal_eq.launches_f32 = 0
    r = solve(p, backend=be, tol=1e-8, **kw)
    return r, be, normal_eq.launches, normal_eq.launches_f32


def test_two_phase_unsegmented_route_is_captured_and_repeatable(cuda):
    """The fused two-phase program (``segment_iters=0``): phase 1 on its
    captured loop, phase 2 resuming its carry; the reference's verdict
    (iterations ±1, objective within 1e-8), and x bit for bit on a
    repeat."""
    p = random_dense_lp(60, 180, seed=0)
    (r1, b1, _, _), (r2, _, _, _) = (_two_phase_solve(p, segment_iters=0) for _ in range(2))
    its, obj = TWO_PHASE_SMALL["fused"]
    assert r1.status == Status.OPTIMAL and abs(r1.iterations - its) <= 1
    assert abs(r1.objective - obj) <= 1e-8 * (1.0 + abs(obj))
    p1, p2 = b1.phase_report
    assert (p1["mode"], p2["mode"]) == ("f32", "f64") and p1["iters"] + p2["iters"] == r1.iterations
    assert p1["captures"] == 1 and p1["replays"] > 0 and p2["captures"] <= 1
    assert all(row["captured"] for row in b1.phase_report)
    assert r2.iterations == r1.iterations and np.array_equal(r2.x, r1.x)


def test_two_phase_k1_f32_launches_are_the_start_and_phase_one(cuda):
    """K1 f32 launches = the starting point + phase 1's bodies, and the
    f64 ones phase 2's bodies, on the segmented route (the TPU's auto) and
    the fused two-phase program."""
    p = random_dense_lp(60, 180, seed=0)
    for route, kw in (("segmented", {}), ("fused", {"segment_iters": 0})):
        r, be, launches, f32 = _two_phase_solve(p, **kw)
        its, obj = TWO_PHASE_SMALL[route]
        assert r.status == Status.OPTIMAL and abs(r.iterations - its) <= 1
        assert abs(r.objective - obj) <= 1e-8 * (1.0 + abs(obj))
        p1, p2 = be.phase_report
        assert (p1["mode"], p2["mode"]) == ("f32", "f64")
        assert f32 == 1 + p1["bodies"] and launches - f32 == p2["bodies"]


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
    tolerance of the batched plain version (in f32 the exact product)."""
    A, d = _batched_inputs(B, m, n, dtype, cuda)
    before = normal_eq.launches
    M = normal_eq(A, d)
    M2 = normal_eq(A, d)
    torch.cuda.synchronize()
    assert normal_eq.launches == before + 2 and M.shape == (B, m, m)
    assert torch.equal(M, M2) and torch.equal(M, M.mT)
    for i in range(B):
        assert torch.equal(M[i], normal_eq(A[i].contiguous(), d[i].contiguous()))
    L, R = torch.tril(M).double(), _held_against(A, d)
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


def test_slice_lane_block_k1_matches_plain_version(cuda):
    """K1 over a rank's lane block of the serve bucket over a world of 2
    (f64 128 lanes of 128 × 512): each lane the unbatched kernel's bits,
    the lower triangle within 1e-12 of the plain version."""
    A, d = _inputs(128, 512, torch.float64, cuda)
    A = A.expand(128, -1, -1).contiguous() * torch.linspace(0.5, 1.5, 128, device=cuda,
                                                             dtype=torch.float64)[:, None, None]
    d = d.expand(128, -1).contiguous()
    M = normal_eq(A, d)
    for i in (0, 63, 127):
        assert torch.equal(M[i], normal_eq(A[i].contiguous(), d[i].contiguous()))
    R = torch.tril(normal_eq_reference(A, d))
    assert ((torch.tril(M) - R).norm() / R.norm()).item() <= TOL[torch.float64]
    assert torch.equal(M, M.mT)


def test_slice_bucket_over_a_gloo_world_of_two_on_one_card(cuda, tmp_path):
    """``bucket_probe`` over two ranks sharing the card: each rank solves
    its lane block through its own captured program (the loop holds no
    collective, so gloo keeps the graph), the second dispatch builds and
    captures nothing, and both ranks hold the one-process bucket's
    statuses, iterations and objectives."""
    from distributedlpsolver_tpu_torch.distributed.launcher import run_world
    from distributedlpsolver_tpu_torch.ipm import SolverConfig

    ref = tbatched.solve_bucket(random_batched_lp(8, 8, 24, seed=7), np.ones(8, bool),
                                SolverConfig(tol=1e-8, verbose=False))
    res = run_world("bucket_probe", {"m": 8, "n": 24, "batch": 8, "tol": 1e-8}, world_size=2,
                    workdir=str(tmp_path), retries=0, timeout=240, device="cuda",
                    pg_backend="gloo")
    assert res[0]["dispatches"][0]["x_sha256"] == res[1]["dispatches"][0]["x_sha256"]
    for out in res.values():
        assert out["pg_backend"] == "gloo" and out["warm_recompiles"] == 0
        first, second = out["dispatches"]
        assert first["phase_report"]["captured"] is True
        assert second["programs_built"] == 0 and second["graphs_captured"] == 0
        assert first["status"] == [s.value for s in ref.status]
        assert first["iterations"] == ref.iterations.tolist()
        np.testing.assert_allclose(first["objectives"], ref.objective, rtol=1e-8, atol=1e-10)


def test_mesh_devices_beyond_the_cards_raises(cuda):
    """A local batch mesh names distinct cards: one more than the host
    has raises naming the count; nothing falls back."""
    from distributedlpsolver_tpu_torch.serve import ServiceConfig, SolveService

    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"only {n} local devices"):
        SolveService(ServiceConfig(mesh_devices=n + 1), auto_start=False)


# -- the row-sharded tier ------------------------------------------------------------


@pytest.mark.parametrize("parts", [2, 4])
def test_rows_ell_kernel_on_a_row_block(cuda, parts):
    """The kernel on rank 0's row block of a storm matrix split over
    ``parts`` ranks: A_r·v and A_rᵀ·w (an n-row transpose whose rows of the
    other ranks' scenarios are empty, whole zero-width slices of them)
    within 1e-12 of the plain version, every empty row an exact 0, two
    launches bit for bit."""
    from distributedlpsolver_tpu_torch.models import storm_sparse_lp
    from distributedlpsolver_tpu_torch.ops import ell_spmv
    from distributedlpsolver_tpu_torch.ops import sparse as tsparse
    from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib

    A = storm_sparse_lp(400, 32, 48, 24, seed=2).A.tocsr()
    # The rows of a rank's block, as shard_rows cuts them (one rank here).
    (_, lo, hi), = mesh_lib.Mesh((parts,), ("batch",), cuda).row_blocks(A.shape[0])
    op = tsparse.from_scipy(A[lo:hi], device=cuda, fmt="ell")
    empty = np.diff(A[lo:hi].tocsc().indptr) == 0
    assert empty.sum() > 32 * 8  # whole slices of empty transpose rows
    before = (ell_spmv.launches, ell_spmv.launches_t)
    for kern, ref in _ell_cases(op, torch.float64, cuda)[:2]:
        got = kern()
        assert ((got - ref).abs().max() / ref.abs().max()).item() <= ELL_TOL[torch.float64]
        assert torch.equal(got, kern())
    assert (ell_spmv.launches - before[0], ell_spmv.launches_t - before[1]) == (2, 2)
    w = torch.randn(op.m, dtype=torch.float64, device=cuda)
    out = op.rmatvec(w).cpu().numpy()
    assert np.all(out[empty] == 0.0) and not np.signbit(out[empty]).any()


def test_rows_nccl_world_of_one_matches_mesh_none_bit_for_bit(cuda):
    """A row-sharded solve on an NCCL world of one is the single-device
    solve bit for bit: the same x, IPM and CG iterations."""
    from distributedlpsolver_tpu_torch.backends.sparse_iterative import SparseIterativeBackend
    from distributedlpsolver_tpu_torch.models import storm_sparse_lp

    p = storm_sparse_lp(32, 64, 96, 64, seed=1)
    world = _nccl_world_of_one()
    try:
        be = SparseIterativeBackend(mesh=world.mesh(axis="batch"))
        rs = solve(p, backend=be, tol=1e-8)
        rep = be.cg_report()
    finally:
        world.close()
    be0 = get_backend("sparse-iterative")
    r0 = solve(storm_sparse_lp(32, 64, 96, 64, seed=1), backend=be0, tol=1e-8)
    assert rs.status == r0.status == Status.OPTIMAL
    assert rs.iterations == r0.iterations and rep["cg_iters"] == be0.cg_report()["cg_iters"]
    assert rep["shards"] == 1 and np.array_equal(rs.x, r0.x)


def test_rows_gloo_world_of_two_on_one_card(cuda, tmp_path):
    """Two ranks share the card over gloo on the row-sharded tier: both
    OPTIMAL at the single-device IPM iterations and objective, with the
    same x bits and CG count, the kernel launched on each rank."""
    from distributedlpsolver_tpu_torch.distributed.launcher import run_world
    from distributedlpsolver_tpu_torch.models import storm_sparse_lp

    ref = solve(storm_sparse_lp(6, 24, 36, 24, seed=3), backend="sparse-iterative", tol=1e-8)
    res = run_world("sparse_rows", {"tol": 1e-8}, world_size=2, workdir=str(tmp_path), retries=0,
                    timeout=240, device="cuda", pg_backend="gloo")
    assert len({o["x_sha256"] for o in res.values()}) == 1
    assert len({o["cg_iters"] for o in res.values()}) == 1
    for o in res.values():
        assert o["status"] == "optimal" and o["pg_backend"] == "gloo" and o["shards"] == 2
        assert o["iterations"] == ref.iterations
        assert abs(o["objective"] - ref.objective) <= 1e-8 * (1 + abs(ref.objective))
        assert o["ell_launches"]["A·v"] > 0 and o["ell_launches"]["Aᵀ·v"] > 0


def test_block_nccl_world_of_one_matches_a_local_mesh_of_one(cuda):
    """The block tier on an NCCL world of one and on a local mesh of one on
    the card run the same code (the sums are the identity all-reduce and a
    one-part sum): x bit for bit, the fused loop captured with the
    all-reduces in it, two K1 launches a factorization."""
    from distributedlpsolver_tpu_torch.backends.block_angular import BlockAngularBackend
    from distributedlpsolver_tpu_torch.models import block_angular_lp
    from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib

    p = block_angular_lp(8, 24, 60, 12, seed=1, sparse=True, density=0.05)
    world = _nccl_world_of_one()
    try:
        be = BlockAngularBackend(mesh=world.mesh(axis="blocks"))
        normal_eq.launches = normal_eq.launches_batched = 0
        rw = solve(p, backend=be, tol=1e-8)
        lw, lb = normal_eq.launches, normal_eq.launches_batched
        row = be.phase_report[0]
    finally:
        world.close()
    assert row["captured"] is True and lw == 2 * lb == 2 * (1 + row["bodies"])
    local = BlockAngularBackend(mesh=mesh_lib.make_mesh(axis_names=("blocks",),
                                                        devices=["cuda:0"]))
    rl = solve(p, backend=local, tol=1e-8)
    ref = solve(p, backend=get_backend("block", device="cpu"), tol=1e-8)
    assert rw.status == rl.status == Status.OPTIMAL
    assert rw.iterations == rl.iterations and np.array_equal(rw.x, rl.x)
    assert abs(rw.objective - ref.objective) <= 1e-8 * (1 + abs(ref.objective))


def test_block_gloo_world_of_two_on_one_card(cuda, tmp_path):
    """Two ranks share the card over gloo on the block tier: both OPTIMAL
    with the same x bits, each its half of the K axis, two K1 launches a
    factorization, the loop uncaptured and saying why."""
    from distributedlpsolver_tpu_torch.distributed.launcher import run_world
    from distributedlpsolver_tpu_torch.models import block_angular_lp

    spec = dict(backend="block", instance="block", blocks=8, block_m=24, block_n=60, link=12,
                seed=1, sparse=True, density=0.05, tol=1e-8)
    ref = solve(block_angular_lp(8, 24, 60, 12, seed=1, sparse=True, density=0.05),
                backend="block", tol=1e-8)
    res = run_world("sharded_solve", spec, world_size=2, workdir=str(tmp_path), retries=0,
                    timeout=240, device="cuda", pg_backend="gloo")
    assert len({o["x_sha256"] for o in res.values()}) == 1
    for o in res.values():
        assert o["status"] == "optimal" and o["pg_backend"] == "gloo"
        assert abs(o["objective"] - ref.objective) <= 1e-8 * (1 + abs(ref.objective))
        assert o["shard_shape"][0] == 4 and o["k1_launches"] == 2 * o["k1_launches_batched"] > 0
        row = o["phase_report"][0]
        assert row["captured"] is False and "gloo" in row["capture_off_reason"]


@pytest.mark.parametrize("m,panel", [(800, 256), (130, 16)])
def test_dist_chol_on_the_card(cuda, m, panel):
    """``chol_tri_inv_mesh`` on the card (a local mesh of one) within
    1e-12 of inv(cholesky) in f64, at pds-10's link order and a ragged
    one."""
    from distributedlpsolver_tpu_torch.ops import dist_chol
    from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib

    rng = np.random.default_rng(0)
    G = rng.standard_normal((m, m))
    Ms = G @ G.T + m * np.eye(m)
    ref = np.linalg.inv(np.linalg.cholesky(Ms))
    inv = dist_chol.chol_tri_inv_mesh(torch.as_tensor(Ms, device=cuda),
                                      mesh_lib.make_mesh(axis_names=("cols",),
                                                         devices=["cuda:0"]), panel=panel)
    got = inv.slabs[0][:m, :m].cpu().numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-12


def test_scenario_mesh_of_one_matches_mesh_none_bit_for_bit(cuda):
    """The scenario tier's lane mesh on a local mesh of one and on an NCCL
    world of one on the card: mesh=None's x bit for bit, the same CG
    count, one K1 launch a factorization over the member's lanes."""
    from distributedlpsolver_tpu_torch.backends import scenario as tsc
    from distributedlpsolver_tpu_torch.backends.scenario import ScenarioBackend
    from distributedlpsolver_tpu_torch.models import two_stage_storm
    from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib

    p = two_stage_storm(32, 6, 10, 6, 2, seed=42).to_block_angular()
    be0 = ScenarioBackend()
    r0 = solve(p, backend=be0, tol=1e-8)
    local = ScenarioBackend(mesh=mesh_lib.make_mesh(axis_names=("batch",), devices=["cuda:0"]))
    rl = solve(p, backend=local, tol=1e-8)
    world = _nccl_world_of_one()
    try:
        bw = ScenarioBackend(mesh=world.mesh(axis="batch"))
        normal_eq.launches = 0
        rw = solve(p, backend=bw, tol=1e-8)
        launches = normal_eq.launches
    finally:
        world.close()
    assert r0.status == Status.OPTIMAL
    for r, be in ((rl, local), (rw, bw)):
        assert np.array_equal(r.x, r0.x) and r.iterations == r0.iterations
        assert be.cg_report()["cg_iters"] == be0.cg_report()["cg_iters"]
        assert be.lane_ranges == [(0, 32)]
    assert launches == 1 + tsc.last_solve_report()["factorizations"]


def test_pdlp_mesh_shape_of_one_matches_mesh_none_bit_for_bit(cuda):
    """pdlp with ``mesh_shape=(1,)`` on a dense A (a world of one, and an
    NCCL world of one) on the card: mesh=None's x bit for bit and inner
    steps, the loop captured with its all-reduces inside."""
    p = random_dense_lp(64, 256, seed=4)
    r0 = solve(p, backend="pdlp", tol=1e-4)
    be = get_backend("pdlp")
    r1 = solve(p, backend=be, tol=1e-4, mesh_shape=(1,))
    world = _nccl_world_of_one()
    try:
        bw = get_backend("pdlp")
        rw = solve(p, backend=bw, tol=1e-4, mesh_shape=(1,))
    finally:
        world.close()
    for r, b in ((r1, be), (rw, bw)):
        assert b.mesh is not None and b.phase_report[0]["captured"] is True
        assert r.status == r0.status and r.iterations == r0.iterations
        assert np.array_equal(r.x, r0.x)
    assert bw.mesh.pg_backend == "nccl"
