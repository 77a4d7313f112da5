"""The CUDA kernel against its plain version, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card, which
skips the test where there is none. Run on a machine with a card with
``python -m pytest tests/test_torch_gpu.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.ipm import Status, solve
from distributedlpsolver_tpu_torch.models import random_dense_lp
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
    point, one per iteration and one per bad-step refactorization."""
    p = random_dense_lp(256, 1024, seed=0)
    reg = obs_metrics.MetricsRegistry()
    prev = obs_metrics.set_registry(reg)
    try:
        normal_eq.launches = 0
        r = solve(p, backend="cuda", tol=1e-8)
        launches = normal_eq.launches
    finally:
        obs_metrics.set_registry(prev)
    refactors = int(reg.snapshot().get("ipm_refactorizations_total", 0))
    assert r.status == Status.OPTIMAL
    assert launches == 1 + r.iterations + refactors
