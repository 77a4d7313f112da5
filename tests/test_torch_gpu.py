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
from distributedlpsolver_tpu_torch.ops import normal_eq, normal_eq_reference

pytestmark = pytest.mark.gpu

# Frobenius-relative error of the kernel against the plain version.
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
@pytest.mark.parametrize("m,n", [(256, 1024), (37, 101), (1000, 3001), (1, 7)])
def test_kernel_matches_plain_version(cuda, dtype, m, n):
    A, d = _inputs(m, n, dtype, cuda)
    out = torch.float32 if dtype == torch.bfloat16 else dtype
    before = normal_eq.launches
    M = normal_eq(A, d, out_dtype=out)
    torch.cuda.synchronize()
    assert normal_eq.launches == before + 1
    R = normal_eq_reference(A, d, out_dtype=out)
    err = ((M.double() - R.double()).norm() / R.double().norm()).item()
    assert err <= TOL[dtype]


def test_bf16_output(cuda):
    """bf16 input gives f32 output, and the kernel rounds the scaled
    product to bf16: it is far closer to the rounded plain version than
    to the same product taken without that rounding."""
    A, d = _inputs(256, 4096, torch.bfloat16, cuda)
    M = normal_eq(A, d)
    assert M.dtype == torch.float32
    R = normal_eq_reference(A, d).double()
    unrounded = (A.double() * d.double()[None, :]) @ A.double().T
    err = ((M.double() - R).norm() / R.norm()).item()
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
