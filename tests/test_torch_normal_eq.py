"""The port's normal-equations assembly (CPU path) against the JAX package.

On a CPU tensor ``distributedlpsolver_tpu_torch.ops.normal_eq`` takes its
plain version; these tests hold that path against the JAX package's
Pallas kernel run in interpret mode (as tests/test_ops.py runs it) and
against its plain-XLA reference, on the same numpy inputs. The CUDA
kernel itself is held against the plain version in tests/test_torch_gpu.py
and in chip_smoke.py, on the card.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedlpsolver_tpu.ops import normal_eq_pallas
from distributedlpsolver_tpu.ops import normal_eq_reference as jax_reference
from distributedlpsolver_tpu_torch.ops import normal_eq, normal_eq_reference


def _inputs(m, n, seed, dtype):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(dtype)
    d = (rng.random(n) + 0.1).astype(dtype)
    return A, d


@pytest.mark.parametrize("m,n", [(32, 64), (64, 128)])
def test_f32_matches_pallas_one_k_tile(m, n):
    A, d = _inputs(m, n, 0, np.float32)
    M = normal_eq(torch.from_numpy(A), torch.from_numpy(d))
    Mp = normal_eq_pallas(jnp.asarray(A), jnp.asarray(d), block_m=128, block_k=128, interpret=True)
    assert M.dtype == torch.float32 and M.shape == (m, m)
    # The tolerances of tests/test_ops.py for one k tile.
    np.testing.assert_allclose(M.numpy(), np.asarray(Mp), rtol=2e-5, atol=1e-5)


def test_f32_matches_pallas_across_k_tiles():
    A, d = _inputs(64, 192, 1, np.float32)
    M = normal_eq(torch.from_numpy(A), torch.from_numpy(d))
    Mp = normal_eq_pallas(jnp.asarray(A), jnp.asarray(d), block_m=64, block_k=64, interpret=True)
    # f32 sums taken in another order (three k tiles vs one product).
    np.testing.assert_allclose(M.numpy(), np.asarray(Mp), rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("m,n", [(48, 160), (37, 101)])
def test_f64_matches_jax_reference(m, n):
    A, d = _inputs(m, n, 2, np.float64)
    M = normal_eq(torch.from_numpy(A), torch.from_numpy(d))
    Mr = np.asarray(jax_reference(jnp.asarray(A), jnp.asarray(d)))
    assert M.dtype == torch.float64 and M.shape == (m, m)
    # f64 BLAS products in two libraries: rounding of n-term sums only.
    np.testing.assert_allclose(M.numpy(), Mr, rtol=1e-12, atol=1e-12 * np.abs(Mr).max())


def test_ragged_f32_matches_pallas():
    A, d = _inputs(37, 101, 3, np.float32)
    M = normal_eq(torch.from_numpy(A), torch.from_numpy(d))
    Mp = normal_eq_pallas(jnp.asarray(A), jnp.asarray(d), block_m=128, block_k=128, interpret=True)
    np.testing.assert_allclose(M.numpy(), np.asarray(Mp), rtol=2e-5, atol=1e-5)


def test_bf16_rounds_the_scaled_product_like_pallas():
    A, d = _inputs(32, 128, 4, np.float32)
    Ab, db = torch.from_numpy(A).bfloat16(), torch.from_numpy(d).bfloat16()
    M = normal_eq(Ab, db, out_dtype=torch.float32)
    Mp = normal_eq_pallas(
        jnp.asarray(Ab.float().numpy(), jnp.bfloat16), jnp.asarray(db.float().numpy(), jnp.bfloat16),
        block_m=128, block_k=128, interpret=True,
    )
    # Same bf16 products, f32 sums in another order.
    np.testing.assert_allclose(M.numpy(), np.asarray(Mp), rtol=2e-5, atol=1e-4)


def test_bf16_gives_f32_output_only():
    A, d = _inputs(8, 16, 7, np.float32)
    Ab, db = torch.from_numpy(A).bfloat16(), torch.from_numpy(d).bfloat16()
    assert normal_eq(Ab, db).dtype == torch.float32
    with pytest.raises(TypeError):
        normal_eq(Ab, db, out_dtype=torch.bfloat16)


def test_cpu_path_never_counts_a_launch():
    A, d = _inputs(8, 16, 5, np.float64)
    before = normal_eq.launches
    normal_eq(torch.from_numpy(A), torch.from_numpy(d))
    assert normal_eq.launches == before


@pytest.mark.parametrize(
    "A,d,err",
    [
        (torch.zeros(4, 6), torch.zeros(5), ValueError),  # n mismatch
        (torch.zeros(4, 6), torch.zeros(6, dtype=torch.float64), TypeError),  # dtype mismatch
        (torch.zeros(4, 6, dtype=torch.int32), torch.zeros(6, dtype=torch.int32), TypeError),
        (torch.zeros(2, 4, 6), torch.zeros(6), ValueError),  # batched A, unbatched d
        (torch.zeros(2, 4, 6), torch.zeros(3, 6), ValueError),  # lane counts differ
        (torch.zeros(2, 2, 4, 6), torch.zeros(2, 2, 6), ValueError),  # two batch axes
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(A, d, err):
    with pytest.raises(err):
        normal_eq(A, d)


def test_reference_is_the_plain_expression():
    A, d = _inputs(12, 30, 6, np.float64)
    At, dt = torch.from_numpy(A), torch.from_numpy(d)
    torch.testing.assert_close(normal_eq_reference(At, dt), (At * dt[None, :]) @ At.T, rtol=0, atol=0)


def _batched_inputs(B, m, n, seed, dtype):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, n)).astype(dtype)
    d = (rng.random((B, n)) + 0.1).astype(dtype)
    return A, d


@pytest.mark.parametrize("B,m,n", [(4, 16, 40), (3, 37, 101)])
def test_batched_plain_version_equals_the_per_lane_reference(B, m, n):
    A, d = _batched_inputs(B, m, n, 8, np.float64)
    At, dt = torch.from_numpy(A), torch.from_numpy(d)
    M = normal_eq(At, dt)
    assert M.shape == (B, m, m) and M.dtype == torch.float64
    for i in range(B):
        lane = normal_eq_reference(At[i], dt[i])
        torch.testing.assert_close(M[i], lane, rtol=1e-12, atol=1e-12 * float(lane.abs().max()))
        Mr = np.asarray(jax_reference(jnp.asarray(A[i]), jnp.asarray(d[i])))
        np.testing.assert_allclose(M[i].numpy(), Mr, rtol=1e-12, atol=1e-12 * np.abs(Mr).max())


def test_batched_f32_matches_pallas_lane_by_lane():
    A, d = _batched_inputs(3, 37, 101, 9, np.float32)
    M = normal_eq(torch.from_numpy(A), torch.from_numpy(d))
    for i in range(3):
        Mp = normal_eq_pallas(jnp.asarray(A[i]), jnp.asarray(d[i]), block_m=128, block_k=128,
                              interpret=True)
        # The tolerances of tests/test_ops.py for one k tile.
        np.testing.assert_allclose(M[i].numpy(), np.asarray(Mp), rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("shared", [None, "A", "d"])
def test_vmap_of_the_op_equals_the_batched_plain_version(shared):
    """``torch.func.vmap`` over lanes goes through the op's vmap rule (the
    per-sample fallback is off); an input shared by every lane is
    broadcast."""
    A, d = _batched_inputs(5, 12, 30, 10, np.float64)
    At, dt = torch.from_numpy(A), torch.from_numpy(d)
    if shared == "A":
        At = At[0]
    elif shared == "d":
        dt = dt[0]
    in_dims = (None if shared == "A" else 0, None if shared == "d" else 0)
    was = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        M = torch.func.vmap(normal_eq, in_dims=in_dims)(At, dt)
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(was)
    Ab = At.expand(5, *At.shape) if shared == "A" else At
    db = dt.expand(5, *dt.shape) if shared == "d" else dt
    assert M.shape == (5, 12, 12)
    torch.testing.assert_close(M, normal_eq_reference(Ab, db), rtol=0, atol=0)


def test_first_call_loads_no_heavy_modules():
    """The op's first call in a fresh process imports none of the modules
    whose loading made ``torch.library.custom_op``'s first call cost
    seconds of a cold solve's setup (sympy, torch._dynamo,
    torch.distributed.tensor)."""
    code = (
        "import sys, torch\n"
        "from distributedlpsolver_tpu_torch.ops.normal_eq import normal_eq\n"
        "normal_eq(torch.ones(3, 5, dtype=torch.float64), torch.ones(5, dtype=torch.float64))\n"
        "print([k for k in ('sympy', 'torch._dynamo', 'torch.distributed.tensor') if k in sys.modules])\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
