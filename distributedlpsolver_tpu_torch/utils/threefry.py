"""The JAX package's PDHG start vector, reproduced in NumPy.

The JAX package seeds the power iteration of its PDHG step size with
``jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype)``
(``backends/first_order.py::_estimate_norm``). Thirty power iterations do
not converge ‖A‖₂ to full precision, so another start vector gives
another step size, another PDHG trajectory and, for borderline lanes,
another verdict. This module computes the same vector without JAX, for
that one purpose:

* the key of a 32-bit seed is the pair ``(0, seed)``;
* the bits are the threefry2x32 hash of the 64-bit counter ``0..n-1``
  split into its high and low words (JAX's partitionable threefry, the
  default since JAX 0.5): 64-bit draws join the two output words, 32-bit
  draws XOR them;
* the uniform fills a float's mantissa with the top bits and maps
  ``[1, 2)`` onto ``[nextafter(-1, 0), 1)``;
* the normal is ``√2·erfinv(u)`` with XLA's polynomial ``erfinv``.

In f64 the vector agrees with JAX's to a few units in the last place
(XLA's ``log1p`` is not correctly rounded; ≤ 4e-15 relative). In f32
XLA's own ``log1p`` approximation is not reproduced: about 1% of the
elements differ by 1–3 units in the last place.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1: int, k2: int, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x0, x1)``
    under the key ``(k1, k2)``; uint32 in, uint32 out."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def uniform(seed: int, n: int, dtype, lo: float, hi: float) -> np.ndarray:
    """``jax.random.uniform(PRNGKey(seed), (n,), dtype, lo, hi)``."""
    dtype = np.dtype(dtype)
    b1, b2 = threefry2x32(0, int(seed) & 0xFFFFFFFF, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    if dtype == np.float64:
        bits = (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
        bits = (bits >> np.uint64(64 - 52)) | np.array(1.0, dtype).view(np.uint64)
    elif dtype == np.float32:
        bits = ((b1 ^ b2) >> np.uint32(32 - 23)) | np.array(1.0, dtype).view(np.uint32)
    else:
        raise ValueError(f"dtype {dtype} is not supported (float64 or float32)")
    floats = bits.view(dtype) - dtype.type(1.0)
    lo, hi = np.array(lo, dtype), np.array(hi, dtype)
    return np.maximum(lo, floats * (hi - lo) + lo)


# XLA's erfinv polynomials (Giles), highest degree first.
_F32_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_F32_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_F64_W_LT_625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
    1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
    2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
    4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
    0.24015818242558961693, 1.6536545626831027356,
)
_F64_W_LT_16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
    1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
    6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
    -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635,
)
_F64_W_GE_16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
    -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
    -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
    1.0103004648645343977, 4.8499064014085844221,
)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    f = np.float32
    # w in f64, rounded once; the Horner steps as fused multiply-adds.
    w = (-np.log1p((x * -x).astype(np.float64))).astype(f)
    small = w < f(5.0)
    w = np.where(small, w - f(2.5), np.sqrt(w) - f(3.0)).astype(np.float64)
    p = np.where(small, f(_F32_W_LT_5[0]), f(_F32_W_GE_5[0]))
    for lo, hi in zip(_F32_W_LT_5[1:], _F32_W_GE_5[1:]):
        c = np.where(small, f(lo), f(hi)).astype(np.float64)
        p = (c + p.astype(np.float64) * w).astype(f)
    return np.where(np.abs(x) == f(1.0), f(np.inf) * x, p * x)


def _erfinv_f64(x: np.ndarray) -> np.ndarray:
    w = -np.log1p(x * -x)
    lt625, lt16 = w < 6.25, w < 16.0

    def coef(i):
        c = np.full_like(x, _F64_W_LT_625[i])
        if i < 19:
            c = np.where(lt625, c, _F64_W_LT_16[i])
        if i < 17:
            c = np.where(lt16, c, _F64_W_GE_16[i])
        return c

    w = np.where(lt625, w - 3.125, np.sqrt(w) - np.where(lt16, 3.25, 5.0))
    p = coef(0)
    for i in range(1, 17):
        p = coef(i) + p * w
    for i in range(17, 19):
        p = np.where(lt16, coef(i) + p * w, p)
    for i in range(19, 23):
        p = np.where(lt625, coef(i) + p * w, p)
    return np.where(np.abs(x) == 1.0, np.inf * x, p * x)


def normal(seed: int, n: int, dtype=np.float64) -> np.ndarray:
    """``jax.random.normal(PRNGKey(seed), (n,), dtype)`` for a 32-bit
    seed (see the module note for how close it is)."""
    dtype = np.dtype(dtype)
    lo = np.nextafter(np.array(-1.0, dtype), np.array(0.0, dtype), dtype=dtype)
    u = uniform(seed, n, dtype, lo, 1.0)
    inv = _erfinv_f64(u) if dtype == np.float64 else _erfinv_f32(u)
    return (np.array(np.sqrt(2), dtype) * inv).astype(dtype)
