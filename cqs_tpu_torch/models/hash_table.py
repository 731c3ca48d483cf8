"""The hash embedder's random table, reproduced without JAX.

The reference draws it as ``jax.random.normal(PRNGKey(seed), (vocab, dim))``
(``cqs_tpu/models/embedder.py:144``). ``torch.randn`` cannot give those
numbers, so this module recomputes them in numpy the way JAX does with
``jax_threefry_partitionable`` on (JAX's default):

1. random bits: Threefry-2x32 (20 rounds) of the key ``(seed >> 32,
   seed & 0xFFFFFFFF)`` applied to the 64-bit flat element index split into
   (high, low) 32-bit halves; the element's 32 bits are the XOR of the two
   output words;
2. uniform: the top 23 bits as the mantissa of a float in [1, 2), minus 1,
   scaled onto [nextafter(-1, 0), 1);
3. normal: ``sqrt(2) * erfinv(u)`` with XLA's single-precision erfinv
   polynomial (Giles), evaluated with fused multiply-adds.

The bits and the uniform are exact. XLA's own ``log1p`` inside erfinv is not
reproduced bit for bit, so a small share of elements differ from JAX's by an
ulp or so (measured max |difference| below 1e-6; the parity test reports
it).
"""

from __future__ import annotations

import functools

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

# XLA ErfInv32 coefficients (w < 5 and w >= 5 branches)
_W_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                   0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                   1.50140941], np.float32)
_W_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                   0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                   2.83297682], np.float32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1: int, k2: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds on uint32 counter pairs."""
    ks = (np.uint32(k1), np.uint32(k2), np.uint32(k1 ^ k2 ^ 0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(seed: int, n: int) -> np.ndarray:
    """JAX's 32-bit random bits for ``n`` elements of PRNGKey(seed)."""
    count = np.arange(n, dtype=np.uint64)
    hi = (count >> np.uint64(32)).astype(np.uint32)
    lo = count.astype(np.uint32)
    b0, b1 = threefry2x32((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF, hi, lo)
    return b0 ^ b1


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """f32 a*b + c with one rounding (the f64 product of two f32 is exact)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def erfinv32(x: np.ndarray) -> np.ndarray:
    w = -np.log1p(-(x * x).astype(np.float64)).astype(np.float32)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, _W_LT5[0], _W_GE5[0]).astype(np.float32)
    for i in range(1, 9):
        p = _fma32(p, w, np.where(lt, _W_LT5[i], _W_GE5[i]).astype(np.float32))
    out = (p * x).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max, out)


@functools.lru_cache(maxsize=2)
def normal_table(seed: int, rows: int, dim: int) -> np.ndarray:
    """``jax.random.normal(PRNGKey(seed), (rows, dim), float32)`` in numpy
    (read-only; cached because every embedder of a process shares it)."""
    bits = random_bits(seed, rows * dim)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, (f * (np.float32(1.0) - lo) + lo).astype(np.float32))
    out = (np.float32(np.sqrt(2)) * erfinv32(u)).astype(np.float32).reshape(rows, dim)
    out.flags.writeable = False
    return out
