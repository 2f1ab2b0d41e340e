"""The reference's random draws, replayed in numpy.

``jax.random`` with its default implementation (threefry2x32 with the
partitionable counter layout, jax 0.9): ``key(seed)`` is
``jax.random.PRNGKey(seed)``, ``split(key, n)`` is ``jax.random.split``,
and ``normal(key, shape)`` is ``jax.random.normal(key, shape)`` in fp32:
the same uniform bits, the same mapping to (-1, 1), then
``sqrt(2) * erfinv(u)``.  The bits and the uniforms are exact; ``erfinv``
is taken in fp64 and rounded once to fp32, where XLA evaluates a
single-precision polynomial, so a draw may differ from the reference's
by an ulp or two.  The port's train programs draw their initial weights
this way, so that a seed gives the reference's initial network.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

#: XLA's ErfInv32 (Giles, "Approximating the erfinv function"): the
#: polynomials in ``w - 2.5`` for ``w < 5`` and in ``sqrt(w) - 3`` above
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under ``key`` (two uint32), as ``jax``'s ``threefry2x32_p``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as two uint32, as jax forms it from an
    int seed without x64: ``[0, seed mod 2^32]``."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _iota(n: int):
    """The 64-bit counters 0..n-1 as (high, low) uint32 halves."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), \
        (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(k: np.ndarray, n: int) -> list:
    """``jax.random.split(k, n)``: n new keys."""
    b0, b1 = threefry2x32(k, *_iota(n))
    return [np.array([a, b], np.uint32) for a, b in zip(b0, b1)]


def _horner_fma(coeffs, w: np.ndarray) -> np.ndarray:
    """``p = c[0]; p = p * w + c[i]`` in fp32, each step one rounding (an
    FMA, taken in fp64)."""
    p = np.full_like(w, np.float32(coeffs[0]))
    w64 = w.astype(np.float64)
    for c in coeffs[1:]:
        p = (p.astype(np.float64) * w64 + np.float64(np.float32(c))) \
            .astype(np.float32)
    return p


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's single-precision ``erf_inv`` for x in (-1, 1)."""
    x = x.astype(np.float32)
    w = -np.log1p(-x * x)
    central = _horner_fma(_ERFINV_CENTRAL, w - np.float32(2.5))
    tail = _horner_fma(_ERFINV_TAIL, np.sqrt(w) - np.float32(3.0))
    return np.where(w < np.float32(5.0), central, tail) * x


def normal(k: np.ndarray, shape) -> torch.Tensor:
    """``jax.random.normal(k, shape)`` in fp32, as a CPU tensor."""
    n = math.prod(shape)
    b0, b1 = threefry2x32(k, *_iota(n))
    bits = (b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    # (1 - lo) rounds to 2 in fp32, so the scaling product is exact
    u = np.maximum(lo, floats * (np.float32(1.0) - lo) + lo)
    z = np.float32(np.sqrt(2)) * erfinv_f32(u)
    return torch.from_numpy(z.reshape(tuple(shape)))
