"""JAX's default random streams (threefry2x32, 20 rounds, partitionable
counters, 32-bit mode) in NumPy, written out from the published algorithm.

The system under test draws every utterance's NetVLAD weights from
``fold_in(PRNGKey(seed), ordinal)``; the plain reference works those
weights out again here, from nothing the program made.

* a key is a pair of uint32 words ``[..., 2]``; ``PRNGKey(s) = (0, s mod
  2**32)``; ``fold_in(k, d) = threefry(k, (0, d))``;
* ``split(k, n)[i] = threefry(k, (hi(i), lo(i)))``, ``bits(k, shape)[i] =
  xor(threefry(k, (hi(i), lo(i))))`` over the row-major index ``i``;
* ``uniform`` by the mantissa trick; ``normal = sqrt(2) * erfinv(u)`` with
  ``u`` uniform in ``(nextafter(-1, 0), 1)`` and XLA's single-precision
  erfinv polynomial (Giles).
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint32)


def threefry2x32(k1, k2, x1, x2):
    """The block cipher on broadcastable uint32 arrays -> two uint32 words
    (uint32 arithmetic wraps, as the cipher needs)."""
    k1, k2, x1, x2 = (_u32(a) for a in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ _u32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x1 = x1 + ks[0]
        x2 = x2 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x1 = x1 + x2
                x2 = ((x2 << _u32(r)) | (x2 >> _u32(32 - r))) ^ x1
            x1 = x1 + ks[(i + 1) % 3]
            x2 = x2 + ks[(i + 2) % 3] + _u32(i + 1)
    return x1, x2


def prng_key(seed: int) -> np.ndarray:
    return _u32([0, int(seed) & 0xFFFFFFFF])


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    o1, o2 = threefry2x32(key[0], key[1], 0, int(data) & 0xFFFFFFFF)
    return np.stack([o1, o2]).astype(np.uint32)


def split(key: np.ndarray, num: int) -> np.ndarray:
    """[num, 2] keys."""
    idx = np.arange(num, dtype=np.uint64)
    o1, o2 = threefry2x32(key[0], key[1], (idx >> np.uint64(32)).astype(
        np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return np.stack([o1, o2], axis=-1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64)
    o1, o2 = threefry2x32(key[0], key[1], (idx >> np.uint64(32)).astype(
        np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (o1 ^ o2).reshape(shape)


def uniform(key: np.ndarray, shape, minval: float, maxval: float):
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - np.float32(minval))
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    if span > 0 and math.frexp(float(span))[0] == 0.5:
        scaled = floats * span + lo
    else:
        scaled = (floats.astype(np.float64) * float(span)
                  + float(lo)).astype(np.float32)
    return np.maximum(scaled, lo).astype(np.float32)


_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
        0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
        1.50140941)
_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
        0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
        2.83297682)


def erfinv(x: np.ndarray) -> np.ndarray:
    """float32 inverse error function (M. Giles' single-precision
    polynomial, as XLA computes it)."""
    x = x.astype(np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_LT5[0]), np.float32(_GE5[0]))
    for a, b in zip(_LT5[1:], _GE5[1:]):
        p = (np.where(lt, np.float32(a), np.float32(b))
             + p * w).astype(np.float32)
    out = np.where(np.abs(x) == 1.0, x * np.finfo(np.float32).max, p * x)
    return out.astype(np.float32)


def normal(key: np.ndarray, shape) -> np.ndarray:
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv(u)).astype(np.float32)
