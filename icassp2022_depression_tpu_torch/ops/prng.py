"""JAX's threefry2x32 random streams in torch, bit for bit.

The JAX package draws every utterance's NetVLAD weights from
``jax.random.fold_in(PRNGKey(seed), ordinal)`` followed by ``split`` and
``normal`` (:mod:`icassp2022_depression_tpu.ops.netvlad`).  Features, and
so every served prediction, depend on those exact numbers, so this module
reproduces JAX's default PRNG (threefry2x32, 20 rounds) with
``jax_threefry_partitionable=True`` and 32-bit mode, the JAX 0.9 defaults:

* a key is a pair of uint32 words, held here in the last axis of an int64
  tensor (``[..., 2]``);
* ``PRNGKey(seed) = (0, seed mod 2**32)``;
* ``fold_in(key, d) = threefry(key, (0, d))``;
* ``split(key, n)[i] = threefry(key, (hi(i), lo(i)))`` and
  ``random_bits(key, shape)[i] = xor(threefry(key, (hi(i), lo(i))))`` over
  the row-major index ``i`` (``jax/_src/prng.py``, ``iota_2x32_shape``);
* ``uniform`` by the mantissa trick, ``bernoulli(key, p, shape) =
  uniform(key, shape) < p`` (``jax.random.bernoulli`` in float32), and
  ``normal = sqrt(2) * erfinv(u)`` with ``u`` uniform in
  ``(nextafter(-1, 0), 1)`` (``jax/_src/random.py``); ``erfinv`` is XLA's
  single-precision polynomial (Giles), so the two frameworks agree to an
  ulp instead of to the accuracy of two different approximations.

The arithmetic is int64 with a ``& 0xFFFFFFFF`` mask after every add
(torch's uint32 coverage is thin); every operation is elementwise, so a
batch of keys broadcasts against the counters and a whole bucket's
weights are one pass on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 block cipher on broadcastable int64 tensors holding
    uint32 values -> the two output words.  The rounds update the two
    words in place (they are fresh tensors after the first key addition),
    which keeps a large draw's temporaries to a few."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]).bitwise_and_(MASK)
    x2 = (x2 + ks[1]).bitwise_and_(MASK)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1.add_(x2).bitwise_and_(MASK)
            # rotate left by r, then mix in x1
            x2 = (x2 << r).bitwise_and_(MASK).bitwise_or_(
                x2 >> (32 - r)).bitwise_xor_(x1)
        x1.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x2.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK)
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` -> int64 tensor [2]."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys [..., 2] with data broadcastable to
    ``key.shape[:-1]`` -> keys [..., 2]."""
    data = torch.as_tensor(data, dtype=torch.int64,
                           device=key.device) & MASK
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([o1, o2], dim=-1)


def _counters(n: int, device):
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): keys [..., 2] -> [..., num, 2]."""
    hi, lo = _counters(num, key.device)
    o1, o2 = threefry2x32(key[..., 0:1], key[..., 1:2], hi, lo)
    return torch.stack([o1, o2], dim=-1)


def split2(key):
    """``jax.random.split(key)`` as a pair of keys [..., 2] (a None key:
    two None)."""
    if key is None:
        return None, None
    ks = split(key)
    return ks[..., 0, :], ks[..., 1, :]


#: counters per threefry pass of :func:`random_bits`: a larger draw (an
#: embedding table of millions of entries) runs in slices of this many, so
#: the cipher's int64 temporaries stay bounded
_BITS_CHUNK = 1 << 22


def _bits(k1, k2, start: int, stop: int) -> torch.Tensor:
    idx = torch.arange(start, stop, dtype=torch.int64, device=k1.device)
    o1, o2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return o1 ^ o2


def _offset(shape, rows) -> int:
    """The first counter of a draw: 0, or with ``rows = (first, total)``
    the counter of row ``first`` of a ``[total, *shape[1:]]`` draw."""
    if rows is None:
        return 0
    first, total = rows
    if not 0 <= first <= first + shape[0] <= total:
        raise ValueError(f"rows {first}..{first + shape[0]} are not rows "
                         f"of a draw of {total}")
    return first * math.prod(shape[1:])


def random_bits(key: torch.Tensor, shape, rows=None) -> torch.Tensor:
    """``jax.random.bits`` (32-bit, partitionable): keys [..., 2] ->
    int64 tensor [..., *shape] of uint32 values.  ``rows = (first,
    total)``: rows ``first .. first + shape[0]`` of the ``[total,
    *shape[1:]]`` draw, bit for bit (each value's counter is its row-major
    index, so a row range is a counter range)."""
    shape = tuple(shape)
    n = math.prod(shape)
    start0 = _offset(shape, rows)
    k1, k2 = key[..., 0:1], key[..., 1:2]
    if n <= _BITS_CHUNK:
        return _bits(k1, k2, start0, start0 + n).reshape(key.shape[:-1]
                                                         + shape)
    out = torch.empty(key.shape[:-1] + (n,), dtype=torch.int64,
                      device=key.device)
    for start in range(0, n, _BITS_CHUNK):
        stop = min(n, start + _BITS_CHUNK)
        out[..., start:stop] = _bits(k1, k2, start0 + start, start0 + stop)
    return out.reshape(key.shape[:-1] + shape)


def _scale(bits: torch.Tensor, lo: float, span: float) -> torch.Tensor:
    float_bits = (bits >> 9) | 0x3F800000
    floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
    if span > 0 and math.frexp(span)[0] == 0.5:
        scaled = floats * span + lo
    else:
        scaled = (floats.double() * span + lo).float()
    return torch.clamp(scaled, min=lo)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0, rows=None) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits become the
    mantissa of a float in [1, 2), minus 1, scaled to [minval, maxval).
    XLA fuses the scale and shift into one FMA.  Where the float32 span is
    a power of two (``normal``'s), the product is exact and a float32
    multiply and add round as the FMA does; otherwise the product of two
    float32 values is exact in float64, so one float64 multiply-add
    rounded once to float32 gives its bits.

    A draw of more than ``_BITS_CHUNK`` values (VGGish's 50 M-float first
    FC) runs slice by slice into the float32 result, so no int64 tensor of
    the whole draw is ever made.  ``rows``: as :func:`random_bits`."""
    # the float32 bounds as Python floats (exact), so that no host value
    # is copied to the device (a CUDA graph may capture this)
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    shape = tuple(shape)
    n = math.prod(shape)
    if n <= _BITS_CHUNK:
        return _scale(random_bits(key, shape, rows), lo, span)
    start0 = _offset(shape, rows)
    k1, k2 = key[..., 0:1], key[..., 1:2]
    out = torch.empty(key.shape[:-1] + (n,), dtype=torch.float32,
                      device=key.device)
    for start in range(0, n, _BITS_CHUNK):
        stop = min(n, start + _BITS_CHUNK)
        out[..., start:stop] = _scale(
            _bits(k1, k2, start0 + start, start0 + stop), lo, span)
    return out.reshape(key.shape[:-1] + shape)


# XLA's ErfInv for float32 (M. Giles, "Approximating the erfinv function")
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, XLA's polynomial."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(x.dtype)
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, c_lt, c_ge).to(x.dtype) + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(x.dtype).max, p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal`` in float32: keys [..., 2] -> [..., *shape]."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return _SQRT2 * erfinv(u)


def bernoulli(key: torch.Tensor, p: float, shape, rows=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a float ``p`` in 32-bit
    mode: keys [..., 2] -> bool [..., *shape], True where a float32
    uniform draw is below ``p``.  ``rows``: as :func:`random_bits`."""
    return uniform(key, shape, rows=rows) < p
