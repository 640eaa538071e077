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

Two routes, chosen by the key's device:

* on a CUDA key each public draw is one launch of ``threefry_draw``
  (``csrc/threefry.cu``, built with ``nvcc`` at first use, see
  :mod:`.._build`) on the current stream, which writes the draw's final
  type (int64 keys or bits, float32 uniforms or normals, bool masks) and
  adds one to :data:`LAUNCHES`; a build or launch failure raises, and
  there is no fallback to the plain route;
* on a CPU key the draw is its plain version (``fold_in_torch``,
  ``split_torch``, ``random_bits_torch``, ``uniform_torch``,
  ``normal_torch``, ``bernoulli_torch``), the kernel's oracle on any
  device: int64 arithmetic with a ``& 0xFFFFFFFF`` mask after every add
  (torch's uint32 coverage is thin), every operation elementwise, so a
  batch of keys broadcasts against the counters.

Each public draw is a profiling region ``prng/{fold_in,split,uniform,
normal,bernoulli,random_bits}``; a draw made inside another, or under
:func:`unrecorded`, opens none.
"""

from __future__ import annotations

import ctypes
import functools
import math
import numbers
import threading

import numpy as np
import torch

from icassp2022_depression_tpu_torch import _build
from icassp2022_depression_tpu_torch.utils import profiling

MASK = 0xFFFFFFFF
#: kernel launches made by the draws on CUDA keys in this process, one a
#: draw (``rnn_cuda.launch_counts()["threefry"]``)
LAUNCHES = 0
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_drawing = threading.local()


def _draw(fn):
    """A public draw as the region ``prng/<name>``, unless it is made
    inside another draw."""
    name = f"prng/{fn.__name__}"

    @functools.wraps(fn)
    def draw(key, *args, **kw):
        if getattr(_drawing, "on", False):
            return fn(key, *args, **kw)
        with unrecorded(), profiling.annotate(name, key.device):
            return fn(key, *args, **kw)

    return draw


class unrecorded:
    """The draws made inside open no profiling region (a captured
    program's draws run once, at capture, so their regions would time
    nothing of its replays).  A plain context manager rather than a
    generator's: every draw enters one, and its host cost is the hot
    path."""

    __slots__ = ("was",)

    def __enter__(self) -> None:
        self.was = getattr(_drawing, "on", False)
        _drawing.on = True

    def __exit__(self, *exc) -> None:
        _drawing.on = self.was


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


def _on_card(key: torch.Tensor) -> bool:
    """Whether a draw of ``key`` takes the kernel route: any key off the
    CPU (the kernel's wrapper raises on a device it does not take)."""
    return key.device.type != "cpu"


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` -> int64 tensor [2]."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


@_draw
def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys [..., 2] with data broadcastable to
    ``key.shape[:-1]`` -> keys [..., 2]."""
    if not _on_card(key):
        return fold_in_torch(key, data)
    return _fold_in_kernel(key, data)


def fold_in_torch(key: torch.Tensor, data) -> torch.Tensor:
    """Plain PyTorch :func:`fold_in` (on any device), the kernel's oracle."""
    data = torch.as_tensor(data, dtype=torch.int64,
                           device=key.device) & MASK
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([o1, o2], dim=-1)


def _counters(n: int, device):
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK


@_draw
def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): keys [..., 2] -> [..., num, 2]."""
    if not _on_card(key):
        return split_torch(key, num)
    return _kernel_draw(key, _SPLIT, (num,))


def split_torch(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """Plain PyTorch :func:`split`."""
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


#: counters per threefry pass of the plain route: a larger draw (an
#: embedding table of millions of entries) runs in slices of this many, so
#: the cipher's int64 temporaries stay bounded (the kernel writes any
#: number of counters in one launch)
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


@_draw
def random_bits(key: torch.Tensor, shape, rows=None) -> torch.Tensor:
    """``jax.random.bits`` (32-bit, partitionable): keys [..., 2] ->
    int64 tensor [..., *shape] of uint32 values.  ``rows = (first,
    total)``: rows ``first .. first + shape[0]`` of the ``[total,
    *shape[1:]]`` draw, bit for bit (each value's counter is its row-major
    index, so a row range is a counter range)."""
    if not _on_card(key):
        return random_bits_torch(key, shape, rows)
    shape = tuple(shape)
    return _kernel_draw(key, _BITS, shape, _offset(shape, rows))


def random_bits_torch(key: torch.Tensor, shape, rows=None) -> torch.Tensor:
    """Plain PyTorch :func:`random_bits`."""
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


def _bounds(minval: float, maxval: float) -> tuple:
    """(lo, span) of a uniform draw: the float32 bounds and their float32
    difference, as Python floats (exact), so that no host value is copied
    to the device (a CUDA graph may capture the draw)."""
    lo = float(np.float32(minval))
    return lo, float(np.float32(maxval) - np.float32(minval))


def _pow2(span: float) -> bool:
    return span > 0 and math.frexp(span)[0] == 0.5


def _scale(bits: torch.Tensor, lo: float, span: float) -> torch.Tensor:
    float_bits = (bits >> 9) | 0x3F800000
    floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
    if _pow2(span):
        scaled = floats * span + lo
    else:
        scaled = (floats.double() * span + lo).float()
    return torch.clamp(scaled, min=lo)


@_draw
def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0, rows=None) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits become the
    mantissa of a float in [1, 2), minus 1, scaled to [minval, maxval).
    XLA fuses the scale and shift into one FMA.  Where the float32 span is
    a power of two (``normal``'s), the product is exact and a float32
    multiply and add round as the FMA does; otherwise the product of two
    float32 values is exact in float64, so one float64 multiply-add
    rounded once to float32 gives its bits.  ``rows``: as
    :func:`random_bits`."""
    if not _on_card(key):
        return uniform_torch(key, shape, minval, maxval, rows)
    lo, span = _bounds(minval, maxval)
    shape = tuple(shape)
    return _kernel_draw(key, _UNIFORM, shape, _offset(shape, rows), lo=lo,
                        span=span)


def uniform_torch(key: torch.Tensor, shape, minval: float = 0.0,
                  maxval: float = 1.0, rows=None) -> torch.Tensor:
    """Plain PyTorch :func:`uniform`.  A draw of more than ``_BITS_CHUNK``
    values (VGGish's 50 M-float first FC) runs slice by slice into the
    float32 result, so no int64 tensor of the whole draw is ever made."""
    lo, span = _bounds(minval, maxval)
    shape = tuple(shape)
    n = math.prod(shape)
    if n <= _BITS_CHUNK:
        return _scale(random_bits_torch(key, shape, rows), lo, span)
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


@_draw
def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal`` in float32: keys [..., 2] -> [..., *shape]."""
    if not _on_card(key):
        return normal_torch(key, shape)
    lo, span = _bounds(_NORMAL_LO, 1.0)
    return _kernel_draw(key, _NORMAL, tuple(shape), lo=lo, span=span)


def normal_torch(key: torch.Tensor, shape) -> torch.Tensor:
    """Plain PyTorch :func:`normal`."""
    u = uniform_torch(key, shape, _NORMAL_LO, 1.0)
    return _SQRT2 * erfinv(u)


@_draw
def bernoulli(key: torch.Tensor, p: float, shape, rows=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a float ``p`` in 32-bit
    mode: keys [..., 2] -> bool [..., *shape], True where a float32
    uniform draw is below ``p``.  ``rows``: as :func:`random_bits`."""
    if not _on_card(key):
        return bernoulli_torch(key, p, shape, rows)
    shape = tuple(shape)
    # the comparison is in float32, as the plain route's ``< p``
    return _kernel_draw(key, _BERNOULLI, shape, _offset(shape, rows),
                        p=float(np.float32(p)))


def bernoulli_torch(key: torch.Tensor, p: float, shape,
                    rows=None) -> torch.Tensor:
    """Plain PyTorch :func:`bernoulli`."""
    return uniform_torch(key, shape, rows=rows) < p


# -- the kernel route ---------------------------------------------------------

#: ``csrc/threefry.cu``'s draws (its ``Mode``) and the type each writes
_FOLD_IN, _SPLIT, _BITS, _UNIFORM, _NORMAL, _BERNOULLI = range(6)
_DTYPES = (torch.int64, torch.int64, torch.int64, torch.float32,
           torch.float32, torch.bool)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_uint32, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_ulonglong,
             ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
             ctypes.c_float, ctypes.c_void_p]
_fn = None


def _kernel():
    """The C entry ``threefry_draw``, built and bound at first use."""
    global _fn
    if _fn is None:
        fn = _build.load("threefry").threefry_draw
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _fn = fn
    return _fn


def _check_key(key: torch.Tensor) -> None:
    """Raises on keys the kernel does not take."""
    if key.dtype is not torch.int64:
        raise TypeError(f"threefry: keys must be int64, got {key.dtype}")
    shape = key.shape
    if not shape or shape[-1] != 2:
        raise ValueError(f"threefry: keys must be [..., 2], got "
                         f"{tuple(shape)}")
    if key.stride(-1) != 1:
        raise ValueError("threefry: keys must be contiguous in their last "
                         "axis")
    if not key.is_cuda:
        raise ValueError(f"threefry: unsupported device {key.device}")


def _rows(t: torch.Tensor, dims: int) -> tuple:
    """``t`` with its first ``dims`` axes read as one row axis -> (t, the
    rows' stride): the stride of the axes where they collapse into one (0
    for one row or a broadcast one), else a contiguous copy's.  Reading
    the strides makes no view, so a draw dispatches no op for its keys."""
    axes = [(n, s) for n, s in zip(t.shape[:dims], t.stride()[:dims])
            if n != 1]
    if all(s0 == s1 * n1 for (_, s0), (n1, s1) in zip(axes, axes[1:])):
        return t, axes[-1][1] if axes else 0
    t = t.contiguous()
    return t, math.prod(t.shape[dims:])


def _launch(out: torch.Tensor, rows: int, keys: torch.Tensor,
            key_stride: int, n: int, mode: int, start: int = 0, data=None,
            data_stride: int = 0, lo: float = 0.0, span: float = 1.0,
            p: float = 0.0) -> torch.Tensor:
    """One ``threefry_draw`` launch into ``out``: ``rows`` rows of ``n``
    counters, row r's key at ``keys`` + r ``key_stride``, on the current
    stream.  ``data`` (fold_in): a uint32 value, or int64 rows
    ``data_stride`` apart."""
    global LAUNCHES
    if out.numel() == 0:
        return out
    if isinstance(data, torch.Tensor):
        d_ptr, d_value = data.data_ptr(), 0
    else:
        d_ptr, d_value = None, data or 0
    args = (keys.data_ptr(), key_stride, d_ptr, data_stride, d_value,
            out.data_ptr(), rows, n, start, mode, lo, span, int(_pow2(span)),
            p)
    # the raw stream handle (a ``torch.cuda.Stream`` object costs about
    # 10 us a draw on the card's host); the device switched only when the
    # draw is on another card than the current one
    device = out.get_device()
    if device == torch.cuda.current_device():
        err = _kernel()(*args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            err = _kernel()(*args,
                            torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"threefry_draw launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def _kernel_draw(key: torch.Tensor, mode: int, shape: tuple, start: int = 0,
                 **scale) -> torch.Tensor:
    """A split, bits, uniform, normal or bernoulli draw of keys [..., 2]
    at the counters ``start ..`` -> [..., *shape] (a split: [..., num,
    2])."""
    _check_key(key)
    keys, stride = _rows(key, key.dim() - 1)
    tail = (2,) if mode == _SPLIT else ()
    out = torch.empty(key.shape[:-1] + shape + tail, dtype=_DTYPES[mode],
                      device=key.device)
    return _launch(out, key.numel() // 2, keys, stride, math.prod(shape),
                   mode, start, **scale)


def _fold_in_kernel(key: torch.Tensor, data) -> torch.Tensor:
    """:func:`fold_in` on a CUDA key: a Python integer goes to the kernel
    as a value, a tensor as rows of a pointer (one row: stride 0)."""
    _check_key(key)
    lead, d_stride = key.shape[:-1], 0
    if isinstance(data, numbers.Integral):
        data = int(data) & MASK
    else:
        if not (isinstance(data, torch.Tensor) and data.dtype == torch.int64
                and data.device == key.device):
            data = torch.as_tensor(data, dtype=torch.int64,
                                   device=key.device)
        # numpy's: torch.broadcast_shapes imports sympy at its first call,
        # seconds on a process's first draw
        lead = np.broadcast_shapes(tuple(lead), tuple(data.shape))
        if data.numel() > 1:
            data, d_stride = _rows(data.expand(lead) if data.shape != lead
                                   else data, len(lead))
    if key.numel() > 2 and key.shape[:-1] != lead:
        key = key.expand(lead + (2,))
    keys, k_stride = _rows(key, key.dim() - 1)
    out = torch.empty(lead + (2,), dtype=torch.int64, device=key.device)
    return _launch(out, math.prod(lead), keys, k_stride, 1, _FOLD_IN,
                   data=data, data_stride=d_stride)
