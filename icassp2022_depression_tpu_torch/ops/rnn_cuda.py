"""The GRU, LSTM and LSTMP recurrences and their backwards as hand-written
CUDA kernels (counterpart of :mod:`icassp2022_depression_tpu.ops.rnn_pallas`).

:func:`gru_sequence` keeps the JAX function's contract:
``xp [T, B, 3H]`` (input projections), ``w_hh_t [H, 3H]``,
``b_hh [1, 3H]`` -> every hidden state ``ys [T, B, H]``, zero initial
state, torch gate order r, z, n.  :func:`gru_sequence_bwd` is the custom
VJP of the JAX package (``_bwd_rule``): ``(xp, w_hh_t, b_hh, ys, dys) ->
(dxp, dw_hh_t, db_hh)``.  :class:`GRUSequence` ties the two together for
autograd.  :func:`lstm_sequence` (``xp [T, B, 4H] -> (ys, cs)``, gate order
i, f, g, o), :func:`lstm_sequence_bwd` (``_lstm_bwd_rule``: ``(xp, w_hh_t,
b_hh, ys, cs, dys, dcs) -> (dxp, dw_hh_t, db_hh)``, with a cotangent for
every step's cell state) and :class:`LSTMSequence` are the LSTM's.
:func:`lstmp_sequence` (the ELMo biLM cell, ``_lstmp_stream_fwd``: ``xp4
[T, B, 4, C]``, ``w_h_t3 [P, 4, C]``, ``b3 [1, 4, C]``, ``w_p_t [C, P]`` ->
``(ys, hpre [T, B, P], cpre, hf [T, B, C])``), :func:`lstmp_sequence_bwd`
(the kernel half of ``_lstmp_stream_bwd_rule``: -> ``(dgates [T, B, 4, C],
dhpre [T, B, P])``) and :class:`LSTMPSequence` (``lstmp_sequence_streamed``'s
custom VJP, the weight gradients as three products over ``T*B`` outside
the kernel, as the JAX rule computes them) are the LSTMP's.

* On CUDA tensors the wrappers launch ``gru_seq_fwd_f32``
  (``csrc/gru_fwd.cu``), ``gru_seq_bwd_f32`` (``csrc/gru_bwd.cu``),
  ``lstm_seq_fwd_f32`` (``csrc/lstm_fwd.cu``), ``lstm_seq_bwd_f32``
  (``csrc/lstm_bwd.cu``), ``lstmp_seq_fwd_f32`` (``csrc/lstmp_fwd.cu``) and
  ``lstmp_seq_bwd_f32`` (``csrc/lstmp_bwd.cu``), built with ``nvcc`` at
  first use (see :mod:`.._build`), on the current stream, and add one to
  :data:`LAUNCHES`, :data:`BWD_LAUNCHES`, :data:`LSTM_LAUNCHES`,
  :data:`LSTM_BWD_LAUNCHES`, :data:`LSTMP_LAUNCHES` and
  :data:`LSTMP_BWD_LAUNCHES` (one per call of the C entry, which loops over
  the T steps itself).  A backward call at a (T, B, H) that the JAX
  package runs through its streamed backward kernel instead
  (:func:`streamed`) counts in :data:`GRU_BWD_STREAMED_LAUNCHES` or
  :data:`LSTM_BWD_STREAMED_LAUNCHES` in place of the backward's own.  Calls captured into a CUDA graph are counted at
  each replay instead (:func:`add_launches`).  They never fall back to the plain versions:
  a build or launch failure raises.
* The GRU and LSTM forwards and the GRU and LSTM backwards each have two
  routes, picked from the shape by :func:`gru_fwd_plan`,
  :func:`lstm_fwd_plan`, :func:`gru_bwd_plan` and :func:`lstm_bwd_plan` (a
  ``plan=`` argument overrides it): "sequence", one block per batch row
  walking all T steps in one launch, and "step", one wide launch a step
  (cell slabs x row tiles, ``W_hh`` streamed through a ``cp.async`` ring,
  programmatic dependent launch); the backwards' step route adds one
  launch that recomputes every step's gates before the walk and one (two)
  for the weight gradients after it.  The LSTMP forward and backward have
  one route each, of the same kind (:func:`lstmp_fwd_plan`,
  :func:`lstmp_bwd_plan`): the backward recomputes every step's gates
  before the walk and reduces the partial carries in a fixed order after
  each step.
* On CPU tensors they run the plain versions (``*_torch``), which are the
  kernels' oracles.
* Fold axis (the counterpart of ``jax.vmap`` over ``pallas_call``, whose
  batching rule gives each fold its own weights): the GRU and LSTM
  forwards and backwards also take ``xp [F, T, B, G*H]``, ``w_hh_t
  [F, H, G*H]``, ``b_hh [F, 1, G*H]`` and give every output a leading
  ``F``.  One launch covers all folds (``gridDim.z = F``, per-fold
  pointer strides in the kernels), each fold with the plan of its own
  (T, B, H) and its weight gradient summed in the single-fold order; the
  plain versions run the folds one after the other.

Importing this module needs no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from icassp2022_depression_tpu_torch import _build

#: forward kernel launches made by :func:`gru_sequence` in this process
LAUNCHES = 0
#: backward kernel launches made by :func:`gru_sequence_bwd`
BWD_LAUNCHES = 0
#: LSTM forward kernel launches made by :func:`lstm_sequence`
LSTM_LAUNCHES = 0
#: LSTM backward kernel launches made by :func:`lstm_sequence_bwd`
LSTM_BWD_LAUNCHES = 0
#: backward launches of :func:`gru_sequence_bwd` and
#: :func:`lstm_sequence_bwd` at the shapes where the JAX package takes its
#: streamed backward kernels (:func:`streamed`), not counted above
GRU_BWD_STREAMED_LAUNCHES = 0
LSTM_BWD_STREAMED_LAUNCHES = 0
#: LSTMP forward launches made by :func:`lstmp_sequence`
LSTMP_LAUNCHES = 0
#: LSTMP backward launches made by :func:`lstmp_sequence_bwd`
LSTMP_BWD_LAUNCHES = 0

#: the launch counters above, by kernel source
COUNTERS = {"gru_fwd": "LAUNCHES", "gru_bwd": "BWD_LAUNCHES",
            "lstm_fwd": "LSTM_LAUNCHES", "lstm_bwd": "LSTM_BWD_LAUNCHES",
            "lstmp_fwd": "LSTMP_LAUNCHES", "lstmp_bwd": "LSTMP_BWD_LAUNCHES",
            "gru_bwd_streamed": "GRU_BWD_STREAMED_LAUNCHES",
            "lstm_bwd_streamed": "LSTM_BWD_STREAMED_LAUNCHES"}

#: the working set above which the JAX package runs a recurrence through
#: its streamed kernels (``ops/rnn.py::PALLAS_VMEM_BUDGET_BYTES``)
STREAM_BUDGET_BYTES = 12 * 1024 * 1024


def streamed(t_steps: int, batch: int, hidden: int, gates: int) -> bool:
    """Whether the JAX package runs a (T, B, H) GRU (``gates`` 3) or LSTM
    (4) fold through its streamed kernels, whose backward is TPU kernel #3
    or #5 in place of #2 or #8: its backward working set exceeds
    :data:`STREAM_BUDGET_BYTES` (``ops/rnn.py::_pallas_fits``)."""
    g = gates * hidden
    states = 2 if gates == 4 else 1
    need = (2 * batch * t_steps * g + (states + 1) * batch * t_steps * hidden
            + 2 * g * hidden + 2 * batch * hidden) * 4
    return need > STREAM_BUDGET_BYTES


def launch_counts() -> dict:
    """Every launch counter, by kernel source."""
    return {k: globals()[v] for k, v in COUNTERS.items()}


def add_launches(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the counters: a CUDA graph launches its
    captured calls at every replay, and nothing while it is captured (see
    :meth:`..train.loop.FoldRun.run`)."""
    for k, v in delta.items():
        globals()[COUNTERS[k]] += v * times


#: each source's C entry: (symbol, pointer arguments, int arguments, float
#: arguments), then the stream
_ENTRIES = {"gru_fwd": ("gru_seq_fwd_f32", 4, 6, 0),
            "gru_bwd": ("gru_seq_bwd_f32", 12, 7, 0),
            "lstm_fwd": ("lstm_seq_fwd_f32", 5, 6, 0),
            "lstm_bwd": ("lstm_seq_bwd_f32", 13, 7, 0),
            "lstmp_fwd": ("lstmp_seq_fwd_f32", 9, 6, 2),
            "lstmp_bwd": ("lstmp_seq_bwd_f32", 12, 6, 2)}
_fns: dict = {}


def _kernel(name: str):
    """The C entry of ``csrc/<name>.cu``, built and bound at first use."""
    if name not in _fns:
        symbol, n_ptrs, n_ints, n_floats = _ENTRIES[name]
        fn = getattr(_build.load(name), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _gates(x: torch.Tensor, hp: torch.Tensor, hidden: int):
    r = torch.sigmoid(x[:, :hidden] + hp[:, :hidden])
    z = torch.sigmoid(x[:, hidden:2 * hidden] + hp[:, hidden:2 * hidden])
    n = torch.tanh(x[:, 2 * hidden:] + r * hp[:, 2 * hidden:])
    return r, z, n


def _per_fold(fn, *args):
    """``fn`` on each fold of fold-stacked arguments, the results stacked
    (a tuple of results: each stacked)."""
    outs = [fn(*(a[f] for a in args)) for f in range(args[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def gru_sequence_torch(xp: torch.Tensor, w_hh_t: torch.Tensor,
                       b_hh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch GRU recurrence, the forward kernel's reference (with a
    fold axis: each fold alone)."""
    if xp.dim() == 4:
        return _per_fold(gru_sequence_torch, xp, w_hh_t, b_hh)
    t_steps, batch, g = xp.shape
    hidden = g // 3
    b_hh = b_hh.reshape(g)
    h = xp.new_zeros((batch, hidden))
    ys = []
    for t in range(t_steps):
        hp = torch.matmul(h, w_hh_t) + b_hh
        r, z, n = _gates(xp[t], hp, hidden)
        h = (1.0 - z) * n + z * h
        ys.append(h)
    if not ys:
        return xp.new_zeros((0, batch, hidden))
    return torch.stack(ys)


def gru_sequence_bwd_torch(xp: torch.Tensor, w_hh_t: torch.Tensor,
                           b_hh: torch.Tensor, ys: torch.Tensor,
                           dys: torch.Tensor):
    """Plain PyTorch GRU backward, the backward kernel's reference: the
    reverse loop of ``rnn_pallas._gru_bwd_kernel``, recomputing the gates
    from ``ys``.  Returns (dxp [T, B, 3H], dw_hh_t [H, 3H], db_hh [1, 3H])
    (with a fold axis: each fold alone)."""
    if xp.dim() == 4:
        return _per_fold(gru_sequence_bwd_torch, xp, w_hh_t, b_hh, ys, dys)
    t_steps, batch, g = xp.shape
    hidden = g // 3
    b = b_hh.reshape(g)
    carry = xp.new_zeros((batch, hidden))
    dw = xp.new_zeros((hidden, g))
    db = xp.new_zeros((g,))
    dxp = [None] * t_steps
    for t in reversed(range(t_steps)):
        h_prev = ys[t - 1] if t > 0 else xp.new_zeros((batch, hidden))
        hp = torch.matmul(h_prev, w_hh_t) + b
        r, z, n = _gates(xp[t], hp, hidden)
        hn = hp[:, 2 * hidden:]
        dh = dys[t] + carry
        ds_n = dh * (1.0 - z) * (1.0 - n * n)
        ds_r = ds_n * hn * r * (1.0 - r)
        ds_z = dh * (h_prev - n) * z * (1.0 - z)
        dgates_h = torch.cat([ds_r, ds_z, ds_n * r], dim=1)
        dxp[t] = torch.cat([ds_r, ds_z, ds_n], dim=1)
        carry = dh * z + torch.matmul(dgates_h, w_hh_t.t())
        dw = dw + torch.matmul(h_prev.t(), dgates_h)
        db = db + dgates_h.sum(dim=0)
    dxp = torch.stack(dxp) if t_steps else xp.new_zeros(xp.shape)
    return dxp, dw, db.reshape(1, g)


def _check(tensors: dict, shapes: dict) -> None:
    """Device, dtype, shape and contiguity checks before a launch (the
    first tensor names the device)."""
    first, device = next((k, t.device) for k, t in tensors.items())
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, {first} on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) not in shapes[name]:
            raise ValueError(f"{name} must be one of {shapes[name]}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _dims(xp: torch.Tensor, gates: int = 3):
    """(lead, T, B, H) of ``xp [T, B, GH]`` or ``[F, T, B, GH]``; ``lead``
    is () or (F,), the leading shape of every argument and result."""
    if xp.dim() not in (3, 4) or xp.shape[-1] % gates:
        raise ValueError(f"xp must be [T, B, {gates}H] or [F, T, B, "
                         f"{gates}H], got {tuple(xp.shape)}")
    t_steps, batch, g = xp.shape[-3:]
    return tuple(xp.shape[:-3]), t_steps, batch, g // gates


def _folds(lead: tuple) -> int:
    return lead[0] if lead else 1


def gru_sequence(xp: torch.Tensor, w_hh_t: torch.Tensor,
                 b_hh: torch.Tensor, plan: dict | None = None) -> torch.Tensor:
    """xp [T, B, 3H], w_hh_t [H, 3H], b_hh [1, 3H] (or [3H]) -> ys [T, B, H],
    or the same with a leading fold axis ``F`` on each (one launch).
    ``plan``: a :func:`gru_fwd_plan` for the kernel, by default the one it
    picks for (B, H); a CPU call ignores it.  The kernel's output carries
    no autograd graph, so a CUDA input that requires grad raises: gradients
    go through :class:`GRUSequence`."""
    if xp.device.type == "cpu":
        return gru_sequence_torch(xp, w_hh_t, b_hh)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_sequence: unsupported device {xp.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xp, w_hh_t, b_hh)):
        raise ValueError("gru_sequence: inputs require grad; call "
                         "GRUSequence.apply for a differentiable result")
    lead, t_steps, batch, hidden = _dims(xp)
    g = 3 * hidden
    _check({"xp": xp, "w_hh_t": w_hh_t, "b_hh": b_hh},
           {"xp": [lead + (t_steps, batch, g)], "w_hh_t": [lead + (hidden, g)],
            "b_hh": [lead + (1, g), lead + (g,)]})
    ys = torch.empty(lead + (t_steps, batch, hidden), dtype=torch.float32,
                     device=xp.device)
    if ys.numel() == 0:
        return ys
    if plan is None:
        plan = gru_fwd_plan(batch, hidden)
    xp, w_hh_t, b_hh = _aligned(plan, xp, w_hh_t, b_hh)
    fn = _kernel("gru_fwd")
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xp.data_ptr(), w_hh_t.data_ptr(), b_hh.data_ptr(),
                 ys.data_ptr(), t_steps, batch, hidden, _folds(lead),
                 plan["cells"], plan["rows"], stream)
    if err != 0:
        raise RuntimeError(f"gru_seq_fwd_f32 launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return ys


def gru_sequence_bwd(xp: torch.Tensor, w_hh_t: torch.Tensor,
                     b_hh: torch.Tensor, ys: torch.Tensor,
                     dys: torch.Tensor, plan: dict | None = None):
    """The backward kernel's wrapper: (dxp [T, B, 3H], dw_hh_t [H, 3H],
    db_hh [1, 3H]) of ``ys = gru_sequence(xp, w_hh_t, b_hh)`` given
    ``dys [T, B, H]``, each with a leading ``F`` for a fold axis.  ``plan``: a :func:`gru_bwd_plan` for the kernel, by
    default the one it picks for (T, B, H); a CPU call ignores it."""
    if xp.device.type == "cpu":
        return gru_sequence_bwd_torch(xp, w_hh_t, b_hh, ys, dys)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_sequence_bwd: unsupported device {xp.device}")
    lead, t_steps, batch, hidden = _dims(xp)
    g = 3 * hidden
    states = [lead + (t_steps, batch, hidden)]
    _check({"xp": xp, "w_hh_t": w_hh_t, "b_hh": b_hh, "ys": ys, "dys": dys},
           {"xp": [lead + (t_steps, batch, g)], "w_hh_t": [lead + (hidden, g)],
            "b_hh": [lead + (1, g), lead + (g,)], "ys": states,
            "dys": states})
    dxp = torch.empty_like(xp)
    dw = torch.empty(lead + (hidden, g), dtype=torch.float32,
                     device=xp.device)
    db = torch.empty(lead + (1, g), dtype=torch.float32, device=xp.device)
    if xp.numel() == 0:
        return dxp, dw.zero_(), db.zero_()
    if plan is None:
        plan = gru_bwd_plan(batch, hidden, steps=t_steps)
    dgates_h = torch.empty_like(xp)
    xp, w_hh_t, b_hh, ys, dys = _aligned(plan, xp, w_hh_t, b_hh, ys, dys)
    scratch = _bwd_scratch(plan, xp, hidden)    # hp, dh z, parts
    fn = _kernel("gru_bwd")
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xp.data_ptr(), w_hh_t.data_ptr(), b_hh.data_ptr(),
                 ys.data_ptr(), dys.data_ptr(), dxp.data_ptr(),
                 dgates_h.data_ptr(), dw.data_ptr(), db.data_ptr(),
                 *_ptrs(scratch), t_steps, batch, hidden, _folds(lead),
                 plan["cells"], plan["rows"], plan["splits"], stream)
    if err != 0:
        raise RuntimeError(f"gru_seq_bwd_f32 launch failed: cudaError {err}")
    global BWD_LAUNCHES, GRU_BWD_STREAMED_LAUNCHES
    if streamed(t_steps, batch, hidden, 3):
        GRU_BWD_STREAMED_LAUNCHES += 1
    else:
        BWD_LAUNCHES += 1
    return dxp, dw, db


class GRUSequence(torch.autograd.Function):
    """``ys = GRU(xp, w_hh_t, b_hh)`` with the kernels' backward
    (``jax.custom_vjp`` of ``rnn_pallas.gru_sequence`` on this side).

    ``plain=True`` runs the plain forward and backward on any device and
    launches no kernel (backend ``"torch"``); otherwise the wrappers
    launch the kernels for CUDA tensors and run the plain versions for CPU
    tensors."""

    @staticmethod
    def forward(ctx, xp, w_hh_t, b_hh, plain: bool = False):
        fwd = gru_sequence_torch if plain else gru_sequence
        ys = fwd(xp, w_hh_t, b_hh)
        ctx.save_for_backward(xp, w_hh_t, b_hh, ys)
        ctx.plain = plain
        return ys

    @staticmethod
    def backward(ctx, dys):
        xp, w_hh_t, b_hh, ys = ctx.saved_tensors
        # autograd hands dys over as a view through gru_layer's transpose
        bwd = gru_sequence_bwd_torch if ctx.plain else gru_sequence_bwd
        dxp, dw, db = bwd(xp, w_hh_t, b_hh, ys, dys.contiguous())
        return dxp, dw, db.reshape(b_hh.shape), None


def _lstm_gates(gp: torch.Tensor, hidden: int):
    i = torch.sigmoid(gp[:, :hidden])
    f = torch.sigmoid(gp[:, hidden:2 * hidden])
    g = torch.tanh(gp[:, 2 * hidden:3 * hidden])
    o = torch.sigmoid(gp[:, 3 * hidden:])
    return i, f, g, o


def lstm_sequence_torch(xp: torch.Tensor, w_hh_t: torch.Tensor,
                        b_hh: torch.Tensor):
    """Plain PyTorch LSTM recurrence, the forward kernel's reference.
    Returns (ys, cs), each [T, B, H] (with a fold axis: each fold alone)."""
    if xp.dim() == 4:
        return _per_fold(lstm_sequence_torch, xp, w_hh_t, b_hh)
    t_steps, batch, g = xp.shape
    hidden = g // 4
    b_hh = b_hh.reshape(g)
    h = xp.new_zeros((batch, hidden))
    c = xp.new_zeros((batch, hidden))
    ys, cs = [], []
    for t in range(t_steps):
        i, f, gg, o = _lstm_gates(xp[t] + torch.matmul(h, w_hh_t) + b_hh,
                                  hidden)
        c = f * c + i * gg
        h = o * torch.tanh(c)
        ys.append(h)
        cs.append(c)
    if not ys:
        empty = xp.new_zeros((0, batch, hidden))
        return empty, empty.clone()
    return torch.stack(ys), torch.stack(cs)


def lstm_sequence_bwd_torch(xp: torch.Tensor, w_hh_t: torch.Tensor,
                            b_hh: torch.Tensor, ys: torch.Tensor,
                            cs: torch.Tensor, dys: torch.Tensor,
                            dcs: torch.Tensor):
    """Plain PyTorch LSTM backward, the backward kernel's reference: the
    reverse loop of ``rnn_pallas._lstm_bwd_kernel``, recomputing the gates
    from ``ys``/``cs`` and adding ``dcs[t]`` to each step's cell-state
    cotangent.  Returns (dxp [T, B, 4H], dw_hh_t [H, 4H], db_hh [1, 4H])
    (with a fold axis: each fold alone)."""
    if xp.dim() == 4:
        return _per_fold(lstm_sequence_bwd_torch, xp, w_hh_t, b_hh, ys, cs,
                         dys, dcs)
    t_steps, batch, g = xp.shape
    hidden = g // 4
    b = b_hh.reshape(g)
    zeros = xp.new_zeros((batch, hidden))
    dh_carry, dc_carry = zeros, zeros
    dw = xp.new_zeros((hidden, g))
    db = xp.new_zeros((g,))
    dxp = [None] * t_steps
    for t in reversed(range(t_steps)):
        h_prev = ys[t - 1] if t > 0 else zeros
        c_prev = cs[t - 1] if t > 0 else zeros
        i, f, gg, o = _lstm_gates(xp[t] + torch.matmul(h_prev, w_hh_t) + b,
                                  hidden)
        tanh_c = torch.tanh(cs[t])
        dh = dys[t] + dh_carry
        dc = dh * o * (1.0 - tanh_c * tanh_c) + dc_carry + dcs[t]
        dgates = torch.cat([dc * gg * i * (1.0 - i),
                            dc * c_prev * f * (1.0 - f),
                            dc * i * (1.0 - gg * gg),
                            dh * tanh_c * o * (1.0 - o)], dim=1)
        dxp[t] = dgates
        dh_carry = torch.matmul(dgates, w_hh_t.t())
        dc_carry = dc * f
        dw = dw + torch.matmul(h_prev.t(), dgates)
        db = db + dgates.sum(dim=0)
    dxp = torch.stack(dxp) if t_steps else xp.new_zeros(xp.shape)
    return dxp, dw, db.reshape(1, g)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


#: the step route's tiles (cells, rows) that ``csrc/lstm_fwd.cu`` compiles
LSTM_FWD_TILES = ((4, 8), (4, 16), (4, 24), (4, 32), (32, 16), (32, 64))


def _fwd_plan(name: str, batch: int, hidden: int, route: str,
              wide_rows: bool) -> dict:
    """The forward step routes' plan: 4-cell slabs and the rows in at most
    32-row tiles padded to a multiple of 8; with ``wide_rows``, above 64
    rows 32-cell slabs and 16-row (up to 128 rows) or 64-row tiles."""
    if route == "auto":
        route = "sequence" if hidden % 4 else "step"
    if route == "sequence":
        return {"route": route, "cells": 0, "rows": 0, "slabs": 1,
                "row_tiles": batch}
    if route != "step" or hidden % 4:
        raise ValueError(f"{name}: no route {route!r} for H={hidden}")
    if batch <= 64 or not wide_rows:
        cells, rows = 4, 8 * _cdiv(_cdiv(batch, _cdiv(batch, 32)), 8)
    else:
        cells, rows = 32, 16 if batch <= 128 else 64
    return {"route": route, "cells": cells, "rows": rows,
            "slabs": _cdiv(hidden, cells), "row_tiles": _cdiv(batch, rows)}


#: the GRU forward's step tiles (cells, rows), which ``csrc/gru_fwd.cu``
#: compiles: the LSTM forward's.  Its plan takes the 4-cell ones; above 64
#: rows ``chip_smoke.py`` times the 32-cell ones beside them.
GRU_FWD_TILES = LSTM_FWD_TILES


def gru_fwd_plan(batch: int, hidden: int, route: str = "auto") -> dict:
    """How ``csrc/gru_fwd.cu`` runs one call: ``route`` "sequence" (one
    launch, one block per row walking all T steps, the first design) or
    "step" (one launch a step, ``slabs`` = ceil(H / ``cells``) x
    ``row_tiles`` = ceil(B / ``rows``) blocks, a tile of
    :data:`GRU_FWD_TILES`).

    "auto" takes "step" wherever H is a multiple of 4 (its 16-byte
    copies), else "sequence".  The step tiles are 4-cell slabs (64 at the
    audio model's H = 256) and the rows in at most 32-row tiles padded to
    a multiple of 8, at every B: above 64 rows they beat the LSTM
    forward's 32-cell tiles, which leave only 8 slabs at H = 256 (on an
    H100 at (T, B) = (3, 100) and (3, 200), ``chip_smoke.py``'s GRU turns,
    PERF.md section 6)."""
    return _fwd_plan("gru_fwd_plan", batch, hidden, route, wide_rows=False)


def lstm_fwd_plan(batch: int, hidden: int, route: str = "auto") -> dict:
    """How ``csrc/lstm_fwd.cu`` runs one call: ``route`` "sequence" (one
    launch, one block per row walking all T steps) or "step" (one launch a
    step, ``slabs`` = ceil(H / ``cells``) x ``row_tiles`` = ceil(B /
    ``rows``) blocks, a tile of :data:`LSTM_FWD_TILES`).

    "auto" takes "step" wherever H is a multiple of 4 (its 16-byte
    copies), else "sequence": measured on an H100, the two routes' calls
    taken in turns (``chip_smoke.py``, ``PERF.md`` section 6), the
    step route was the faster at every shape of a main path, so there is
    no crossover to set: 0.04-0.09 against 0.06-0.10 ms at the text
    model's training and eval shapes (T, B, H) = (3, 2..24, 128), 0.70-1.32
    against 2.83-2.96 ms at (256, 16, 128), 0.12-0.27 against 2.86-3.04
    ms at the stand-in's (16, 8, 512), in four runs (only at a ragged
    (7, 3, 100) the one-launch kernel was ahead, in two of them, by up to
    0.016 ms).  One launch does not make up for each block re-reading all
    of W_hh every step.

    Step tiles: up to 64 rows, 4-cell slabs (128 blocks at H = 512) and the
    rows in at most 32-row tiles padded to a multiple of 8; up to 128 rows,
    32 x 16 tiles (112 blocks at B = 112); above, 32 x 64 tiles (128 blocks
    at B = 488, where the flops bound the step)."""
    return _fwd_plan("lstm_fwd_plan", batch, hidden, route, wide_rows=True)


#: the backward step route's tiles (cells, rows) that ``csrc/gru_bwd.cu``
#: and ``csrc/lstm_bwd.cu`` compile
BWD_TILES = tuple((c, r) for c in (1, 2, 4) for r in (8, 16, 32))


def _bwd_plan(name: str, batch: int, hidden: int, route: str,
              steps: int) -> dict:
    if route == "auto":
        route = "sequence" if hidden % 4 else "step"
    if route == "sequence":
        return {"route": route, "cells": 0, "rows": 0, "slabs": 1,
                "row_tiles": batch, "splits": 1}
    if route != "step" or hidden % 4:
        raise ValueError(f"{name}: no route {route!r} for H={hidden}")
    cells = 1 if hidden <= 64 else 2 if hidden <= 128 else 4
    rows = 8 if batch <= 8 else 16 if batch <= 16 else 32
    # the weight product's T*B rows in parts of about 256 (a multiple of
    # the kernel's 32-row tiles), at most 64 parts
    k = steps * batch
    chunk = 32 * _cdiv(_cdiv(k, min(64, _cdiv(k, 256))), 32)
    return {"route": route, "cells": cells, "rows": rows,
            "slabs": _cdiv(hidden, cells), "row_tiles": _cdiv(batch, rows),
            "splits": _cdiv(k, chunk)}


def gru_bwd_plan(batch: int, hidden: int, route: str = "auto", *,
                 steps: int) -> dict:
    """How ``csrc/gru_bwd.cu`` runs one call of ``steps`` steps: ``route``
    "sequence" (two launches, one block per row walking all T steps) or
    "step" (T + 2 launches: the gate recompute, one launch a step of
    ``slabs`` = ceil(H / ``cells``) x ``row_tiles`` = ceil(B / ``rows``)
    blocks, a tile of :data:`BWD_TILES`, and the weight product over the
    T*B rows in ``splits`` parts, plus one launch adding them when there is
    more than one).

    "auto" takes "step" wherever H is a multiple of 4 (its 16-byte
    copies), else "sequence": measured on an H100 (``chip_smoke.py``,
    both routes' calls taken in turns, ``PERF.md`` section 6), the
    step route was the faster at every ``BWD_SHAPES`` / ``LSTM_SHAPES``
    shape, the training shapes at T = 3 included (0.12-0.18 against
    0.32-0.43 ms for the GRU at (3, 2..8, 256)), so there is no crossover
    to set; at (256, 16, 256) 1.74 against 18.71 ms.

    Step tiles: slabs of 1 cell up to H = 64, 2 up to 128, else 4 (64
    slabs at the text model's H = 128 and the audio model's 256):
    ``rnn_bwd_tiles.py`` timed the three widths in turns, and at (256,
    16) the 64-slab grid was the fastest (LSTM 0.98 ms against 1.15 with
    1-cell slabs and 1.05 with 4; GRU 1.45 against 2.81 and 1.51): every
    block reads all of dG[t+1] for its rows, so fewer, wider blocks move
    less through L2.  The rows in one tile of 8, 16 or 32 up to B = 32,
    above in 32-row tiles."""
    return _bwd_plan("gru_bwd_plan", batch, hidden, route, steps)


def lstm_bwd_plan(batch: int, hidden: int, route: str = "auto", *,
                  steps: int) -> dict:
    """How ``csrc/lstm_bwd.cu`` runs one call of ``steps`` steps: the
    routes and tiles of :func:`gru_bwd_plan`, measured the same way.

    "auto" takes "step" wherever H is a multiple of 4, else "sequence":
    the step route was the faster at every ``LSTM_SHAPES`` shape on an
    H100 (0.12-0.15 against 0.20-0.22 ms at (3, 2..4, 128); 1.30 against
    4.60 ms at (256, 16, 128); ``PERF.md`` section 6)."""
    return _bwd_plan("lstm_bwd_plan", batch, hidden, route, steps)


def _aligned(plan: dict, *tensors):
    """``tensors``, each copied where the step route's 16-byte loads would
    find it off a 16-byte boundary (a view into another tensor)."""
    if plan["route"] != "step":
        return tensors
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors)


def _bwd_scratch(plan: dict, xp: torch.Tensor, hidden: int) -> list:
    """The step route's scratch (None where unused): the gate sums of
    every step [T, B, G], a carry between steps [B, H], and the weight
    product's parts [splits, H + 1, G], each per fold."""
    if plan["route"] != "step":
        return [None] * 3
    new = functools.partial(torch.empty, dtype=torch.float32,
                            device=xp.device)
    lead, (t_steps, batch, g) = tuple(xp.shape[:-3]), xp.shape[-3:]
    return [new(lead + (t_steps, batch, g)), new(lead + (batch, hidden)),
            new(lead + (plan["splits"], hidden + 1, g))
            if plan["splits"] > 1 else None]


def _ptrs(tensors) -> list:
    return [0 if t is None else t.data_ptr() for t in tensors]


def lstm_sequence(xp: torch.Tensor, w_hh_t: torch.Tensor,
                  b_hh: torch.Tensor, plan: dict | None = None):
    """xp [T, B, 4H], w_hh_t [H, 4H], b_hh [1, 4H] (or [4H]) -> (ys, cs),
    each [T, B, H], or the same with a leading fold axis ``F`` on each.  ``plan``: a :func:`lstm_fwd_plan` for the kernel, by
    default the one it picks for (B, H).  As :func:`gru_sequence`, a CUDA
    input that requires grad raises: gradients go through
    :class:`LSTMSequence`."""
    if xp.device.type == "cpu":
        return lstm_sequence_torch(xp, w_hh_t, b_hh)
    if xp.device.type != "cuda":
        raise ValueError(f"lstm_sequence: unsupported device {xp.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xp, w_hh_t, b_hh)):
        raise ValueError("lstm_sequence: inputs require grad; call "
                         "LSTMSequence.apply for a differentiable result")
    lead, t_steps, batch, hidden = _dims(xp, 4)
    g = 4 * hidden
    _check({"xp": xp, "w_hh_t": w_hh_t, "b_hh": b_hh},
           {"xp": [lead + (t_steps, batch, g)], "w_hh_t": [lead + (hidden, g)],
            "b_hh": [lead + (1, g), lead + (g,)]})
    ys = torch.empty(lead + (t_steps, batch, hidden), dtype=torch.float32,
                     device=xp.device)
    cs = torch.empty_like(ys)
    if ys.numel() == 0:
        return ys, cs
    if plan is None:
        plan = lstm_fwd_plan(batch, hidden)
    fn = _kernel("lstm_fwd")
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xp.data_ptr(), w_hh_t.data_ptr(), b_hh.data_ptr(),
                 ys.data_ptr(), cs.data_ptr(), t_steps, batch, hidden,
                 _folds(lead), plan["cells"], plan["rows"], stream)
    if err != 0:
        raise RuntimeError(f"lstm_seq_fwd_f32 launch failed: cudaError {err}")
    global LSTM_LAUNCHES
    LSTM_LAUNCHES += 1
    return ys, cs


def lstm_sequence_bwd(xp: torch.Tensor, w_hh_t: torch.Tensor,
                      b_hh: torch.Tensor, ys: torch.Tensor, cs: torch.Tensor,
                      dys: torch.Tensor, dcs: torch.Tensor,
                      plan: dict | None = None):
    """The LSTM backward kernel's wrapper: (dxp [T, B, 4H], dw_hh_t [H, 4H],
    db_hh [1, 4H]) of ``(ys, cs) = lstm_sequence(xp, w_hh_t, b_hh)`` given
    ``dys``, ``dcs [T, B, H]``, each with a leading ``F`` for a fold axis.  ``plan``: a :func:`lstm_bwd_plan` for the
    kernel, by default the one it picks for (T, B, H); a CPU call ignores
    it."""
    if xp.device.type == "cpu":
        return lstm_sequence_bwd_torch(xp, w_hh_t, b_hh, ys, cs, dys, dcs)
    if xp.device.type != "cuda":
        raise ValueError(f"lstm_sequence_bwd: unsupported device {xp.device}")
    lead, t_steps, batch, hidden = _dims(xp, 4)
    g = 4 * hidden
    states = [lead + (t_steps, batch, hidden)]
    _check({"xp": xp, "w_hh_t": w_hh_t, "b_hh": b_hh, "ys": ys, "cs": cs,
            "dys": dys, "dcs": dcs},
           {"xp": [lead + (t_steps, batch, g)], "w_hh_t": [lead + (hidden, g)],
            "b_hh": [lead + (1, g), lead + (g,)], "ys": states, "cs": states,
            "dys": states, "dcs": states})
    dxp = torch.empty_like(xp)
    dw = torch.empty(lead + (hidden, g), dtype=torch.float32,
                     device=xp.device)
    db = torch.empty(lead + (1, g), dtype=torch.float32, device=xp.device)
    if xp.numel() == 0:
        return dxp, dw.zero_(), db.zero_()
    if plan is None:
        plan = lstm_bwd_plan(batch, hidden, steps=t_steps)
    xp, w_hh_t, b_hh, ys, cs, dys, dcs = _aligned(
        plan, xp, w_hh_t, b_hh, ys, cs, dys, dcs)
    scratch = _bwd_scratch(plan, xp, hidden)    # gp, dc carry, parts
    fn = _kernel("lstm_bwd")
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xp.data_ptr(), w_hh_t.data_ptr(), b_hh.data_ptr(),
                 ys.data_ptr(), cs.data_ptr(), dys.data_ptr(),
                 dcs.data_ptr(), dxp.data_ptr(), dw.data_ptr(),
                 db.data_ptr(), *_ptrs(scratch), t_steps, batch, hidden,
                 _folds(lead), plan["cells"], plan["rows"], plan["splits"],
                 stream)
    if err != 0:
        raise RuntimeError(f"lstm_seq_bwd_f32 launch failed: cudaError {err}")
    global LSTM_BWD_LAUNCHES, LSTM_BWD_STREAMED_LAUNCHES
    if streamed(t_steps, batch, hidden, 4):
        LSTM_BWD_STREAMED_LAUNCHES += 1
    else:
        LSTM_BWD_LAUNCHES += 1
    return dxp, dw, db


class LSTMSequence(torch.autograd.Function):
    """``(ys, cs) = LSTM(xp, w_hh_t, b_hh)`` with the kernels' backward
    (``jax.custom_vjp`` of ``rnn_pallas.lstm_sequence`` on this side).
    Autograd hands zeros for an output nobody used (``cs`` when ``c_n`` is
    not read), so ``dcs`` always reaches the backward, and a used ``c_n``
    gets its exact gradient.  ``plain`` as in :class:`GRUSequence`."""

    @staticmethod
    def forward(ctx, xp, w_hh_t, b_hh, plain: bool = False):
        fwd = lstm_sequence_torch if plain else lstm_sequence
        ys, cs = fwd(xp, w_hh_t, b_hh)
        ctx.save_for_backward(xp, w_hh_t, b_hh, ys, cs)
        ctx.plain = plain
        return ys, cs

    @staticmethod
    def backward(ctx, dys, dcs):
        xp, w_hh_t, b_hh, ys, cs = ctx.saved_tensors
        # views through lstm_layer's transpose and slices: make them dense
        bwd = lstm_sequence_bwd_torch if ctx.plain else lstm_sequence_bwd
        dxp, dw, db = bwd(xp, w_hh_t, b_hh, ys, cs, dys.contiguous(),
                          dcs.contiguous())
        return dxp, dw, db.reshape(b_hh.shape), None


def _clip(x: torch.Tensor, clip: float) -> torch.Tensor:
    return x.clamp(-clip, clip) if clip else x


def _clip_mask(x: torch.Tensor, clip: float) -> torch.Tensor:
    """1 where the clip passes the gradient (inclusive bounds, as
    ``rnn_pallas.py:630-632``), everywhere when ``clip`` is 0."""
    if not clip:
        return torch.ones_like(x)
    return ((x >= -clip) & (x <= clip)).to(x.dtype)


def _lstmp_gates(gp: torch.Tensor):
    """gp [B, 4, C] -> i, f, g, o, each [B, C]."""
    return (torch.sigmoid(gp[:, 0]), torch.sigmoid(gp[:, 1]),
            torch.tanh(gp[:, 2]), torch.sigmoid(gp[:, 3]))


def lstmp_sequence_torch(xp4: torch.Tensor, w_h_t3: torch.Tensor,
                         b3: torch.Tensor, w_p_t: torch.Tensor,
                         cell_clip: float = 3.0, proj_clip: float = 3.0):
    """Plain PyTorch LSTMP recurrence, the forward kernel's reference
    (``rnn_pallas._lstmp_stream_fwd_kernel``).  Returns (ys, hpre [T, B, P],
    cpre, hf [T, B, C]): the clipped projected states, the projections
    before the clip, the cell states before the clip and
    ``o * tanh(clip(c))``."""
    t_steps, batch, _, c_dim = xp4.shape
    p_dim = w_h_t3.shape[0]
    w_h = w_h_t3.reshape(p_dim, 4 * c_dim)
    b = b3.reshape(4 * c_dim)
    h = xp4.new_zeros((batch, p_dim))
    c = xp4.new_zeros((batch, c_dim))
    outs = ([], [], [], [])
    for t in range(t_steps):
        gp = xp4[t].reshape(batch, 4 * c_dim) + torch.matmul(h, w_h) + b
        i, f, g, o = _lstmp_gates(gp.reshape(batch, 4, c_dim))
        c_pre = f * c + i * g
        c = _clip(c_pre, cell_clip)
        hf = o * torch.tanh(c)
        hp = torch.matmul(hf, w_p_t)
        h = _clip(hp, proj_clip)
        for acc, v in zip(outs, (h, hp, c_pre, hf)):
            acc.append(v)
    if not t_steps:
        return (xp4.new_zeros((0, batch, p_dim)),
                xp4.new_zeros((0, batch, p_dim)),
                xp4.new_zeros((0, batch, c_dim)),
                xp4.new_zeros((0, batch, c_dim)))
    return tuple(torch.stack(v) for v in outs)


def lstmp_sequence_bwd_torch(xp4: torch.Tensor, w_h_t3: torch.Tensor,
                             b3: torch.Tensor, w_p_t: torch.Tensor,
                             ys: torch.Tensor, hpre: torch.Tensor,
                             cpre: torch.Tensor, dys: torch.Tensor,
                             dcpre: torch.Tensor, cell_clip: float = 3.0,
                             proj_clip: float = 3.0):
    """Plain PyTorch LSTMP backward, the backward kernel's reference: the
    reverse walk of ``rnn_pallas._lstmp_stream_bwd_kernel`` through both
    clips, the gates recomputed from ``ys[t-1]`` and ``clip(cpre[t-1])``.
    Returns (dgates [T, B, 4, C], dhpre [T, B, P])."""
    t_steps, batch, _, c_dim = xp4.shape
    p_dim = w_h_t3.shape[0]
    w_h = w_h_t3.reshape(p_dim, 4 * c_dim)
    b = b3.reshape(4 * c_dim)
    dh_carry = xp4.new_zeros((batch, p_dim))
    dc_carry = xp4.new_zeros((batch, c_dim))
    zeros_c = xp4.new_zeros((batch, c_dim))
    dgates = [None] * t_steps
    dhpre = [None] * t_steps
    for t in reversed(range(t_steps)):
        dhp = (dys[t] + dh_carry) * _clip_mask(hpre[t], proj_clip)
        dhpre[t] = dhp
        d_hf = torch.matmul(dhp, w_p_t.t())
        h_prev = ys[t - 1] if t > 0 else xp4.new_zeros((batch, p_dim))
        c_prev = _clip(cpre[t - 1], cell_clip) if t > 0 else zeros_c
        gp = xp4[t].reshape(batch, 4 * c_dim) + torch.matmul(h_prev, w_h) + b
        i, f, g, o = _lstmp_gates(gp.reshape(batch, 4, c_dim))
        tanh_c = torch.tanh(_clip(cpre[t], cell_clip))
        ds_o = d_hf * tanh_c * o * (1.0 - o)
        dc = ((d_hf * o * (1.0 - tanh_c * tanh_c) + dc_carry)
              * _clip_mask(cpre[t], cell_clip) + dcpre[t])
        dg = torch.stack([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                          dc * i * (1.0 - g * g), ds_o], dim=1)
        dgates[t] = dg
        dh_carry = torch.matmul(dg.reshape(batch, 4 * c_dim), w_h.t())
        dc_carry = dc * f
    if not t_steps:
        return xp4.new_zeros(xp4.shape), xp4.new_zeros((0, batch, p_dim))
    return torch.stack(dgates), torch.stack(dhpre)


def lstmp_weight_grads(dgates: torch.Tensor, dhpre: torch.Tensor,
                       ys: torch.Tensor, hf: torch.Tensor):
    """(dw_h_t3 [P, 4, C], db3 [1, 4, C], dw_p_t [C, P]) from the kernel's
    cotangents: three products over the T*B rows, outside the kernel as in
    ``rnn_pallas._lstmp_stream_bwd_rule`` (``:793-800``)."""
    ys_prev = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])
    dw_h_t3 = torch.einsum("tbgc,tbp->pgc", dgates, ys_prev)
    db3 = dgates.sum(dim=(0, 1)).unsqueeze(0)
    dw_p_t = torch.einsum("tbp,tbc->cp", dhpre, hf)
    return dw_h_t3, db3, dw_p_t


def _lstmp_dims(xp4: torch.Tensor, w_h_t3: torch.Tensor):
    if xp4.dim() != 4 or xp4.shape[2] != 4 or w_h_t3.dim() != 3:
        raise ValueError(f"xp4 must be [T, B, 4, C] and w_h_t3 [P, 4, C], "
                         f"got {tuple(xp4.shape)}, {tuple(w_h_t3.shape)}")
    t_steps, batch, _, c_dim = xp4.shape
    return t_steps, batch, c_dim, w_h_t3.shape[0]


def lstmp_fwd_plan(batch: int, c_dim: int, p_dim: int) -> dict:
    """How ``csrc/lstmp_fwd.cu`` splits one step: ``cells`` per slab and
    ``rows`` per tile (one of the tiles its C entry compiles), ``slabs`` =
    ceil(C / cells) x ``row_tiles`` = ceil(B / rows) blocks, and the shape
    of the partial-projection scratch, ``[slabs, B, P]``.

    Up to 64 rows the slabs are 32 cells wide (128 blocks at C = 4096) and
    the rows are split into at most 32-row tiles padded to a multiple of 8;
    above, 64 x 64 tiles (128 blocks at B = 128, where the flops bound
    the step).  The scratch is B / cells times ``w_p_t``'s size: at most
    twice it for B <= 128."""
    if batch > 64:
        cells, rows = 64, 64
    else:
        cells, rows = 32, 8 * _cdiv(_cdiv(batch, _cdiv(batch, 32)), 8)
    slabs = _cdiv(c_dim, cells)
    return {"cells": cells, "rows": rows, "slabs": slabs,
            "row_tiles": _cdiv(batch, rows), "scratch": (slabs, batch, p_dim)}


#: the backward step route's tiles (cells, rows) that ``csrc/lstmp_bwd.cu``
#: compiles
LSTMP_BWD_TILES = ((32, 8), (32, 16), (32, 24), (32, 32), (32, 64))


def lstmp_bwd_plan(batch: int, c_dim: int, p_dim: int,
                   route: str = "auto") -> dict:
    """How ``csrc/lstmp_bwd.cu`` runs one call: 2 T + 1 launches, every
    step's gate sums in one product before the walk, then one launch a step
    of ``slabs`` = ceil(C / ``cells``) x ``row_tiles`` = ceil(B / ``rows``)
    blocks, a tile of :data:`LSTMP_BWD_TILES`, each followed by a
    fixed-order reduction of the partial carries, whose scratch is
    ``scratch`` = ``[slabs, B, P]``.  ``route`` "auto" is "step", the
    only route; any other raises.

    The kernels take C and P only in multiples of 4 (16-byte copies), as
    the forward does: any other raises.  Tiles: 32-cell slabs (128 at the
    zhs C = 4096), one cell a lane; up to 64 rows, the forward's rule (at
    most 32-row tiles padded to a multiple of 8: one tile at one to three
    served speakers); above, 64-row tiles (each row tile streams the
    weights again: at (T, B) = (32, 128) 8.40 ms against 9.29 with 32-row
    tiles on an H100, ``rnn_bwd_tiles.py``)."""
    if route not in ("auto", "step") or c_dim % 4 or p_dim % 4:
        raise ValueError(f"lstmp_bwd_plan: no route {route!r} for "
                         f"C={c_dim}, P={p_dim} (the kernel takes C and P in "
                         f"multiples of 4: 16-byte copies)")
    if batch <= 64:
        rows = 8 * _cdiv(_cdiv(batch, _cdiv(batch, 32)), 8)
    else:
        rows = 64
    cells = 32
    slabs = _cdiv(c_dim, cells)
    return {"route": "step", "cells": cells, "rows": rows, "slabs": slabs,
            "row_tiles": _cdiv(batch, rows), "scratch": (slabs, batch, p_dim)}


def _lstmp_bwd_scratch(plan: dict, batch: int, c_dim: int,
                       device) -> torch.Tensor:
    """All the backward's scratch in one allocation, as the C entry cuts
    it: the carry [B, C], then the partial carries ``plan["scratch"]``."""
    n = batch * c_dim + math.prod(plan["scratch"])
    return torch.empty((n,), dtype=torch.float32, device=device)


def lstmp_sequence(xp4: torch.Tensor, w_h_t3: torch.Tensor,
                   b3: torch.Tensor, w_p_t: torch.Tensor,
                   cell_clip: float = 3.0, proj_clip: float = 3.0):
    """xp4 [T, B, 4, C], w_h_t3 [P, 4, C], b3 [1, 4, C] (or [4, C]),
    w_p_t [C, P] -> (ys, hpre [T, B, P], cpre, hf [T, B, C]).  As
    :func:`gru_sequence`, a CUDA input that requires grad raises: gradients
    go through :class:`LSTMPSequence`."""
    if xp4.device.type == "cpu":
        return lstmp_sequence_torch(xp4, w_h_t3, b3, w_p_t, cell_clip,
                                    proj_clip)
    if xp4.device.type != "cuda":
        raise ValueError(f"lstmp_sequence: unsupported device {xp4.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xp4, w_h_t3, b3, w_p_t)):
        raise ValueError("lstmp_sequence: inputs require grad; call "
                         "LSTMPSequence.apply for a differentiable result")
    t_steps, batch, c_dim, p_dim = _lstmp_dims(xp4, w_h_t3)
    _check({"xp4": xp4, "w_h_t3": w_h_t3, "b3": b3, "w_p_t": w_p_t},
           {"xp4": [(t_steps, batch, 4, c_dim)], "w_h_t3": [(p_dim, 4, c_dim)],
            "b3": [(1, 4, c_dim), (4, c_dim)], "w_p_t": [(c_dim, p_dim)]})
    if c_dim % 4 or p_dim % 4:
        raise ValueError(f"lstmp_sequence: the kernel takes C and P in "
                         f"multiples of 4 (16-byte copies), got C={c_dim}, "
                         f"P={p_dim}")
    new = functools.partial(torch.empty, dtype=torch.float32,
                            device=xp4.device)
    ys, hpre = new((t_steps, batch, p_dim)), new((t_steps, batch, p_dim))
    cpre, hf = new((t_steps, batch, c_dim)), new((t_steps, batch, c_dim))
    if ys.numel() == 0 or cpre.numel() == 0:
        return ys.zero_(), hpre.zero_(), cpre.zero_(), hf.zero_()
    plan = lstmp_fwd_plan(batch, c_dim, p_dim)
    part = new(plan["scratch"])
    fn = _kernel("lstmp_fwd")
    with torch.cuda.device(xp4.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xp4.data_ptr(), w_h_t3.data_ptr(), b3.data_ptr(),
                 w_p_t.data_ptr(), ys.data_ptr(), hpre.data_ptr(),
                 cpre.data_ptr(), hf.data_ptr(), part.data_ptr(), t_steps,
                 batch, c_dim, p_dim, plan["cells"], plan["rows"],
                 float(cell_clip), float(proj_clip), stream)
    if err != 0:
        raise RuntimeError(f"lstmp_seq_fwd_f32 launch failed: cudaError {err}")
    global LSTMP_LAUNCHES
    LSTMP_LAUNCHES += 1
    return ys, hpre, cpre, hf


def lstmp_sequence_bwd(xp4: torch.Tensor, w_h_t3: torch.Tensor,
                       b3: torch.Tensor, w_p_t: torch.Tensor,
                       ys: torch.Tensor, hpre: torch.Tensor,
                       cpre: torch.Tensor, dys: torch.Tensor,
                       dcpre: torch.Tensor, cell_clip: float = 3.0,
                       proj_clip: float = 3.0, plan: dict | None = None):
    """The LSTMP backward kernel's wrapper: (dgates [T, B, 4, C], dhpre
    [T, B, P]) of ``lstmp_sequence(xp4, w_h_t3, b3, w_p_t)`` given its
    residuals and the cotangents ``dys [T, B, P]``, ``dcpre [T, B, C]``.
    ``plan``: a :func:`lstmp_bwd_plan` for the kernel, by default the one
    it picks for (B, C, P); a CPU call ignores it."""
    if xp4.device.type == "cpu":
        return lstmp_sequence_bwd_torch(xp4, w_h_t3, b3, w_p_t, ys, hpre,
                                        cpre, dys, dcpre, cell_clip,
                                        proj_clip)
    if xp4.device.type != "cuda":
        raise ValueError(f"lstmp_sequence_bwd: unsupported device "
                         f"{xp4.device}")
    t_steps, batch, c_dim, p_dim = _lstmp_dims(xp4, w_h_t3)
    proj, cells = [(t_steps, batch, p_dim)], [(t_steps, batch, c_dim)]
    _check({"xp4": xp4, "w_h_t3": w_h_t3, "b3": b3, "w_p_t": w_p_t,
            "ys": ys, "hpre": hpre, "cpre": cpre, "dys": dys,
            "dcpre": dcpre},
           {"xp4": [(t_steps, batch, 4, c_dim)], "w_h_t3": [(p_dim, 4, c_dim)],
            "b3": [(1, 4, c_dim), (4, c_dim)], "w_p_t": [(c_dim, p_dim)],
            "ys": proj, "hpre": proj, "cpre": cells, "dys": proj,
            "dcpre": cells})
    new = functools.partial(torch.empty, dtype=torch.float32,
                            device=xp4.device)
    dgates = new(xp4.shape)
    dhpre = new((t_steps, batch, p_dim))
    if dgates.numel() == 0 or dhpre.numel() == 0:
        return dgates.zero_(), dhpre.zero_()
    if plan is None:
        plan = lstmp_bwd_plan(batch, c_dim, p_dim)
    xp4, w_h_t3, b3, w_p_t, ys, hpre, cpre, dys, dcpre = _aligned(
        plan, xp4, w_h_t3, b3, w_p_t, ys, hpre, cpre, dys, dcpre)
    scratch = _lstmp_bwd_scratch(plan, batch, c_dim, xp4.device)
    fn = _kernel("lstmp_bwd")
    with torch.cuda.device(xp4.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xp4.data_ptr(), w_h_t3.data_ptr(), b3.data_ptr(),
                 w_p_t.data_ptr(), ys.data_ptr(), hpre.data_ptr(),
                 cpre.data_ptr(), dys.data_ptr(), dcpre.data_ptr(),
                 dgates.data_ptr(), dhpre.data_ptr(), scratch.data_ptr(),
                 t_steps, batch, c_dim, p_dim, plan["cells"], plan["rows"],
                 float(cell_clip), float(proj_clip), stream)
    if err != 0:
        raise RuntimeError(f"lstmp_seq_bwd_f32 launch failed: cudaError {err}")
    global LSTMP_BWD_LAUNCHES
    LSTMP_BWD_LAUNCHES += 1
    return dgates, dhpre


class LSTMPSequence(torch.autograd.Function):
    """``(ys, cs_pre) = LSTMP(xp4, w_h_t3, b3, w_p_t)`` with the kernels'
    backward (``jax.custom_vjp`` of ``rnn_pallas.lstmp_sequence_streamed``
    on this side): ``ys [T, B, P]`` are the clipped projected states,
    ``cs_pre [T, B, C]`` the cell states before the clip
    (``clip(cs_pre[-1])`` is the final cell state).  The backward's kernel
    gives (dgates, dhpre); the weight gradients are
    :func:`lstmp_weight_grads`.  ``plain`` as in :class:`GRUSequence`."""

    @staticmethod
    def forward(ctx, xp4, w_h_t3, b3, w_p_t, cell_clip: float = 3.0,
                proj_clip: float = 3.0, plain: bool = False):
        fwd = lstmp_sequence_torch if plain else lstmp_sequence
        ys, hpre, cpre, hf = fwd(xp4, w_h_t3, b3, w_p_t, cell_clip,
                                 proj_clip)
        ctx.save_for_backward(xp4, w_h_t3, b3, w_p_t, ys, hpre, cpre, hf)
        ctx.clips = (cell_clip, proj_clip)
        ctx.plain = plain
        return ys, cpre

    @staticmethod
    def backward(ctx, dys, dcpre):
        xp4, w_h_t3, b3, w_p_t, ys, hpre, cpre, hf = ctx.saved_tensors
        bwd = lstmp_sequence_bwd_torch if ctx.plain else lstmp_sequence_bwd
        dgates, dhpre = bwd(xp4, w_h_t3, b3, w_p_t, ys, hpre, cpre,
                            dys.contiguous(), dcpre.contiguous(), *ctx.clips)
        dw_h_t3, db3, dw_p_t = lstmp_weight_grads(dgates, dhpre, ys, hf)
        return (dgates, dw_h_t3, db3.reshape(b3.shape), dw_p_t, None, None,
                None)
