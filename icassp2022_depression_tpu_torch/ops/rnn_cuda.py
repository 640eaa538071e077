"""The GRU recurrence and its backward as hand-written CUDA kernels
(counterpart of :mod:`icassp2022_depression_tpu.ops.rnn_pallas`, GRU half).

:func:`gru_sequence` keeps the JAX function's contract:
``xp [T, B, 3H]`` (input projections), ``w_hh_t [H, 3H]``,
``b_hh [1, 3H]`` -> every hidden state ``ys [T, B, H]``, zero initial
state, torch gate order r, z, n.  :func:`gru_sequence_bwd` is the custom
VJP of the JAX package (``_bwd_rule``): ``(xp, w_hh_t, b_hh, ys, dys) ->
(dxp, dw_hh_t, db_hh)``.  :class:`GRUSequence` ties the two together for
autograd.

* On CUDA tensors the wrappers launch ``gru_seq_fwd_f32``
  (``csrc/gru_fwd.cu``) and ``gru_seq_bwd_f32`` (``csrc/gru_bwd.cu``),
  built with ``nvcc`` at first use (see :mod:`.._build`), on the current
  stream, and add one to :data:`LAUNCHES` / :data:`BWD_LAUNCHES`.  They
  never fall back to the plain versions: a build or launch failure raises.
* On CPU tensors they run the plain versions, :func:`gru_sequence_torch`
  and :func:`gru_sequence_bwd_torch`, which are the kernels' oracles.

Importing this module needs no ``nvcc``.
"""

from __future__ import annotations

import ctypes

import torch

from icassp2022_depression_tpu_torch import _build

#: forward kernel launches made by :func:`gru_sequence` in this process
LAUNCHES = 0
#: backward kernel launches made by :func:`gru_sequence_bwd`
BWD_LAUNCHES = 0

#: each source's C entry: (symbol, pointer arguments before T, B, H and
#: the stream)
_ENTRIES = {"gru_fwd": ("gru_seq_fwd_f32", 4),
            "gru_bwd": ("gru_seq_bwd_f32", 9)}
_fns: dict = {}


def _kernel(name: str):
    """The C entry of ``csrc/<name>.cu``, built and bound at first use."""
    if name not in _fns:
        symbol, n_ptrs = _ENTRIES[name]
        fn = getattr(_build.load(name), symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _gates(x: torch.Tensor, hp: torch.Tensor, hidden: int):
    r = torch.sigmoid(x[:, :hidden] + hp[:, :hidden])
    z = torch.sigmoid(x[:, hidden:2 * hidden] + hp[:, hidden:2 * hidden])
    n = torch.tanh(x[:, 2 * hidden:] + r * hp[:, 2 * hidden:])
    return r, z, n


def gru_sequence_torch(xp: torch.Tensor, w_hh_t: torch.Tensor,
                       b_hh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch GRU recurrence, the forward kernel's reference."""
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
    from ``ys``.  Returns (dxp [T, B, 3H], dw_hh_t [H, 3H], db_hh [1, 3H])."""
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
    """Device, dtype, shape and contiguity checks before a launch."""
    device = tensors["xp"].device
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, xp on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) not in shapes[name]:
            raise ValueError(f"{name} must be one of {shapes[name]}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _dims(xp: torch.Tensor):
    if xp.dim() != 3 or xp.shape[-1] % 3:
        raise ValueError(f"xp must be [T, B, 3H], got {tuple(xp.shape)}")
    t_steps, batch, g = xp.shape
    return t_steps, batch, g // 3


def gru_sequence(xp: torch.Tensor, w_hh_t: torch.Tensor,
                 b_hh: torch.Tensor) -> torch.Tensor:
    """xp [T, B, 3H], w_hh_t [H, 3H], b_hh [1, 3H] (or [3H]) -> ys [T, B, H].
    The kernel's output carries no autograd graph, so a CUDA input that
    requires grad raises: gradients go through :class:`GRUSequence`."""
    if xp.device.type == "cpu":
        return gru_sequence_torch(xp, w_hh_t, b_hh)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_sequence: unsupported device {xp.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xp, w_hh_t, b_hh)):
        raise ValueError("gru_sequence: inputs require grad; call "
                         "GRUSequence.apply for a differentiable result")
    t_steps, batch, hidden = _dims(xp)
    g = 3 * hidden
    _check({"xp": xp, "w_hh_t": w_hh_t, "b_hh": b_hh},
           {"xp": [(t_steps, batch, g)], "w_hh_t": [(hidden, g)],
            "b_hh": [(1, g), (g,)]})
    ys = torch.empty((t_steps, batch, hidden), dtype=torch.float32,
                     device=xp.device)
    if ys.numel() == 0:
        return ys
    fn = _kernel("gru_fwd")
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xp.data_ptr(), w_hh_t.data_ptr(), b_hh.data_ptr(),
                 ys.data_ptr(), t_steps, batch, hidden, stream)
    if err != 0:
        raise RuntimeError(f"gru_seq_fwd_f32 launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return ys


def gru_sequence_bwd(xp: torch.Tensor, w_hh_t: torch.Tensor,
                     b_hh: torch.Tensor, ys: torch.Tensor,
                     dys: torch.Tensor):
    """The backward kernel's wrapper: (dxp [T, B, 3H], dw_hh_t [H, 3H],
    db_hh [1, 3H]) of ``ys = gru_sequence(xp, w_hh_t, b_hh)`` given
    ``dys [T, B, H]``."""
    if xp.device.type == "cpu":
        return gru_sequence_bwd_torch(xp, w_hh_t, b_hh, ys, dys)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_sequence_bwd: unsupported device {xp.device}")
    t_steps, batch, hidden = _dims(xp)
    g = 3 * hidden
    _check({"xp": xp, "w_hh_t": w_hh_t, "b_hh": b_hh, "ys": ys, "dys": dys},
           {"xp": [(t_steps, batch, g)], "w_hh_t": [(hidden, g)],
            "b_hh": [(1, g), (g,)], "ys": [(t_steps, batch, hidden)],
            "dys": [(t_steps, batch, hidden)]})
    dxp = torch.empty_like(xp)
    dw = torch.empty((hidden, g), dtype=torch.float32, device=xp.device)
    db = torch.empty((1, g), dtype=torch.float32, device=xp.device)
    if xp.numel() == 0:
        return dxp, dw.zero_(), db.zero_()
    dgates_h = torch.empty_like(xp)
    fn = _kernel("gru_bwd")
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xp.data_ptr(), w_hh_t.data_ptr(), b_hh.data_ptr(),
                 ys.data_ptr(), dys.data_ptr(), dxp.data_ptr(),
                 dgates_h.data_ptr(), dw.data_ptr(), db.data_ptr(),
                 t_steps, batch, hidden, stream)
    if err != 0:
        raise RuntimeError(f"gru_seq_bwd_f32 launch failed: cudaError {err}")
    global BWD_LAUNCHES
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
