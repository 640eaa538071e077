"""The GRU forward recurrence as a hand-written CUDA kernel (counterpart of
:mod:`icassp2022_depression_tpu.ops.rnn_pallas`, GRU forward only).

:func:`gru_sequence` keeps the JAX function's contract:
``xp [T, B, 3H]`` (input projections), ``w_hh_t [H, 3H]``,
``b_hh [1, 3H]`` -> every hidden state ``ys [T, B, H]``, zero initial
state, torch gate order r, z, n.

* On a CUDA tensor it launches ``gru_seq_fwd_f32`` from
  ``csrc/gru_fwd.cu`` (built with ``nvcc`` at first use, see
  :mod:`.._build`) on the current stream, and adds one to
  :data:`LAUNCHES`.  It never falls back to the plain version.
* On a CPU tensor it runs the plain version, :func:`gru_sequence_torch`.

The backward kernel (``rnn_pallas._gru_bwd_kernel``) is not ported yet, so
a CUDA input that requires grad raises instead of being silently
detached.  Importing this module needs no ``nvcc``.
"""

from __future__ import annotations

import ctypes

import torch

from icassp2022_depression_tpu_torch import _build

#: kernel launches made by :func:`gru_sequence` in this process
LAUNCHES = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("gru_fwd").gru_seq_fwd_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def gru_sequence_torch(xp: torch.Tensor, w_hh_t: torch.Tensor,
                       b_hh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch GRU recurrence, the kernel's reference."""
    t_steps, batch, g = xp.shape
    hidden = g // 3
    b_hh = b_hh.reshape(g)
    h = xp.new_zeros((batch, hidden))
    ys = []
    for t in range(t_steps):
        hp = torch.matmul(h, w_hh_t) + b_hh
        x = xp[t]
        r = torch.sigmoid(x[:, :hidden] + hp[:, :hidden])
        z = torch.sigmoid(x[:, hidden:2 * hidden] + hp[:, hidden:2 * hidden])
        n = torch.tanh(x[:, 2 * hidden:] + r * hp[:, 2 * hidden:])
        h = (1.0 - z) * n + z * h
        ys.append(h)
    if not ys:
        return xp.new_zeros((0, batch, hidden))
    return torch.stack(ys)


def gru_sequence(xp: torch.Tensor, w_hh_t: torch.Tensor,
                 b_hh: torch.Tensor) -> torch.Tensor:
    """xp [T, B, 3H], w_hh_t [H, 3H], b_hh [1, 3H] (or [3H]) -> ys [T, B, H]."""
    if xp.device.type == "cpu":
        return gru_sequence_torch(xp, w_hh_t, b_hh)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_sequence: unsupported device {xp.device}")
    tensors = {"xp": xp, "w_hh_t": w_hh_t, "b_hh": b_hh}
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in tensors.values()):
        raise NotImplementedError(
            "gru_sequence: the CUDA GRU backward kernel (port of "
            "rnn_pallas._gru_bwd_kernel) comes with the training slice; "
            "run the forward under torch.no_grad()/inference_mode()")
    if xp.dim() != 3 or xp.shape[-1] % 3:
        raise ValueError(f"xp must be [T, B, 3H], got {tuple(xp.shape)}")
    t_steps, batch, g = xp.shape
    hidden = g // 3
    if tuple(w_hh_t.shape) != (hidden, g):
        raise ValueError(f"w_hh_t must be [{hidden}, {g}], got "
                         f"{tuple(w_hh_t.shape)}")
    if b_hh.numel() != g or b_hh.dim() not in (1, 2) or b_hh.shape[-1] != g:
        raise ValueError(f"b_hh must be [1, {g}] or [{g}], got "
                         f"{tuple(b_hh.shape)}")
    for name, t in tensors.items():
        if t.device != xp.device:
            raise ValueError(f"{name} is on {t.device}, xp on {xp.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ys = torch.empty((t_steps, batch, hidden), dtype=torch.float32,
                     device=xp.device)
    if ys.numel() == 0:
        return ys
    fn = _kernel()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xp.data_ptr(), w_hh_t.data_ptr(), b_hh.data_ptr(),
                 ys.data_ptr(), t_steps, batch, hidden, stream)
    if err != 0:
        raise RuntimeError(f"gru_seq_fwd_f32 launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return ys
