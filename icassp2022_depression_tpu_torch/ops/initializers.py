"""Parameter initializers with the reference models' distributions (port
of :mod:`icassp2022_depression_tpu.ops.initializers`).

Every draw comes from a threefry key (:mod:`.prng`, ``[2]`` int64) split
in the JAX package's order, so the same key gives the JAX package's
numbers bit for bit:

* ``nn.Linear`` defaults: weight and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in));
* ``nn.GRU`` / ``nn.LSTM`` defaults: every tensor ~ U(-1/sqrt(H), 1/sqrt(H));
* the text model's ``xavier_uniform_`` weights with zero biases
  (``Classification/text_bilstm_whole.py:37-43``): U(-a, a) with
  a = sqrt(6 / (fan_in + fan_out)) over each whole weight matrix, the
  stacked ``[G*H, D]`` recurrent ones included.

A key of None draws nothing: the tensors are zeros, for a model whose
weights are loaded next (a checkpoint, a state dict).  The draws lie on
the key's device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from icassp2022_depression_tpu_torch.ops import prng


def uniform(key: Optional[torch.Tensor], shape, bound: float) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=-bound, maxval=bound)`` in
    float32 (zeros for a None key)."""
    if key is None:
        return torch.zeros(shape, dtype=torch.float32)
    return prng.uniform(key, shape, -bound, bound)


def _split(key: Optional[torch.Tensor], n: int) -> list:
    return [None] * n if key is None else list(prng.split(key, n))


def _zeros(like: Optional[torch.Tensor], shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32,
                       device=None if like is None else like.device)


def torch_linear(key, out_features: int, in_features: int) -> dict:
    """Weight [out, in] + bias [out] with nn.Linear defaults."""
    kw, kb = _split(key, 2)
    bound = 1.0 / math.sqrt(in_features)
    return {"w": uniform(kw, (out_features, in_features), bound),
            "b": uniform(kb, (out_features,), bound)}


def xavier_linear(key, out_features: int, in_features: int) -> dict:
    """``xavier_uniform_`` weight [out, in] + zero bias [out]."""
    bound = math.sqrt(6.0 / (in_features + out_features))
    return {"w": uniform(key, (out_features, in_features), bound),
            "b": _zeros(key, (out_features,))}


def torch_rnn_layer(key, gates: int, hidden: int, input_size: int) -> dict:
    """One (direction of a) recurrent layer with torch RNN defaults; rows
    stacked in torch gate order (r,z,n for GRU, i,f,g,o for LSTM)."""
    k1, k2, k3, k4 = _split(key, 4)
    bound = 1.0 / math.sqrt(hidden)
    g = gates * hidden
    return {"w_ih": uniform(k1, (g, input_size), bound),
            "w_hh": uniform(k2, (g, hidden), bound),
            "b_ih": uniform(k3, (g,), bound),
            "b_hh": uniform(k4, (g,), bound)}


def xavier_rnn_layer(key, gates: int, hidden: int, input_size: int) -> dict:
    """One (direction of a) recurrent layer with ``xavier_uniform_``
    applied to the stacked [G*H, D] matrices, as torch's named_parameters
    loop in the reference does, and zero biases."""
    k1, k2 = _split(key, 2)
    g = gates * hidden
    return {"w_ih": uniform(k1, (g, input_size),
                            math.sqrt(6.0 / (g + input_size))),
            "w_hh": uniform(k2, (g, hidden), math.sqrt(6.0 / (g + hidden))),
            "b_ih": _zeros(key, (g,)),
            "b_hh": _zeros(key, (g,))}


def linear(key, out_features: int, in_features: int,
           init: str = "torch") -> dict:
    """A Linear layer's {w, b} under ``init`` ("torch" or "xavier")."""
    if init == "torch":
        return torch_linear(key, out_features, in_features)
    if init == "xavier":
        return xavier_linear(key, out_features, in_features)
    raise ValueError(f"unknown init {init!r}")


def rnn_layer(key, gates: int, hidden: int, input_size: int,
              init: str = "torch") -> dict:
    if init == "torch":
        return torch_rnn_layer(key, gates, hidden, input_size)
    if init == "xavier":
        return xavier_rnn_layer(key, gates, hidden, input_size)
    raise ValueError(f"unknown init {init!r}")


def linear_module(p: dict, device=None, bias: bool = True) -> nn.Linear:
    """An ``nn.Linear`` holding ``p`` = {w [out, in], b [out]} (a
    :func:`linear` draw); ``bias=False`` drops ``b``."""
    out_features, in_features = p["w"].shape
    lin = nn.Linear(in_features, out_features, bias=bias, device=device)
    with torch.no_grad():
        lin.weight.copy_(p["w"])
        if bias:
            lin.bias.copy_(p["b"])
    return lin
