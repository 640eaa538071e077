"""Parameter initializers with the reference models' distributions (port
of :mod:`icassp2022_depression_tpu.ops.initializers`).

Draws come from an explicit ``torch.Generator``; the distributions match
the JAX package's, the numbers do not (a different generator), so parity
tests carry weights across instead of re-drawing them.

* ``nn.Linear`` defaults: weight and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in));
* ``nn.GRU`` / ``nn.LSTM`` defaults: every tensor ~ U(-1/sqrt(H), 1/sqrt(H));
* the text model's ``xavier_uniform_`` weights with zero biases
  (``Classification/text_bilstm_whole.py:37-43``): U(-a, a) with
  a = sqrt(6 / (fan_in + fan_out)) over each whole weight matrix, the
  stacked ``[G*H, D]`` recurrent ones included.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def uniform(shape, bound: float, generator: Optional[torch.Generator] = None,
            dtype=torch.float32, device=None) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return u * (2.0 * bound) - bound


def torch_linear(out_features: int, in_features: int, generator=None,
                 dtype=torch.float32, device=None) -> dict:
    """Weight [out, in] + bias [out] with nn.Linear defaults."""
    bound = 1.0 / math.sqrt(in_features)
    return {
        "w": uniform((out_features, in_features), bound, generator, dtype, device),
        "b": uniform((out_features,), bound, generator, dtype, device),
    }


def torch_rnn_layer(gates: int, hidden: int, input_size: int, generator=None,
                    dtype=torch.float32, device=None) -> dict:
    """One (direction of a) recurrent layer with torch RNN defaults; rows
    stacked in torch gate order (r,z,n for GRU)."""
    bound = 1.0 / math.sqrt(hidden)
    g = gates * hidden
    return {
        "w_ih": uniform((g, input_size), bound, generator, dtype, device),
        "w_hh": uniform((g, hidden), bound, generator, dtype, device),
        "b_ih": uniform((g,), bound, generator, dtype, device),
        "b_hh": uniform((g,), bound, generator, dtype, device),
    }


def xavier_linear(out_features: int, in_features: int, generator=None,
                  dtype=torch.float32, device=None) -> dict:
    """``xavier_uniform_`` weight [out, in] + zero bias [out]."""
    bound = math.sqrt(6.0 / (in_features + out_features))
    return {
        "w": uniform((out_features, in_features), bound, generator, dtype,
                     device),
        "b": torch.zeros((out_features,), dtype=dtype, device=device),
    }


def xavier_rnn_layer(gates: int, hidden: int, input_size: int,
                     generator=None, dtype=torch.float32,
                     device=None) -> dict:
    """One (direction of a) recurrent layer with ``xavier_uniform_``
    applied to the stacked [G*H, D] matrices, as torch's named_parameters
    loop in the reference does, and zero biases."""
    g = gates * hidden
    return {
        "w_ih": uniform((g, input_size), math.sqrt(6.0 / (g + input_size)),
                        generator, dtype, device),
        "w_hh": uniform((g, hidden), math.sqrt(6.0 / (g + hidden)),
                        generator, dtype, device),
        "b_ih": torch.zeros((g,), dtype=dtype, device=device),
        "b_hh": torch.zeros((g,), dtype=dtype, device=device),
    }


def linear(out_features: int, in_features: int, init: str = "torch",
           generator=None, dtype=torch.float32, device=None) -> dict:
    """A Linear layer's {w, b} under ``init`` ("torch" or "xavier")."""
    if init == "torch":
        return torch_linear(out_features, in_features, generator, dtype,
                            device)
    if init == "xavier":
        return xavier_linear(out_features, in_features, generator, dtype,
                             device)
    raise ValueError(f"unknown init {init!r}")


def linear_module(in_features: int, out_features: int, init: str = "torch",
                  generator=None, device=None, bias: bool = True) -> nn.Linear:
    """An ``nn.Linear`` whose weight (and bias) are drawn by :func:`linear`
    from ``generator``."""
    lin = nn.Linear(in_features, out_features, bias=bias, device=device)
    p = linear(out_features, in_features, init, generator, device=device)
    with torch.no_grad():
        lin.weight.copy_(p["w"])
        if bias:
            lin.bias.copy_(p["b"])
    return lin
