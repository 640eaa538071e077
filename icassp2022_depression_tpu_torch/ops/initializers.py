"""Parameter initializers with the reference audio model's distributions
(port of :mod:`icassp2022_depression_tpu.ops.initializers`, torch-default
half; the xavier scheme of the text model arrives with the text slice).

Draws come from an explicit ``torch.Generator``; the distributions match
the JAX package's, the numbers do not (a different generator), so parity
tests carry weights across instead of re-drawing them.

* ``nn.Linear`` defaults: weight and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in));
* ``nn.GRU`` defaults: every tensor ~ U(-1/sqrt(H), 1/sqrt(H)).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


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
