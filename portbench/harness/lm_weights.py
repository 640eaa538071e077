"""The ``deepseek_v3`` text embedder's weights and lexicon, drawn from the
seed.

Each tensor is drawn on the device by a ``torch.Generator`` seeded from
``(seed, name)``, so one tensor can be drawn again without the others,
and the check can draw the whole model anew once the program is freed:
no host copy of its 62.5 GB is ever made.  Matrices and the embedding are
normal with the standard deviation 0.02 (the ``initializer_range`` of the
published DeepSeek-V3 configurations, recalled); norm gains ``1 +- 0.1``
and the selection biases ``+- 0.1``, uniform (the published biases are
learned; these are assumed, of the order of the spread of the scores they
shift).  The names and shapes are the program's layout
(``models/moe_lm.py::param_shapes``).  The lexicon maps the traffic's
characters to distinct ids below the BOS id, drawn from the seed.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

STD = 0.02
NORM_BOUND = 0.1
BIAS_BOUND = 0.1


def tensor_seed(seed: int, name: str) -> int:
    digest = hashlib.blake2b(f"{seed}/{name}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") >> 1


def draw_one(seed: int, name: str, shape: Sequence[int],
             device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(tensor_seed(seed, name))
    if name.endswith("norm.weight") or name.endswith("layernorm.weight"):
        t = torch.rand(tuple(shape), generator=gen, device=device)
        return t.sub_(0.5).mul_(2 * NORM_BOUND).add_(1.0)
    if name.endswith("e_score_correction_bias"):
        t = torch.rand(tuple(shape), generator=gen, device=device)
        return t.sub_(0.5).mul_(2 * BIAS_BOUND)
    t = torch.randn(tuple(shape), generator=gen, device=device)
    return t.mul_(STD)


def draw(shapes: Mapping[str, Sequence[int]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """{name: shape} -> the weights on ``device``."""
    return {name: draw_one(seed, name, shape, device)
            for name, shape in shapes.items()}


def lexicon(chars: Sequence[str], seed: int, below: int) -> Dict[str, int]:
    """``chars`` -> distinct ids in ``[0, below)``, drawn from the seed."""
    rng = np.random.default_rng([seed, 11])
    ids = rng.choice(below, len(chars), replace=False)
    return {c: int(i) for c, i in zip(chars, ids)}
