"""Optimizers with the reference's exact settings (port of
:mod:`icassp2022_depression_tpu.train.optim`).

* AdamW with per-group weight decay: decay ``cfg.weight_decay`` on
  everything except LayerNorm params, which get 0 -- the
  ``get_param_group`` split on ``'ln'`` (``audio_gru_whole.py:247-255``);
  a param is a LayerNorm param iff a component of its name starts with
  ``ln``, as the JAX package's mask reads its pytree paths.
* Plain Adam (torch defaults) for the regression trainers
  (``Regression/audio_bilstm_perm.py:250``).

A param that gets no gradient (the audio model's unused
``attention_layer``) keeps ``grad is None`` and torch's optimizers skip it,
decay included, which is what the JAX package's ``dead_paths`` mask does.
"""

from __future__ import annotations

import torch
from torch import nn

from icassp2022_depression_tpu_torch.config import OptimizerConfig


def is_layernorm(name: str) -> bool:
    return any(part.startswith("ln") for part in name.split("."))


def build(cfg: OptimizerConfig, model: nn.Module) -> torch.optim.Optimizer:
    """The recipe's optimizer over ``model``'s parameters.  Unknown names
    raise: a typo must not silently train with plain Adam."""
    if cfg.name not in ("adam", "adamw"):
        raise ValueError(f"unknown optimizer {cfg.name!r}: expected "
                         "'adam' or 'adamw'")
    kw = dict(lr=cfg.learning_rate, betas=(cfg.b1, cfg.b2), eps=cfg.eps)
    if cfg.name == "adamw" and cfg.weight_decay > 0:
        named = list(model.named_parameters())
        groups = [
            {"params": [p for n, p in named if not is_layernorm(n)],
             "weight_decay": cfg.weight_decay},
            {"params": [p for n, p in named if is_layernorm(n)],
             "weight_decay": 0.0},
        ]
        return torch.optim.AdamW(groups, **kw)
    return torch.optim.Adam(model.parameters(), **kw)
