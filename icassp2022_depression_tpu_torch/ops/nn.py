"""Small NN primitives shared by the models (port of
:mod:`icassp2022_depression_tpu.ops.nn`)."""

from __future__ import annotations

from typing import Optional

import torch


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w.T + b`` with torch's ``[out, in]`` weight layout."""
    y = torch.matmul(x, w.t())
    return y if b is None else y + b


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis (torch ``nn.LayerNorm`` semantics,
    eps=1e-5, biased variance), written out as the JAX package does."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout (identity in eval mode).  The keep mask is drawn
    from ``generator`` (or torch's default generator of ``x``'s device)."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
