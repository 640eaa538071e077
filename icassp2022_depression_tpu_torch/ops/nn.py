"""Small NN primitives and the training losses shared by the models (port
of :mod:`icassp2022_depression_tpu.ops.nn`).  A loss's ``mask`` marks the
valid rows of a padded batch; the mean is over those rows."""

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


def _masked_mean(err: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return err.mean()
    mask = mask.to(err.dtype)
    return (err * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def cross_entropy_on_probs(probs: torch.Tensor, labels: torch.Tensor,
                           num_classes: int) -> torch.Tensor:
    """The reference's double-softmax loss: the models end in ``nn.Softmax``
    and the trainers then apply ``nn.CrossEntropyLoss`` to the probabilities
    (``audio_gru_whole.py:72,308``), i.e. ``-log_softmax(probs)`` gathered at
    the label, mean over the batch."""
    return masked_cross_entropy_on_probs(probs, labels, None, num_classes)


def masked_cross_entropy_on_probs(probs: torch.Tensor, labels: torch.Tensor,
                                  mask: Optional[torch.Tensor],
                                  num_classes: int) -> torch.Tensor:
    """Mean-over-valid-rows variant for padded batches."""
    logp = torch.log_softmax(probs, dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long(), num_classes)
    losses = -(onehot.to(logp.dtype) * logp).sum(dim=-1)
    return _masked_mean(losses, mask)


def l1_loss(pred: torch.Tensor, target: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch ``nn.L1Loss`` (mean reduction), over valid rows."""
    return _masked_mean((pred - target).abs(), mask)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   beta: float = 1.0) -> torch.Tensor:
    """torch ``nn.SmoothL1Loss`` (huber with beta=1, mean reduction), over
    valid rows."""
    d = (pred - target).abs()
    err = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return _masked_mean(err, mask)
