"""Small NN primitives and the training losses shared by the models (port
of :mod:`icassp2022_depression_tpu.ops.nn`).  A loss's ``mask`` marks the
valid rows of a padded batch; the mean is over those rows.

Fold axis: a model whose folds train as one program (``--vmap-folds``, the
counterpart of the JAX package's ``jax.vmap`` over folds) holds every
parameter with a leading fold axis ``[F, ...]`` and runs on inputs
``[F, ...]``.  :func:`linear` and :func:`layer_norm` take such a
parameter (:func:`fold_view` lines it up with the input), the losses
reduce over the last axis only, and :func:`dropout` takes one key per
fold, so each fold's numbers are the ones it gets alone.

Data parallelism: a rank that holds rows ``first .. first + b`` of a
batch of ``total`` passes ``rows=(first, total)`` down to :func:`dropout`,
and its dropout masks are those rows of the whole batch's masks (the
masks a single process draws), not masks of its own.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from icassp2022_depression_tpu_torch.ops import prng


@contextlib.contextmanager
def no_tf32_convs():
    """cuDNN runs float32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32``); the port's convolutions (the
    char-CNN's, VGGish's) run in full float32 inside this block, whatever
    the caller set."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def fold_view(p: torch.Tensor, ndim: int, rank: int) -> torch.Tensor:
    """A parameter of base rank ``rank`` (1: a vector, 2: a matrix) with
    a leading fold axis, as ``[F, 1, ..., 1, *base]`` of rank ``ndim``, so
    that it broadcasts against an input ``[F, ...]`` of rank ``ndim`` (a
    matrix in a product with it); one without a fold axis as it is."""
    if p.dim() == rank:
        return p
    return p.reshape(p.shape[:1] + (1,) * (ndim - 1 - rank) + p.shape[1:])


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w.T + b`` with torch's ``[out, in]`` weight layout; ``w`` /
    ``b`` with a fold axis ``[F, out, in]`` / ``[F, out]`` take an input
    ``[F, ..., in]``."""
    y = torch.matmul(x, fold_view(w, x.dim(), 2).transpose(-1, -2))
    return y if b is None else y + fold_view(b, x.dim(), 1)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis (torch ``nn.LayerNorm`` semantics,
    eps=1e-5, biased variance), written out as the JAX package does."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return ((x - mean) * torch.rsqrt(var + eps) * fold_view(w, x.dim(), 1)
            + fold_view(b, x.dim(), 1))


def dropout(x: torch.Tensor, rate: float, train: bool,
            key: Optional[torch.Tensor] = None, rows=None) -> torch.Tensor:
    """Inverted dropout, ``jax_nn.dropout``: the keep mask is
    ``bernoulli(key, 1 - rate, shape)`` (threefry, the JAX package's
    numbers), kept entries are ``x / keep``.  Identity in eval mode, at rate
    0 and without a key.  Keys ``[F, 2]`` draw one mask per fold of an
    ``[F, ...]`` input.  ``rows = (first, total)``: ``x`` holds rows
    ``first ..`` of a batch of ``total`` (the batch axis is the first
    after the fold axis), and the mask is those rows of the whole
    batch's."""
    if not train or rate <= 0.0 or key is None:
        return x
    keep = 1.0 - rate
    mask = prng.bernoulli(key, keep, x.shape[key.dim() - 1:], rows)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def _masked_mean(err: torch.Tensor, mask: Optional[torch.Tensor]):
    """The mean over the last axis (the batch), over its valid rows."""
    if mask is None:
        return err.mean(dim=-1)
    mask = mask.to(err.dtype)
    return ((err * mask).sum(dim=-1)
            / torch.clamp(mask.sum(dim=-1), min=1.0))


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
