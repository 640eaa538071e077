"""The fusion training loss ``MyLoss`` (port of
:mod:`icassp2022_depression_tpu.models.losses`).

``MyLoss`` (clf: ``Classification/fuse_net_whole.py:376-395``; reg:
``Regression/fuse_net.py:353-366``) splits the fusion head's weight
``fc_final`` at ``text_hidden_dims`` columns and scores each modality's
feature against its own block:

  loss = L(text_feat @ W[:, :Ht].T, y) + L(audio_feat @ W[:, Ht:].T, y)

with L = cross-entropy on raw logits (clf; not the branch trainers' double
softmax) or SmoothL1 against the raw SDS score (reg).
"""

from __future__ import annotations

from typing import Optional

import torch

from icassp2022_depression_tpu_torch.ops.nn import (
    linear,
    masked_cross_entropy_on_probs,
    smooth_l1_loss,
)


def _ce_logits(logits: torch.Tensor, labels: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch ``nn.CrossEntropyLoss`` on raw logits, mean over valid rows:
    the branches' loss is that same CE, applied to probabilities."""
    return masked_cross_entropy_on_probs(logits, labels, mask,
                                         logits.shape[-1])


def _split_scores(text_feat, audio_feat, w_final, text_hidden_dims: int):
    return (linear(text_feat, w_final[..., :text_hidden_dims]),
            linear(audio_feat, w_final[..., text_hidden_dims:]))


def myloss_ce(text_feat: torch.Tensor, audio_feat: torch.Tensor,
              targets: torch.Tensor, w_final: torch.Tensor,
              text_hidden_dims: int,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Classification MyLoss.  ``w_final``: [C, Ht + Ha]."""
    pred_text, pred_audio = _split_scores(text_feat, audio_feat, w_final,
                                          text_hidden_dims)
    return _ce_logits(pred_text, targets, mask) + \
        _ce_logits(pred_audio, targets, mask)


def myloss_smooth_l1(text_feat: torch.Tensor, audio_feat: torch.Tensor,
                     targets: torch.Tensor, w_final: torch.Tensor,
                     text_hidden_dims: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Regression MyLoss: SmoothL1 of each modality's linear score against
    the SDS target broadcast to the score's shape
    (``Regression/fuse_net.py:364-366``)."""
    pred_text, pred_audio = _split_scores(text_feat, audio_feat, w_final,
                                          text_hidden_dims)
    t = targets.to(torch.float32)[..., None].expand(pred_text.shape)
    m = None if mask is None else mask[..., None].expand(pred_text.shape)
    # the mean runs over every score of the batch ([B, C] -> [B C])
    t, m = t.flatten(-2), None if m is None else m.flatten(-2)
    return (smooth_l1_loss(pred_text.flatten(-2), t, m)
            + smooth_l1_loss(pred_audio.flatten(-2), t, m))
