"""Additive attention with the reference's ``attention_net_with_w``
semantics (port of :mod:`icassp2022_depression_tpu.ops.attention`; the
reference declares it in every script, e.g.
``Classification/text_bilstm_whole.py:74-99``).

Given the bidirectional RNN outputs ``lstm_out`` [B, T, 2H] and the final
hidden states ``lstm_hidden`` [B, L*D, H]:

1. sum the two halves of ``lstm_out`` along features -> h [B, T, H];
2. query = ReLU(Linear(sum of all L*D final hidden states)) [B, H];
3. scores = query . tanh(h)^T, softmax over time;
4. context = scores . h -> [B, H].
"""

from __future__ import annotations

import torch

from icassp2022_depression_tpu_torch.ops.nn import linear


def attention_net_with_w(w: torch.Tensor, b: torch.Tensor,
                         lstm_out: torch.Tensor,
                         lstm_hidden: torch.Tensor) -> torch.Tensor:
    """``w`` [H, H], ``b`` [H]: the ``attention_layer`` Linear.  With a
    fold axis every argument and the result lead with ``[F]``."""
    half = lstm_out.shape[-1] // 2
    h = lstm_out[..., :half] + lstm_out[..., half:]          # [B, T, H]
    query = lstm_hidden.sum(dim=-2)                          # [B, H]
    atten_w = torch.relu(linear(query, w, b))                # [B, H]
    scores = torch.einsum("...bh,...bth->...bt", atten_w, torch.tanh(h))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("...bt,...bth->...bh", weights, h)
