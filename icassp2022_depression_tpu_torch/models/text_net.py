"""Text branch model, "TextBiLSTM" (port of
:mod:`icassp2022_depression_tpu.models.text_net`).

Classification (``Classification/text_bilstm_whole.py:23-114``): 2-layer
bidirectional LSTM (1024 -> 128, inter-layer dropout 0.5) -> additive
attention ``attention_net_with_w`` over (outputs, final hidden states) ->
[Linear(128, 128), ReLU, Dropout, Linear(128, 2)] -> softmax; xavier init
with zero biases for every non-LayerNorm param (``:37-43``).  Regression
(``Regression/text_bilstm_perm.py:58-97``): the head is [Dropout, Linear,
ReLU, Dropout, Linear(128, 1)] -> ReLU.  Both are :class:`TextNet` under an
:class:`~..config.RNNConfig`.

Parameter names are the reference module's ``state_dict()`` names:
``lstm_net.{weight,bias}_{ih,hh}_l{k}[_reverse]``, ``attention_layer.0.*``,
``fc_out.{0,3}.*`` (clf) or ``fc_out.{1,4}.*`` (reg), and the LayerNorms
``ln1``/``ln2`` that the reference declares and never applies (kept for
checkpoint fidelity; they get no gradient), so
:func:`..models.porting.text_net_state_dict_from_jax` output loads with
``strict=True``.

Every dropout mask (the LSTM's inter-layer dropout and the head's) is
drawn from the ``generator`` passed to :meth:`TextNet.forward`; the head's
dropout slots in ``fc_out`` are parameter-free placeholders that keep the
reference's indices.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from icassp2022_depression_tpu_torch.config import RNNConfig
from icassp2022_depression_tpu_torch.ops import initializers, rnn
from icassp2022_depression_tpu_torch.ops.attention import attention_net_with_w
from icassp2022_depression_tpu_torch.ops.nn import dropout


class TextNet(nn.Module):
    def __init__(self, cfg: RNNConfig,
                 generator: Optional[torch.Generator] = None, device=None):
        """``cfg.init`` ("xavier" in both recipes) drawn from
        ``generator``."""
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_dims
        self.lstm_net = rnn.RNN(
            cfg.embedding_size, h, cfg.rnn_layers, cfg.bidirectional,
            cfg.dropout, cfg.cell, cfg.init, cfg.rnn_backend, generator,
            device)
        self.attention_layer = nn.Sequential(
            initializers.linear_module(h, h, cfg.init, generator, device),
            nn.ReLU())
        # [(Dropout,) Linear, ReLU, Dropout, Linear]: the dropouts run in
        # head() from the explicit generator; Identity keeps their indices
        fc = [initializers.linear_module(h, h, cfg.init, generator, device),
              nn.ReLU(), nn.Identity(),
              initializers.linear_module(h, cfg.num_classes, cfg.init,
                                         generator, device)]
        if cfg.head_input_dropout:
            fc.insert(0, nn.Identity())
        self.fc_out = nn.Sequential(*fc)
        self.ln1 = nn.LayerNorm(cfg.embedding_size, device=device)
        self.ln2 = nn.LayerNorm(h, device=device)

    def features(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T, D] -> attention context [B, H]."""
        y, h_n, _ = self.lstm_net(x, generator)
        att = self.attention_layer[0]
        return attention_net_with_w(att.weight, att.bias, y, h_n)

    def head(self, context: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        fc1, fc2 = (self.fc_out[i] for i in
                    ((1, 4) if cfg.head_input_dropout else (0, 3)))
        h = context
        if cfg.head_input_dropout:
            h = dropout(h, cfg.dropout, self.training, generator)
        h = torch.relu(fc1(h))
        h = dropout(h, cfg.dropout, self.training, generator)
        out = fc2(h)
        if cfg.head_activation == "softmax":
            return torch.softmax(out, dim=-1)
        if cfg.head_activation == "relu":
            return torch.relu(out)
        return out

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T, D] -> [B, num_classes] probabilities (clf) or [B, 1]
        scores (reg)."""
        return self.head(self.features(x, generator), generator)
