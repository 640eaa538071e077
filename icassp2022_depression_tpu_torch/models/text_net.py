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

Initial weights come from a threefry key split as the JAX package's
``text_net.init`` splits it, and every dropout mask (the LSTM's
inter-layer dropout and the head's) from the key passed to
:meth:`TextNet.forward`, split as ``text_net.apply`` splits it; the head's
dropout slots in ``fc_out`` are parameter-free placeholders that keep the
reference's indices.  A fold-stacked model (:func:`.folds.stack`) runs on
``[F, B, T, D]`` with keys ``[F, 2]``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from icassp2022_depression_tpu_torch.config import RNNConfig
from icassp2022_depression_tpu_torch.ops import initializers, prng, rnn
from icassp2022_depression_tpu_torch.ops.attention import attention_net_with_w
from icassp2022_depression_tpu_torch.ops.nn import dropout, linear
from icassp2022_depression_tpu_torch.ops.prng import split2


class TextNet(nn.Module):
    def __init__(self, cfg: RNNConfig, key: Optional[torch.Tensor] = None,
                 device=None):
        """``cfg.init`` ("xavier" in both recipes) drawn from the threefry
        ``key`` in the JAX package's order (``text_net.init``); a None key
        leaves zeros for weights loaded next."""
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_dims
        k_rnn, k_attn, k_fc1, k_fc2 = ([None] * 4 if key is None
                                       else list(prng.split(key, 4)))
        self.lstm_net = rnn.RNN(
            cfg.embedding_size, h, cfg.rnn_layers, cfg.bidirectional,
            cfg.dropout, cfg.cell, cfg.init, cfg.rnn_backend, k_rnn, device)

        def lin(k, out_features, in_features):
            return initializers.linear_module(
                initializers.linear(k, out_features, in_features, cfg.init),
                device)

        self.attention_layer = nn.Sequential(lin(k_attn, h, h), nn.ReLU())
        # [(Dropout,) Linear, ReLU, Dropout, Linear]: the dropouts run in
        # head() from the explicit key; Identity keeps their indices
        fc = [lin(k_fc1, h, h), nn.ReLU(), nn.Identity(),
              lin(k_fc2, cfg.num_classes, h)]
        if cfg.head_input_dropout:
            fc.insert(0, nn.Identity())
        self.fc_out = nn.Sequential(*fc)
        self.ln1 = nn.LayerNorm(cfg.embedding_size, device=device)
        self.ln2 = nn.LayerNorm(h, device=device)

    def features(self, x: torch.Tensor,
                 key: Optional[torch.Tensor] = None,
                 rows=None) -> torch.Tensor:
        """[B, T, D] -> attention context [B, H]; the LSTM's masks from
        ``split(key)[1]`` (``rows``: the masks' rows of a larger batch,
        :func:`..ops.nn.dropout`)."""
        k_rnn = split2(key)[1] if self.training else None
        y, h_n, _ = self.lstm_net(x, k_rnn, rows)
        att = self.attention_layer[0]
        return attention_net_with_w(att.weight, att.bias, y, h_n)

    def head(self, context: torch.Tensor,
             key: Optional[torch.Tensor] = None, rows=None) -> torch.Tensor:
        cfg = self.cfg
        fc1, fc2 = (self.fc_out[i] for i in
                    ((1, 4) if cfg.head_input_dropout else (0, 3)))
        k1, k2 = split2(key) if self.training else (None, None)
        h = context
        if cfg.head_input_dropout:
            h = dropout(h, cfg.dropout, self.training, k1, rows)
        h = torch.relu(linear(h, fc1.weight, fc1.bias))
        h = dropout(h, cfg.dropout, self.training, k2, rows)
        out = linear(h, fc2.weight, fc2.bias)
        if cfg.head_activation == "softmax":
            return torch.softmax(out, dim=-1)
        if cfg.head_activation == "relu":
            return torch.relu(out)
        return out

    def forward(self, x: torch.Tensor,
                key: Optional[torch.Tensor] = None,
                rows=None) -> torch.Tensor:
        """[B, T, D] -> [B, num_classes] probabilities (clf) or [B, 1]
        scores (reg); in train mode the masks come from ``key``, split as
        ``text_net.apply`` splits it (``rows``: see :meth:`features`)."""
        k_feat, k_head = split2(key) if self.training else (None, None)
        return self.head(self.features(x, k_feat, rows), k_head, rows)
