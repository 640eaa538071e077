"""Audio branch model, "AudioBiLSTM" in the reference but a GRU (port of
:mod:`icassp2022_depression_tpu.models.audio_net`).

Classification (``Classification/audio_gru_whole.py:24-108``): LayerNorm
-> 2-layer GRU -> mean over time -> [Dropout, Linear(H, H), ReLU, Dropout,
Linear(H, 2)] -> softmax.  Regression (``Regression/audio_bilstm_perm.py``):
no LayerNorm, sum over time, the head ends in Linear(H, 1) + ReLU.  Both
are :class:`AudioNet` under an :class:`~..config.RNNConfig`.

Parameter names are the reference module's ``state_dict()`` names:
``ln.*`` (clf only), ``lstm_net_audio.{weight,bias}_{ih,hh}_l{k}``,
``attention_layer.0.*`` (declared but never used by the reference's
forward, kept for checkpoint fidelity) and ``fc_audio.{1,4}.*``
(``{0,3}`` without the head's input dropout), so
:func:`..models.porting.audio_net_state_dict_from_jax` output loads with
``strict=True``.

Every dropout mask (the GRU's inter-layer dropout and the head's two)
is drawn from the ``generator`` passed to :meth:`AudioNet.forward`, so a
training run is reproducible from its seed whatever else uses torch's
global generator.  The head's dropout slots in ``fc_audio`` are
parameter-free placeholders that keep the reference's indices.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from icassp2022_depression_tpu_torch.config import RNNConfig
from icassp2022_depression_tpu_torch.ops import initializers, rnn
from icassp2022_depression_tpu_torch.ops.nn import dropout, layer_norm


class AudioNet(nn.Module):
    def __init__(self, cfg: RNNConfig,
                 generator: Optional[torch.Generator] = None, device=None):
        """Torch-default init (the reference never calls its
        ``init_weight``) drawn from ``generator``."""
        super().__init__()
        self.cfg = cfg
        pooled = cfg.hidden_dims * (2 if cfg.bidirectional else 1)
        if cfg.input_layernorm:
            # the module holds ln.weight / ln.bias; the forward is
            # ops.nn.layer_norm, the JAX package's arithmetic
            self.ln = nn.LayerNorm(cfg.embedding_size, device=device)
        self.lstm_net_audio = rnn.RNN(
            cfg.embedding_size, cfg.hidden_dims, cfg.rnn_layers,
            cfg.bidirectional, cfg.dropout, cfg.cell, cfg.init,
            cfg.rnn_backend, generator, device)
        self.attention_layer = nn.Sequential(
            self._linear(cfg.hidden_dims, cfg.hidden_dims, generator, device),
            nn.ReLU())
        # [Dropout, Linear, ReLU, Dropout, Linear]: the dropouts run in
        # head() from the explicit generator; Identity keeps their indices
        head = [self._linear(pooled, cfg.hidden_dims, generator, device),
                nn.ReLU(), nn.Identity(),
                self._linear(cfg.hidden_dims, cfg.num_classes, generator,
                             device)]
        if cfg.head_input_dropout:
            head.insert(0, nn.Identity())
        self.fc_audio = nn.Sequential(*head)

    @staticmethod
    def _linear(in_features: int, out_features: int, generator, device):
        return initializers.linear_module(in_features, out_features, "torch",
                                          generator, device)

    def features(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T, D] -> pooled hidden [B, H * num_dirs] (pre-head)."""
        if self.cfg.input_layernorm:
            x = layer_norm(x, self.ln.weight, self.ln.bias)
        y, _, _ = self.lstm_net_audio(x, generator)
        if self.cfg.pooling == "mean":
            return y.mean(dim=1)
        if self.cfg.pooling == "sum":
            return y.sum(dim=1)
        raise ValueError(f"unsupported audio pooling {self.cfg.pooling!r}")

    def head(self, pooled: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """FC head before the final activation: [Dropout, Linear, ReLU,
        Dropout, Linear], the masks drawn from ``generator``."""
        cfg = self.cfg
        fc1, fc2 = (self.fc_audio[i] for i in
                    ((1, 4) if cfg.head_input_dropout else (0, 3)))
        h = pooled
        if cfg.head_input_dropout:
            h = dropout(h, cfg.dropout, self.training, generator)
        h = torch.relu(fc1(h))
        h = dropout(h, cfg.dropout, self.training, generator)
        return fc2(h)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T, D] -> [B, num_classes] probabilities (clf) or [B, 1]
        scores (reg)."""
        out = self.head(self.features(x, generator), generator)
        if self.cfg.head_activation == "softmax":
            return torch.softmax(out, dim=-1)
        if self.cfg.head_activation == "relu":
            return torch.relu(out)
        return out
