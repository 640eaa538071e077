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

Initial weights come from a threefry key split as the JAX package's
``audio_net.init`` splits it, and every dropout mask (the GRU's
inter-layer dropout and the head's two) from the key passed to
:meth:`AudioNet.forward`, split as ``audio_net.apply`` splits it: the same
key gives the JAX package's weights and masks bit for bit.  The head's
dropout slots in ``fc_audio`` are parameter-free placeholders that keep
the reference's indices.  A model made by :func:`.folds.stack` holds all
folds' parameters with a leading fold axis and runs on ``[F, B, T, D]``
with keys ``[F, 2]``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from icassp2022_depression_tpu_torch.config import RNNConfig
from icassp2022_depression_tpu_torch.ops import initializers, prng, rnn
from icassp2022_depression_tpu_torch.ops.nn import dropout, layer_norm, linear
from icassp2022_depression_tpu_torch.ops.prng import split2


class AudioNet(nn.Module):
    def __init__(self, cfg: RNNConfig, key: Optional[torch.Tensor] = None,
                 device=None):
        """Torch-default init (the reference never calls its
        ``init_weight``) drawn from the threefry ``key`` in the JAX
        package's order (``audio_net.init``); a None key leaves zeros for
        weights loaded next."""
        super().__init__()
        self.cfg = cfg
        pooled = cfg.hidden_dims * (2 if cfg.bidirectional else 1)
        k_rnn, k_attn, k_fc1, k_fc2 = ([None] * 4 if key is None
                                       else list(prng.split(key, 4)))
        if cfg.input_layernorm:
            # the module holds ln.weight / ln.bias; the forward is
            # ops.nn.layer_norm, the JAX package's arithmetic
            self.ln = nn.LayerNorm(cfg.embedding_size, device=device)
        self.lstm_net_audio = rnn.RNN(
            cfg.embedding_size, cfg.hidden_dims, cfg.rnn_layers,
            cfg.bidirectional, cfg.dropout, cfg.cell, cfg.init,
            cfg.rnn_backend, k_rnn, device)

        def lin(k, out_features, in_features):
            return initializers.linear_module(
                initializers.linear(k, out_features, in_features, cfg.init),
                device)

        self.attention_layer = nn.Sequential(
            lin(k_attn, cfg.hidden_dims, cfg.hidden_dims), nn.ReLU())
        # [Dropout, Linear, ReLU, Dropout, Linear]: the dropouts run in
        # head() from the explicit key; Identity keeps their indices
        head = [lin(k_fc1, cfg.hidden_dims, pooled), nn.ReLU(),
                nn.Identity(), lin(k_fc2, cfg.num_classes, cfg.hidden_dims)]
        if cfg.head_input_dropout:
            head.insert(0, nn.Identity())
        self.fc_audio = nn.Sequential(*head)

    def features(self, x: torch.Tensor,
                 key: Optional[torch.Tensor] = None,
                 time_mask: Optional[torch.Tensor] = None,
                 rows=None) -> torch.Tensor:
        """[B, T, D] -> pooled hidden [B, H * num_dirs] (pre-head); the
        GRU's masks from ``split(key)[1]``.

        ``time_mask`` [B, T] restricts the pooling to the valid steps (the
        ragged DAIC batches: responses padded at the tail to a common
        count).  The GRU still runs over the padded steps; mean pooling
        divides by ``max(sum(mask), 1)``, as the JAX package does.
        ``rows``: the dropout masks' rows of a larger batch
        (:func:`..ops.nn.dropout`)."""
        if self.cfg.input_layernorm:
            x = layer_norm(x, self.ln.weight, self.ln.bias)
        k_rnn = split2(key)[1] if self.training else None
        y, _, _ = self.lstm_net_audio(x, k_rnn, rows)
        if self.cfg.pooling not in ("mean", "sum"):
            raise ValueError(
                f"unsupported audio pooling {self.cfg.pooling!r}")
        if time_mask is not None:
            m = time_mask.to(y.dtype).unsqueeze(-1)
            pooled = (y * m).sum(dim=-2)
            if self.cfg.pooling == "mean":
                return pooled / torch.clamp(m.sum(dim=-2), min=1.0)
            return pooled
        if self.cfg.pooling == "mean":
            return y.mean(dim=-2)
        return y.sum(dim=-2)

    def head(self, pooled: torch.Tensor,
             key: Optional[torch.Tensor] = None, rows=None) -> torch.Tensor:
        """FC head before the final activation: [Dropout, Linear, ReLU,
        Dropout, Linear], the two masks from ``split(key)``."""
        cfg = self.cfg
        fc1, fc2 = (self.fc_audio[i] for i in
                    ((1, 4) if cfg.head_input_dropout else (0, 3)))
        k1, k2 = split2(key) if self.training else (None, None)
        h = pooled
        if cfg.head_input_dropout:
            h = dropout(h, cfg.dropout, self.training, k1, rows)
        h = torch.relu(linear(h, fc1.weight, fc1.bias))
        h = dropout(h, cfg.dropout, self.training, k2, rows)
        return linear(h, fc2.weight, fc2.bias)

    def forward(self, x: torch.Tensor,
                key: Optional[torch.Tensor] = None,
                time_mask: Optional[torch.Tensor] = None,
                rows=None) -> torch.Tensor:
        """[B, T, D] -> [B, num_classes] probabilities (clf) or [B, 1]
        scores (reg); in train mode the masks come from ``key`` (none
        without one), split as ``audio_net.apply`` splits it.
        ``time_mask`` [B, T], ``rows``: see :meth:`features`."""
        k_feat, k_head = split2(key) if self.training else (None, None)
        out = self.head(self.features(x, k_feat, time_mask, rows), k_head,
                        rows)
        if self.cfg.head_activation == "softmax":
            return torch.softmax(out, dim=-1)
        if self.cfg.head_activation == "relu":
            return torch.relu(out)
        return out
