"""Late-fusion multimodal net (port of
:mod:`icassp2022_depression_tpu.models.fusion`).

Classification (``Classification/fuse_net_whole.py:245-374``): frozen
branch feature extractors and a trained ``fc_final``:

* text branch: BiLSTM + additive attention + [Dropout, Linear(128, 128),
  ReLU, Dropout] (``:336-355``);
* audio branch: LayerNorm + GRU + **sum** over time + [Dropout,
  Linear(256, 256), ReLU, Dropout] (``:360-363``);
* head: ``fc_final`` = Linear(384 -> C, no bias) + softmax on
  concat(text, audio) (``:303-308,368-374``); ``modal_attn`` exists but the
  clf forward does not use it.

Regression (``Regression/fuse_net.py:224-351``): no audio LayerNorm; the
forward applies ``x * sigmoid(modal_attn(x))`` before ``fc_final`` + ReLU.

:meth:`FusionNet.pretrained_feature` runs under ``torch.no_grad()`` in both
tracks, as the reference's does (``fuse_net_whole.py:337``,
``Regression/fuse_net.py:314``), and ``no_grad`` does not turn dropout off:
in train mode the frozen branches still draw their masks (from the
explicit threefry key, split as ``fusion.pretrained_feature`` splits it;
the init from a key split as ``fusion.init`` splits it).  The training loss (``MyLoss``) is computed from
those detached features and ``fc_final``'s weight, so only
``fc_final.0.weight`` ever receives a gradient, in either track.

Parameter names are the reference module's (``porting.fusion_to_state_dict``
in the JAX package): ``lstm_net.*`` (text LSTM), ``attention_layer.0.*``,
``fc_out.1.*`` (text fc), ``lstm_net_audio.*`` (audio GRU),
``fc_audio.1.*``, ``ln.*`` (clf), ``modal_attn.weight`` and
``fc_final.0.weight``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from icassp2022_depression_tpu_torch.config import FusionConfig
from icassp2022_depression_tpu_torch.ops import initializers, prng, rnn
from icassp2022_depression_tpu_torch.ops.attention import attention_net_with_w
from icassp2022_depression_tpu_torch.ops.nn import dropout, layer_norm, linear


class FusionNet(nn.Module):
    def __init__(self, cfg: FusionConfig, key: Optional[torch.Tensor] = None,
                 device=None):
        """Torch-default init drawn from the threefry ``key`` in the JAX
        package's order (``fusion.init``; the branches are replaced by
        :meth:`init_from_branches` before training); a None key leaves
        zeros for weights loaded next."""
        super().__init__()
        self.cfg = cfg
        ht, ha = cfg.text_hidden_dims, cfg.audio_hidden_dims
        keys = [None] * 7 if key is None else list(prng.split(key, 7))

        def lin(k, i, o, bias=True):
            return initializers.linear_module(
                initializers.torch_linear(k, o, i), device, bias)

        self.attention_layer = nn.Sequential(lin(keys[0], ht, ht), nn.ReLU())
        self.lstm_net = rnn.RNN(cfg.text_embed_size, ht, cfg.rnn_layers,
                                True, cfg.dropout, "lstm", "torch",
                                cfg.rnn_backend, keys[1], device)
        # [Dropout, Linear, ReLU, Dropout]: Identity keeps the indices
        self.fc_out = nn.Sequential(nn.Identity(), lin(keys[2], ht, ht),
                                    nn.ReLU(), nn.Identity())
        if cfg.audio_layernorm:
            self.ln = nn.LayerNorm(cfg.audio_embed_size, device=device)
        self.lstm_net_audio = rnn.RNN(cfg.audio_embed_size, ha,
                                      cfg.rnn_layers, False, cfg.dropout,
                                      "gru", "torch", cfg.rnn_backend,
                                      keys[3], device)
        self.fc_audio = nn.Sequential(nn.Identity(), lin(keys[4], ha, ha),
                                      nn.ReLU(), nn.Identity())
        self.modal_attn = lin(keys[5], ht + ha, ht + ha, bias=False)
        self.fc_final = nn.Sequential(lin(keys[6], ht + ha, cfg.num_classes,
                                          bias=False))

    def _branch_fc(self, fc: nn.Linear, x: torch.Tensor, k_in, k_out,
                   rows=None):
        p = self.cfg.dropout
        x = dropout(x, p, self.training, k_in, rows)
        x = torch.relu(linear(x, fc.weight, fc.bias))
        return dropout(x, p, self.training, k_out, rows)

    def pretrained_feature(self, x_audio: torch.Tensor, x_text: torch.Tensor,
                           key: Optional[torch.Tensor] = None, rows=None):
        """Frozen branch forwards -> (text_feature [B, Ht], audio_feature
        [B, Ha]), without a graph; in train mode the masks come from
        ``split(key, 6)`` (text LSTM, text fc in/out, audio GRU, audio fc
        in/out), none without a key (``rows``: the masks' rows of a larger
        batch, :func:`..ops.nn.dropout`)."""
        ks = ([None] * 6 if key is None or not self.training else
              [k for k in prng.split(key, 6).unbind(-2)])
        with torch.no_grad():
            y, h_n, _ = self.lstm_net(x_text, ks[0], rows)
            att = self.attention_layer[0]
            ctx = attention_net_with_w(att.weight, att.bias, y, h_n)
            tf = self._branch_fc(self.fc_out[1], ctx, ks[1], ks[2], rows)
            xa = x_audio
            if self.cfg.audio_layernorm:
                xa = layer_norm(xa, self.ln.weight, self.ln.bias)
            ya, _, _ = self.lstm_net_audio(xa, ks[3], rows)
            af = self._branch_fc(self.fc_audio[1], ya.sum(dim=-2), ks[4],
                                 ks[5], rows)
        return tf, af

    def forward(self, concat_x: torch.Tensor) -> torch.Tensor:
        """The head on concat(text_feature, audio_feature) [B, Ht + Ha]."""
        x = concat_x
        if self.cfg.modal_attention:
            x = torch.sigmoid(linear(x, self.modal_attn.weight)) * x
        out = linear(x, self.fc_final[0].weight)
        if self.cfg.head_activation == "softmax":
            return torch.softmax(out, dim=-1)
        if self.cfg.head_activation == "relu":
            return torch.relu(out)
        return out

    def init_from_branches(self, text_sd: Optional[Mapping] = None,
                           audio_sd: Optional[Mapping] = None,
                           track: str = "classification") -> None:
        """Copy the trained branches in place (the reference's state-dict
        surgery, ``fuse_net_whole.py:568-588``,
        ``Regression/fuse_net.py:559-576``), with its key-mismatch rules:

        * text (:class:`.text_net.TextNet` state dict): ``lstm_net`` and
          ``attention_layer`` always; the fc only in the regression track,
          where the text model's ``fc_out.1`` matches the fusion's (the clf
          text model names it ``fc_out.0``, so the clf fusion keeps its
          own);
        * audio (:class:`.audio_net.AudioNet` state dict): the GRU and
          ``fc_audio.1`` always; ``ln`` only in the classification track.

        ``modal_attn`` and ``fc_final`` keep what they hold.  Parameters
        keep their identity, so an optimizer built over the model goes on
        tracking them."""
        pairs = []
        if text_sd is not None:
            pairs += [(k, text_sd[k]) for k in text_sd
                      if k.startswith(("lstm_net.", "attention_layer.0."))]
            if track == "regression":
                pairs += [(f"fc_out.1.{n}", text_sd[f"fc_out.1.{n}"])
                          for n in ("weight", "bias")]
        if audio_sd is not None:
            pairs += [(k, audio_sd[k]) for k in audio_sd
                      if k.startswith(("lstm_net_audio.", "fc_audio.1."))]
            if track == "classification" and self.cfg.audio_layernorm \
                    and "ln.weight" in audio_sd:
                pairs += [(f"ln.{n}", audio_sd[f"ln.{n}"])
                          for n in ("weight", "bias")]
        own = self.state_dict()
        with torch.no_grad():
            for k, v in pairs:
                own[k].copy_(v)
