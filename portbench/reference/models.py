"""Plain forwards of the published models, in evaluation mode, from a
state dict with the published modules' parameter names.

* the audio classifier (``Classification/audio_gru_whole.py:24-108``):
  LayerNorm -> 2-layer GRU -> mean over time -> Linear, ReLU, Linear ->
  softmax;
* the clf fusion (``Classification/fuse_net_whole.py:245-374``): the text
  branch a 2-layer BiLSTM, additive attention (``attention_net_with_w``)
  and Linear + ReLU; the audio branch LayerNorm, a 2-layer GRU, the sum
  over time and Linear + ReLU; ``fc_final`` (no bias) on the concatenation
  (text first), softmax.

Recurrences are step loops in the ``nn.GRU`` / ``nn.LSTM`` conventions
(gates r, z, n / i, f, g, o, zero initial state; the final hidden states
in the order layer 0 forward, layer 0 backward, layer 1 forward, ...).
"""

from __future__ import annotations

from typing import Mapping

import torch

from portbench.reference import precision


def _linear(x, w, b, prec):
    y = precision.matmul(x, w.t(), prec)
    return y if b is None else y + b


def _layer_norm(x, w, b, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def _gru_dir(x, w_ih, w_hh, b_ih, b_hh, prec):
    h = x.new_zeros((x.shape[0], w_hh.shape[1]))
    xp = _linear(x, w_ih, b_ih, prec)
    hid = h.shape[-1]
    ys = []
    for t in range(x.shape[1]):
        hp = _linear(h, w_hh, b_hh, prec)
        xt = xp[:, t]
        r = torch.sigmoid(xt[:, :hid] + hp[:, :hid])
        z = torch.sigmoid(xt[:, hid:2 * hid] + hp[:, hid:2 * hid])
        n = torch.tanh(xt[:, 2 * hid:] + r * hp[:, 2 * hid:])
        h = (1.0 - z) * n + z * h
        ys.append(h)
    return torch.stack(ys, dim=1), h


def _lstm_dir(x, w_ih, w_hh, b_ih, b_hh, prec):
    hid = w_hh.shape[1]
    h = x.new_zeros((x.shape[0], hid))
    c = torch.zeros_like(h)
    xp = _linear(x, w_ih, b_ih, prec)
    ys = []
    for t in range(x.shape[1]):
        g = xp[:, t] + _linear(h, w_hh, b_hh, prec)
        i = torch.sigmoid(g[:, :hid])
        f = torch.sigmoid(g[:, hid:2 * hid])
        gg = torch.tanh(g[:, 2 * hid:3 * hid])
        o = torch.sigmoid(g[:, 3 * hid:])
        c = f * c + i * gg
        h = o * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1), h


def rnn(sd: Mapping, prefix: str, x, layers: int, bidirectional: bool,
        cell: str, prec: str):
    """-> (outputs [B, T, H * dirs], final hidden states [B, L * dirs, H])."""
    run = _gru_dir if cell == "gru" else _lstm_dir
    finals = []
    y = x
    for k in range(layers):
        outs = []
        for suffix in ("", "_reverse")[:2 if bidirectional else 1]:
            w = [sd[f"{prefix}.{n}_l{k}{suffix}"]
                 for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
            inp = y.flip(1) if suffix else y
            ys, h = run(inp, *w, prec)
            outs.append(ys.flip(1) if suffix else ys)
            finals.append(h)
        y = torch.cat(outs, dim=-1)
    return y, torch.stack(finals, dim=1)


def audio_clf(sd: Mapping, audio: torch.Tensor, cfg: Mapping,
              prec: str = "fp32") -> torch.Tensor:
    """[N, T, D] features -> [N, 2] probabilities."""
    x = _layer_norm(audio, sd["ln.weight"], sd["ln.bias"])
    y, _ = rnn(sd, "lstm_net_audio", x, cfg["rnn_layers"], False, "gru",
               prec)
    h = torch.relu(_linear(y.mean(dim=1), sd["fc_audio.1.weight"],
                           sd["fc_audio.1.bias"], prec))
    out = _linear(h, sd["fc_audio.4.weight"], sd["fc_audio.4.bias"], prec)
    return torch.softmax(out, dim=-1)


def fuse_clf(sd: Mapping, audio: torch.Tensor, text: torch.Tensor,
             cfg: Mapping, prec: str = "fp32") -> torch.Tensor:
    """[N, T, Da] audio and [N, T, Dt] text features -> [N, 2]
    probabilities."""
    y, h_n = rnn(sd, "lstm_net", text, cfg["rnn_layers"], True, "lstm",
                 prec)
    half = y.shape[-1] // 2
    h = y[..., :half] + y[..., half:]
    query = torch.relu(_linear(h_n.sum(dim=1), sd["attention_layer.0.weight"],
                               sd["attention_layer.0.bias"], prec))
    scores = torch.einsum("bh,bth->bt", query, torch.tanh(h))
    ctx = torch.einsum("bt,bth->bh", torch.softmax(scores, dim=-1), h)
    tf = torch.relu(_linear(ctx, sd["fc_out.1.weight"], sd["fc_out.1.bias"],
                            prec))
    xa = _layer_norm(audio, sd["ln.weight"], sd["ln.bias"])
    ya, _ = rnn(sd, "lstm_net_audio", xa, cfg["rnn_layers"], False, "gru",
                prec)
    af = torch.relu(_linear(ya.sum(dim=1), sd["fc_audio.1.weight"],
                            sd["fc_audio.1.bias"], prec))
    out = _linear(torch.cat([tf, af], dim=-1), sd["fc_final.0.weight"],
                  None, prec)
    return torch.softmax(out, dim=-1)
