"""JAX param trees <-> the port's ``state_dict()`` (port of the audio half
of :mod:`icassp2022_depression_tpu.models.porting`).

The JAX package keeps torch's tensor layouts, and
``porting.audio_net_to_state_dict`` / ``rnn_to_state_dict``
(``models/porting.py:339-371`` there) name them as the reference modules
do.  :func:`audio_net_state_dict_from_jax` is that mapping on this side,
so ``AudioNet.load_state_dict(sd, strict=True)`` is the bridge between
the two packages; :func:`audio_net_tree_from_state_dict` is its inverse,
for writing JAX-layout npz checkpoints from the port.

A tree may be nested (``{"rnn": [{"fwd": {...}}], "fc1": {...}}``, with
list indices as ints or as the string keys :func:`..train.checkpoints.load`
gives) or flat with '/'-joined keys (``"rnn/0/fwd/w_ih"``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from icassp2022_depression_tpu_torch.config import RNNConfig

_RNN_NAMES = (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
              ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))


def _nest(tree: Mapping) -> Mapping:
    if not any("/" in str(k) for k in tree):
        return tree
    nested: dict = {}
    for key, val in tree.items():
        parts = str(key).split("/")
        d = nested
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return nested


def _item(node, i: int):
    if isinstance(node, Mapping):
        return node[str(i)] if str(i) in node else node[i]
    return node[i]


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).clone()
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _head_indices(cfg: RNNConfig):
    return (1, 4) if cfg.head_input_dropout else (0, 3)


def rnn_state_dict_from_jax(layers, prefix: str, num_layers: int) -> dict:
    """JAX layer-list RNN params -> ``{prefix}.weight_ih_l{k}[_reverse]``."""
    out = {}
    for k in range(num_layers):
        entry = _item(layers, k)
        for dirn, suffix in (("fwd", ""), ("bwd", "_reverse")):
            if dirn not in entry:
                continue
            for short, long in _RNN_NAMES:
                out[f"{prefix}.{long}_l{k}{suffix}"] = _t(entry[dirn][short])
    return out


def audio_net_state_dict_from_jax(tree: Mapping, cfg: RNNConfig) -> dict:
    """JAX ``audio_net`` params -> :class:`..models.audio_net.AudioNet`
    state dict (float32 tensors on the CPU)."""
    tree = _nest(tree)
    i1, i2 = _head_indices(cfg)
    out = rnn_state_dict_from_jax(tree["rnn"], "lstm_net_audio",
                                  cfg.rnn_layers)
    for prefix, key in (("attention_layer.0", "attn"),
                        (f"fc_audio.{i1}", "fc1"), (f"fc_audio.{i2}", "fc2")):
        out[f"{prefix}.weight"] = _t(tree[key]["w"])
        out[f"{prefix}.bias"] = _t(tree[key]["b"])
    if cfg.input_layernorm:
        out["ln.weight"] = _t(tree["ln"]["w"])
        out["ln.bias"] = _t(tree["ln"]["b"])
    return out


def audio_net_tree_from_state_dict(sd: Mapping, cfg: RNNConfig) -> dict:
    """Inverse of :func:`audio_net_state_dict_from_jax`: a state dict ->
    the JAX package's nested param tree of numpy arrays."""
    def arr(name):
        return sd[name].detach().cpu().numpy().astype(np.float32)

    i1, i2 = _head_indices(cfg)
    dirs = (("fwd", ""), ("bwd", "_reverse"))[:2 if cfg.bidirectional else 1]
    tree = {
        "rnn": [{d: {short: arr(f"lstm_net_audio.{long}_l{k}{suffix}")
                     for short, long in _RNN_NAMES}
                 for d, suffix in dirs}
                for k in range(cfg.rnn_layers)],
        "attn": {"w": arr("attention_layer.0.weight"),
                 "b": arr("attention_layer.0.bias")},
        "fc1": {"w": arr(f"fc_audio.{i1}.weight"),
                "b": arr(f"fc_audio.{i1}.bias")},
        "fc2": {"w": arr(f"fc_audio.{i2}.weight"),
                "b": arr(f"fc_audio.{i2}.bias")},
    }
    if cfg.input_layernorm:
        tree["ln"] = {"w": arr("ln.weight"), "b": arr("ln.bias")}
    return tree
