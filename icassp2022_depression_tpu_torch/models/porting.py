"""JAX param trees <-> the port's ``state_dict()`` (port of the
state-dict mappers of :mod:`icassp2022_depression_tpu.models.porting`; the
reference ``.pt`` loaders are not ported yet).

The JAX package keeps torch's tensor layouts, and its
``porting.{audio_net,text_net,fusion}_to_state_dict`` / ``rnn_to_state_dict``
(``models/porting.py:339-401`` there) name them as the reference modules
do.  The ``*_state_dict_from_jax`` functions are that mapping on this side,
so ``load_state_dict(sd, strict=True)`` on :class:`AudioNet`,
:class:`TextNet` or :class:`FusionNet` is the bridge between the two
packages; the ``*_tree_from_state_dict`` functions are their inverses, for
writing JAX-layout npz checkpoints from the port.

The text frontend's encoders (the char-CNN, the LSTMP biLM and the
stand-in BiLSTM, :mod:`.char_cnn` / :mod:`.elmo`) keep the JAX package's
param trees as they are, dicts and lists of tensors;
:func:`elmo_tree_from_jax` carries such a tree across.  The bundle npz
(:func:`.elmo_pretrained.save_npz`) is the other bridge.

A tree may be nested (``{"rnn": [{"fwd": {...}}], "fc1": {...}}``, with
list indices as ints or as the string keys :func:`..train.checkpoints.load`
gives) or flat with '/'-joined keys (``"rnn/0/fwd/w_ih"``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from icassp2022_depression_tpu_torch.config import FusionConfig, RNNConfig

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


def _linears_from_jax(tree: Mapping, names) -> dict:
    """``(prefix, key, bias)`` triples -> ``{prefix}.weight`` (and
    ``.bias``) from ``tree[key]["w"]`` / ``["b"]``."""
    out = {}
    for prefix, key, bias in names:
        out[f"{prefix}.weight"] = _t(tree[key]["w"])
        if bias:
            out[f"{prefix}.bias"] = _t(tree[key]["b"])
    return out


def _arr(sd: Mapping, name: str) -> np.ndarray:
    return sd[name].detach().cpu().numpy().astype(np.float32)


def _linear_tree(sd: Mapping, prefix: str, bias: bool = True) -> dict:
    out = {"w": _arr(sd, f"{prefix}.weight")}
    if bias:
        out["b"] = _arr(sd, f"{prefix}.bias")
    return out


def rnn_tree_from_state_dict(sd: Mapping, prefix: str, num_layers: int,
                             bidirectional: bool) -> list:
    """Inverse of :func:`rnn_state_dict_from_jax`."""
    dirs = (("fwd", ""), ("bwd", "_reverse"))[:2 if bidirectional else 1]
    return [{d: {short: _arr(sd, f"{prefix}.{long}_l{k}{suffix}")
                 for short, long in _RNN_NAMES}
             for d, suffix in dirs}
            for k in range(num_layers)]


def audio_net_state_dict_from_jax(tree: Mapping, cfg: RNNConfig) -> dict:
    """JAX ``audio_net`` params -> :class:`..models.audio_net.AudioNet`
    state dict (float32 tensors on the CPU)."""
    tree = _nest(tree)
    i1, i2 = _head_indices(cfg)
    out = rnn_state_dict_from_jax(tree["rnn"], "lstm_net_audio",
                                  cfg.rnn_layers)
    out.update(_linears_from_jax(tree, (
        ("attention_layer.0", "attn", True), (f"fc_audio.{i1}", "fc1", True),
        (f"fc_audio.{i2}", "fc2", True))))
    if cfg.input_layernorm:
        out.update(_linears_from_jax(tree, (("ln", "ln", True),)))
    return out


def audio_net_tree_from_state_dict(sd: Mapping, cfg: RNNConfig) -> dict:
    """Inverse of :func:`audio_net_state_dict_from_jax`: a state dict ->
    the JAX package's nested param tree of numpy arrays."""
    i1, i2 = _head_indices(cfg)
    tree = {
        "rnn": rnn_tree_from_state_dict(sd, "lstm_net_audio", cfg.rnn_layers,
                                        cfg.bidirectional),
        "attn": _linear_tree(sd, "attention_layer.0"),
        "fc1": _linear_tree(sd, f"fc_audio.{i1}"),
        "fc2": _linear_tree(sd, f"fc_audio.{i2}"),
    }
    if cfg.input_layernorm:
        tree["ln"] = _linear_tree(sd, "ln")
    return tree


def text_net_state_dict_from_jax(tree: Mapping, cfg: RNNConfig) -> dict:
    """JAX ``text_net`` params -> :class:`..models.text_net.TextNet` state
    dict (the names of ``porting.text_net_to_state_dict``, ``ln1``/``ln2``
    included)."""
    tree = _nest(tree)
    i1, i2 = _head_indices(cfg)
    out = rnn_state_dict_from_jax(tree["rnn"], "lstm_net", cfg.rnn_layers)
    out.update(_linears_from_jax(tree, (
        ("attention_layer.0", "attn", True), (f"fc_out.{i1}", "fc1", True),
        (f"fc_out.{i2}", "fc2", True), ("ln1", "ln1", True),
        ("ln2", "ln2", True))))
    return out


def text_net_tree_from_state_dict(sd: Mapping, cfg: RNNConfig) -> dict:
    """Inverse of :func:`text_net_state_dict_from_jax`."""
    i1, i2 = _head_indices(cfg)
    return {
        "rnn": rnn_tree_from_state_dict(sd, "lstm_net", cfg.rnn_layers,
                                        cfg.bidirectional),
        "attn": _linear_tree(sd, "attention_layer.0"),
        "fc1": _linear_tree(sd, f"fc_out.{i1}"),
        "fc2": _linear_tree(sd, f"fc_out.{i2}"),
        "ln1": _linear_tree(sd, "ln1"),
        "ln2": _linear_tree(sd, "ln2"),
    }


def fusion_state_dict_from_jax(tree: Mapping, cfg: FusionConfig) -> dict:
    """JAX ``fusion`` params -> :class:`..models.fusion.FusionNet` state
    dict (the names of ``porting.fusion_to_state_dict``)."""
    tree = _nest(tree)
    text, audio = tree["text"], tree["audio"]
    out = rnn_state_dict_from_jax(text["rnn"], "lstm_net", cfg.rnn_layers)
    out.update(rnn_state_dict_from_jax(audio["rnn"], "lstm_net_audio",
                                       cfg.rnn_layers))
    out.update(_linears_from_jax(text, (("attention_layer.0", "attn", True),
                                        ("fc_out.1", "fc", True))))
    out.update(_linears_from_jax(audio, (("fc_audio.1", "fc", True),)))
    out.update(_linears_from_jax(tree, (("modal_attn", "modal_attn", False),
                                        ("fc_final.0", "fc_final", False))))
    if cfg.audio_layernorm:
        out.update(_linears_from_jax(audio, (("ln", "ln", True),)))
    return out


def fusion_tree_from_state_dict(sd: Mapping, cfg: FusionConfig) -> dict:
    """Inverse of :func:`fusion_state_dict_from_jax`."""
    tree = {
        "text": {"attn": _linear_tree(sd, "attention_layer.0"),
                 "rnn": rnn_tree_from_state_dict(sd, "lstm_net",
                                                 cfg.rnn_layers, True),
                 "fc": _linear_tree(sd, "fc_out.1")},
        "audio": {"rnn": rnn_tree_from_state_dict(sd, "lstm_net_audio",
                                                  cfg.rnn_layers, False),
                  "fc": _linear_tree(sd, "fc_audio.1")},
        "modal_attn": _linear_tree(sd, "modal_attn", bias=False),
        "fc_final": _linear_tree(sd, "fc_final.0", bias=False),
    }
    if cfg.audio_layernorm:
        tree["audio"]["ln"] = _linear_tree(sd, "ln")
    return tree


def elmo_tree_from_jax(tree):
    """A JAX text-encoder param tree (``char_cnn.init``,
    ``elmo.init_lstmp_encoder``, ``elmo.init``, or a converted bundle's
    ``cc_params`` / ``enc_params``; numpy or jax arrays, nested or with
    '/'-joined keys, list indices as ints or digit strings) -> the same
    tree of float32 CPU tensors, lists restored."""
    if isinstance(tree, Mapping):
        tree = _nest(tree)
        keys = list(tree)
        if keys and all(str(k).isdigit() for k in keys):
            return [elmo_tree_from_jax(_item(tree, i))
                    for i in range(len(keys))]
        return {k: elmo_tree_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [elmo_tree_from_jax(v) for v in tree]
    return _t(tree)
