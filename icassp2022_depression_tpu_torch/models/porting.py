"""Param trees, reference ``state_dict()`` names and reference ``.pt``
checkpoints (port of :mod:`icassp2022_depression_tpu.models.porting`).

The JAX package keeps torch's tensor layouts, and its
``porting.{audio_net,text_net,fusion}_to_state_dict`` / ``rnn_to_state_dict``
(``models/porting.py:339-401`` there) name them as the reference modules
do.  The ``*_state_dict_from_jax`` functions are that mapping on this side,
so ``load_state_dict(sd, strict=True)`` on :class:`AudioNet`,
:class:`TextNet` or :class:`FusionNet` is the bridge between the two
packages; the ``*_tree_from_state_dict`` functions are their inverses, for
writing JAX-layout npz checkpoints from the port, and also the JAX
package's ``*_from_state_dict`` mappers of reference state dicts (the head
indices from ``head_input_dropout``, ``ln`` only where the config has it,
the text model's unused ``ln1`` / ``ln2`` defaulting to ones / zeros, keys
the model lacks ignored).

The reference's checkpoints are whole-module pickles
(``torch.save(model)``, ``Classification/audio_gru_whole.py:125``).
:func:`load_reference_pt` reads them, and plain state-dict ``.pt`` files,
in torch's zipfile or legacy format, through a restricted unpickler that
runs no pickled code (see :class:`_SafeRefUnpickler`);
:func:`export_reference_pt` writes a model back as a reference-layout
state-dict ``.pt``.

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

import pickle
import types
import warnings
from typing import Mapping

import numpy as np
import torch
from torch import nn

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
    """``sd[name]`` (a tensor or an array) as a float32 numpy copy."""
    if name not in sd:
        raise KeyError(f"state dict missing {name!r}; have e.g. "
                       f"{sorted(sd)[:8]}")
    v = sd[name]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.array(v, dtype=np.float32, copy=True)


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
    """Inverse of :func:`text_net_state_dict_from_jax`.  ``ln1`` / ``ln2``
    (declared by the reference module, unused by its forward) default to
    ones / zeros where ``sd`` lacks them, as the JAX mapper does."""
    i1, i2 = _head_indices(cfg)
    tree = {
        "rnn": rnn_tree_from_state_dict(sd, "lstm_net", cfg.rnn_layers,
                                        cfg.bidirectional),
        "attn": _linear_tree(sd, "attention_layer.0"),
        "fc1": _linear_tree(sd, f"fc_out.{i1}"),
        "fc2": _linear_tree(sd, f"fc_out.{i2}"),
    }
    for ln, dim in (("ln1", cfg.embedding_size), ("ln2", cfg.hidden_dims)):
        tree[ln] = (_linear_tree(sd, ln) if f"{ln}.weight" in sd else
                    {"w": np.ones((dim,), np.float32),
                     "b": np.zeros((dim,), np.float32)})
    return tree


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


# -- reference state dicts <-> the port's modules ----------------------------

_TREES = {"audio": audio_net_tree_from_state_dict,
          "text": text_net_tree_from_state_dict,
          "fusion": fusion_tree_from_state_dict}
_STATE_DICTS = {"audio": audio_net_state_dict_from_jax,
                "text": text_net_state_dict_from_jax,
                "fusion": fusion_state_dict_from_jax}


def state_dict_from_jax(tree: Mapping, kind: str, cfg) -> dict:
    """A JAX-layout param tree -> the state dict of the ``kind`` model
    ('audio' | 'text' | 'fusion') under ``cfg``."""
    return _STATE_DICTS[kind](tree, cfg)


def tree_from_reference(sd: Mapping, kind: str, cfg) -> dict:
    """A reference state dict (tensors or arrays) -> the ``kind`` model's
    JAX-layout param tree under ``cfg``: the JAX package's
    ``*_from_state_dict`` (keys the model lacks are ignored, a missing one
    raises)."""
    return _TREES[kind](sd, cfg)



def export_reference_pt(model_or_tree, kind: str, cfg, path) -> dict:
    """Write a model (its ``state_dict()``) or a JAX-layout param tree as a
    reference-layout state-dict ``.pt``: the names and float32 tensors of
    the JAX package's ``export_reference_pt``, so the reference module
    loads it with ``load_state_dict(torch.load(path), strict=True)``.
    Returns the exported ``{name: np.ndarray}``."""
    if isinstance(model_or_tree, nn.Module):
        sd = model_or_tree.state_dict()
    else:
        sd = state_dict_from_jax(model_or_tree, kind, cfg)
    out = {k: v.detach().to("cpu", torch.float32).contiguous().clone()
           for k, v in sd.items()}
    torch.save(out, path)
    return {k: v.numpy() for k, v in out.items()}


# -- loading the reference's ``.pt`` pickles ---------------------------------
#
# Unpickling a whole-module checkpoint normally imports the script that
# defined its class (and torch's nn classes of the version it was pickled
# under).  :func:`load_reference_pt` unpickles with a restricted
# ``find_class`` instead: torch's tensor-rebuild helpers and a few
# container primitives resolve for real, so the raw weights materialise,
# and EVERY other global (the reference's model classes, torch's
# nn.Module classes, anything else the pickle names) resolves to an inert
# shim that only captures attribute state.  The state dict is then read
# off the shim graph through torch's ``_parameters`` / ``_buffers`` /
# ``_modules`` layout.


class _ShimBase:
    """Inert stand-in for a global outside the allowlist.  It covers
    every way pickle touches a class: construction by NEWOBJ / REDUCE
    (``__init__`` keeps the arguments), BUILD (``__setstate__`` keeps the
    state) and calls on an instance (which return it)."""

    def __init__(self, *args, **kwargs):
        self._shim_args = args
        self._shim_kwargs = kwargs

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif (isinstance(state, tuple) and len(state) == 2
              and isinstance(state[0], dict)):
            # object.__reduce_ex__'s (dict, slots) pair
            self.__dict__.update(state[0] or {})
            self.__dict__.update(state[1] or {})
        else:
            self.__dict__["_shim_state"] = state

    def __call__(self, *args, **kwargs):
        return self


_SHIM_CACHE: dict = {}


def _shim_class(module: str, name: str):
    key = (module, name)
    if key not in _SHIM_CACHE:
        _SHIM_CACHE[key] = type(name, (_ShimBase,), {
            "__module__": f"<shim:{module}>",
            "_shim_origin": f"{module}.{name}"})
    return _SHIM_CACHE[key]


class _SafeRefUnpickler(pickle.Unpickler):
    """Unpickler whose globals allowlist is just enough to rebuild raw
    tensors; every other global is a shim.

    The allowlist is per NAME, not per module: pickle's REDUCE calls
    whatever ``find_class`` returns with arguments from the stream, so a
    whole module's namespace (``numpy.load``, ``torch.serialization.load``,
    ...) would hand the stream a way to run code.  What resolves:

    * ``torch._utils._rebuild_*``, the tensor and Parameter
      reconstructors of every ``torch.save`` stream;
    * ``torch.serialization._get_layout``, a helper of old streams;
    * ``collections.OrderedDict`` and numpy's array reconstructors;
    * from the ``torch`` module itself, dtypes, the ``*Storage`` classes,
      ``Size`` and ``device`` (types, not code).

    ``torch.storage._load_from_bytes`` is left out, unlike the JAX
    package's allowlist: it is ``torch.load(io.BytesIO(b),
    weights_only=False)``, an unrestricted unpickle of its argument, so a
    crafted legacy ``.pt`` naming it would run code.  ``torch.save`` never
    writes it, in either format (storages travel by persistent id; only
    plain ``pickle`` of a storage emits it), so it shims like any other
    global."""

    _ALLOWED = {
        "collections": ("OrderedDict",),
        "torch.serialization": ("_get_layout",),
        "numpy": ("ndarray", "dtype"),
        "numpy.core.multiarray": ("_reconstruct", "scalar"),
        "numpy._core.multiarray": ("_reconstruct", "scalar"),
    }

    def find_class(self, module, name):  # noqa: D102 (pickle API)
        import importlib

        if (name in self._ALLOWED.get(module, ())
                or (module == "torch._utils" and name.startswith("_rebuild"))):
            return getattr(importlib.import_module(module), name)
        if module == "torch":
            obj = getattr(torch, name, None)
            if (isinstance(obj, torch.dtype) or "Storage" in name
                    or name in ("Size", "device")):
                return obj
        return _shim_class(module, name)


#: ``pickle_module`` for ``torch.load``: the zipfile and the legacy paths
#: both unpickle through :class:`_SafeRefUnpickler` (torch subclasses it
#: and keeps the storages' persistent ids on its side)
_safe_pickle_module = types.SimpleNamespace(
    __name__="icassp2022_depression_tpu_torch.models.porting."
             "_safe_pickle_module",
    Unpickler=_SafeRefUnpickler,
    load=lambda f, **kw: _SafeRefUnpickler(f, **kw).load(),
)


def _tensor_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy().copy()
    return np.array(t, copy=True)


def _walk_module_shim(obj, prefix: str, out: dict) -> None:
    """``state_dict()``-style dotted names off a shimmed nn.Module graph,
    through torch's ``_parameters`` / ``_buffers`` / ``_modules``."""
    d = getattr(obj, "__dict__", None) or {}
    for name, p in (d.get("_parameters") or {}).items():
        if p is not None:
            out[prefix + name] = _tensor_np(p)
    for name, b in (d.get("_buffers") or {}).items():
        if b is not None:
            out[prefix + name] = _tensor_np(b)
    for name, m in (d.get("_modules") or {}).items():
        if m is not None:
            _walk_module_shim(m, f"{prefix}{name}.", out)


def load_reference_pt(path) -> dict:
    """``{name: np.ndarray}`` from a reference ``.pt``: a whole-module
    pickle (``torch.save(model)``) or a ``state_dict()`` mapping, in
    torch's zipfile or legacy format.  No class of the pickle is imported
    or run (:class:`_SafeRefUnpickler`)."""
    with warnings.catch_warnings():
        # the legacy format checks each module class's source against the
        # one it recorded; a shim has none
        warnings.filterwarnings("ignore", "Couldn't retrieve source code")
        obj = torch.load(path, map_location="cpu",
                         pickle_module=_safe_pickle_module,
                         weights_only=False)
    if isinstance(obj, Mapping):   # torch.save(model.state_dict())
        sd = {k: _tensor_np(v) for k, v in obj.items()
              if isinstance(v, (torch.Tensor, np.ndarray))}
        if sd:
            return sd
        raise ValueError(f"{path}: mapping checkpoint holds no tensors")
    d = getattr(obj, "__dict__", None) or {}
    if "_parameters" not in d and "_modules" not in d:
        raise ValueError(
            f"{path}: not a torch module pickle (top-level object "
            f"{getattr(type(obj), '_shim_origin', type(obj).__name__)} has "
            "no _parameters/_modules layout)")
    out: dict = {}
    _walk_module_shim(obj, "", out)
    if not out:
        raise ValueError(f"{path}: module pickle contained no tensors")
    return out
