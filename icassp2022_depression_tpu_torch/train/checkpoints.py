"""Checkpoint I/O in the JAX package's npz layout (port of
:mod:`icassp2022_depression_tpu.train.checkpoints`).

A checkpoint is a flat param tree written as ``<path>.npz`` with
'/'-joined key paths (``rnn/0/fwd/w_ih``, ``fc1/w``, ...) plus an optional
JSON sidecar ``<path>.json`` of metadata, so either package loads the
other's checkpoints.  Leaves may be numpy arrays or torch tensors.
:func:`load_model` also takes the reference's ``.pt`` checkpoints
(:func:`..models.porting.load_reference_pt`).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch
from torch import nn

from icassp2022_depression_tpu_torch.models import porting
from icassp2022_depression_tpu_torch.models.audio_net import AudioNet
from icassp2022_depression_tpu_torch.models.fusion import FusionNet
from icassp2022_depression_tpu_torch.models.text_net import TextNet
from icassp2022_depression_tpu_torch.utils.device import resolve_device


def atomic_savez(path, **arrays) -> Path:
    """``np.savez`` through a temp file + ``os.replace``, so a crash
    mid-write never leaves a truncated archive."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        pass
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _npz_path(path) -> str:
    path = str(path)
    if path.endswith(".pt"):
        # probed as x.pt.npz otherwise: point at the extension-dispatched
        # loader instead
        raise ValueError(
            f"{path} is a torch .pt checkpoint: load it through "
            "train.checkpoints.load_model or models.porting."
            "load_reference_pt (check, predict and export-pt dispatch on "
            "the extension)")
    return path if path.endswith(".npz") else path + ".npz"


def save(path, params, meta: dict | None = None) -> Path:
    """Write a param tree to ``<path>.npz`` (+ ``<path>.json`` metadata).
    A path already ending in ``.npz`` is taken as is."""
    path = Path(path)
    if path.suffix == ".npz":
        path = path.with_suffix("")
    atomic_savez(str(path) + ".npz", **_flatten(params))
    if meta is not None:
        tmp = Path(str(path) + ".json.tmp")
        tmp.write_text(json.dumps(meta, indent=2))
        os.replace(tmp, str(path) + ".json")
    return Path(str(path) + ".npz")


def load(path) -> dict:
    """Read ``<path>.npz`` into a nested dict of numpy arrays keyed by
    path segment (list indices stay string keys: ``tree["rnn"]["0"]``)."""
    with np.load(_npz_path(path)) as data:
        flat = {k: data[k] for k in data.files}
    nested: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        d = nested
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return nested


_MODELS = {"audio": AudioNet, "text": TextNet, "fusion": FusionNet}


def load_model(ckpt, kind: str, cfg, device=None) -> nn.Module:
    """A checkpoint -> the ``kind`` model ('audio' | 'text' | 'fusion')
    under ``cfg`` on ``device`` (None: the first card), in eval mode.

    ``ckpt`` may be a model (moved as it is), a JAX-layout param tree (a
    dict), a reference ``.pt`` (whole-module or state-dict pickle) or an
    npz checkpoint of either package."""
    device = resolve_device(device)
    if isinstance(ckpt, nn.Module):
        return ckpt.to(device).eval()
    if isinstance(ckpt, dict):
        tree = ckpt
    elif str(ckpt).endswith(".pt"):
        tree = porting.tree_from_reference(porting.load_reference_pt(ckpt),
                                           kind, cfg)
    else:
        tree = load(ckpt)
    model = _MODELS[kind](cfg)
    model.load_state_dict(porting.state_dict_from_jax(tree, kind, cfg),
                          strict=True)
    return model.to(device).eval()


def load_meta(path) -> dict:
    p = str(path)
    if p.endswith(".npz"):
        p = p[:-4]
    return json.loads(Path(p + ".json").read_text())


# -- reference-style checkpoint names ---------------------------------------


def audio_clf_name(embedding_size: int, hidden_dims: int, f1: float,
                   fold: int) -> str:
    return f"BiLSTM_gru_vlad{embedding_size}_{hidden_dims}_{f1:.2f}_{fold}"


def audio_reg_name(embedding_size: int, hidden_dims: int, mae: float) -> str:
    return f"gru_vlad{embedding_size}_{hidden_dims}_{mae:.2f}"


def text_clf_name(hidden_dims: int, f1: float, fold: int) -> str:
    return f"BiLSTM_{hidden_dims}_{f1:.2f}_{fold}"


def fuse_clf_name(f1: float, fold: int) -> str:
    return f"fuse_{f1:.2f}_{fold}"


def text_reg_name(hidden_dims: int, mae: float) -> str:
    return f"BiLSTM_{hidden_dims}_{mae:.2f}"


def fuse_reg_name(mae: float) -> str:
    return f"fuse_{mae:.2f}"
