"""Recompute fold metrics from saved checkpoints (port of
:mod:`icassp2022_depression_tpu.eval.checking`).

Reference counterparts: ``Classification/{Audio,Text,Fuse}ModelChecking.py``
and ``Regression/AudioModelChecking.py``, which re-run the split and
augmentation recipe, load each fold's checkpoint and print per-fold and
mean precision / recall / F1 (or MAE / RMSE).  Here the folds come from
:mod:`..data.augment` / :mod:`..data.folds`, the metrics from
:mod:`.metrics`, and a fold's checkpoint may be an in-memory model or
param tree, an npz checkpoint of either package or a reference ``.pt``
(:func:`..train.checkpoints.load_model`).

Each fold is one forward of its whole test split, in one batch on
``device`` (None: the first card), in eval mode under
``torch.inference_mode()``; on a card the recurrences run in the CUDA
kernels.  The JAX package pads that batch to a power of two so that the
folds share one XLA compile; here there is nothing to share, and since the
rows of a batch are independent (per-row LayerNorm, recurrence, attention
and head) the unpadded batch gives the same results.  The predictions
come back to the host, where the argmax and the metrics run in numpy, as
in the JAX package.  Each fold's result carries them under
``"predictions"`` besides the JAX package's keys.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from icassp2022_depression_tpu_torch import config as C
from icassp2022_depression_tpu_torch.data import augment, folds
from icassp2022_depression_tpu_torch.eval import metrics
from icassp2022_depression_tpu_torch.train import checkpoints
from icassp2022_depression_tpu_torch.utils.device import resolve_device


def fold_forward(model, xs: Sequence[np.ndarray]) -> np.ndarray:
    """One fold's test rows ``xs`` ((features,), or (audio, text) for the
    fusion) through ``model`` on its device, as one batch -> outputs
    [N, C] on the host."""
    device = next(model.parameters()).device
    with torch.inference_mode():
        ts = [torch.as_tensor(np.asarray(x, np.float32), device=device)
              for x in xs]
        if len(ts) == 2:
            tf, af = model.pretrained_feature(*ts)
            out = model(torch.cat([tf, af], dim=-1))
        else:
            out = model(ts[0])
    return out.cpu().numpy()


def _clf_fold_eval(pred_probs: np.ndarray, y: np.ndarray) -> dict:
    y_pred = np.argmax(pred_probs, axis=-1)
    cm = metrics.standard_confusion_matrix(y, y_pred)
    m = metrics.classification_metrics(cm)
    m["confusion_matrix"] = cm.tolist()
    return m


_mean = metrics.fold_mean
_CLF_KEYS = ("precision", "recall", "f1", "accuracy")


def _check_clf(kind: str, cfg, feature_arrays, targets, train_folds_idx,
               ckpt_paths, fold_cfg: C.FoldConfig, device):
    targets = np.asarray(targets)
    dep = np.where(targets == 1)[0]
    non = np.where(targets == 0)[0]
    device = resolve_device(device)
    results = []
    for fold, (tr_idx, ckpt) in enumerate(zip(train_folds_idx, ckpt_paths),
                                          start=1):
        _, (xte, yte) = augment.augment_classification_fold(
            feature_arrays, targets, tr_idx, dep, non,
            train_perm_ids=fold_cfg.train_perm_ids,
            test_perm_ids=fold_cfg.test_perm_ids)
        model = checkpoints.load_model(ckpt, kind, cfg, device)
        probs = fold_forward(model, xte)
        m = _clf_fold_eval(probs, yte)
        m["fold"] = fold
        m["predictions"] = probs
        results.append(m)
    return results, _mean(results, _CLF_KEYS)


def check_branch_clf(kind: str, mcfg: C.RNNConfig, features, targets,
                     train_folds_idx, ckpt_paths: Sequence,
                     fold_cfg: C.FoldConfig = C.FoldConfig(), device=None):
    """Audio / text classification checking (``kind`` 'audio' | 'text'):
    per-fold and mean precision / recall / F1 / accuracy.  Pass the
    training's ``fold_cfg``, so that the test split (its augmentation
    permutations) is the trainer's."""
    return _check_clf(kind, mcfg, [features], targets, train_folds_idx,
                      ckpt_paths, fold_cfg, device)


def check_audio_clf(features, targets, train_folds_idx, ckpt_paths,
                    mcfg: C.RNNConfig = C.AUDIO_CLF.model,
                    fold_cfg: C.FoldConfig = C.FoldConfig(), device=None):
    return check_branch_clf("audio", mcfg, features, targets,
                            train_folds_idx, ckpt_paths, fold_cfg, device)


def check_text_clf(features, targets, train_folds_idx, ckpt_paths,
                   mcfg: C.RNNConfig = C.TEXT_CLF.model,
                   fold_cfg: C.FoldConfig = C.FoldConfig(), device=None):
    return check_branch_clf("text", mcfg, features, targets,
                            train_folds_idx, ckpt_paths, fold_cfg, device)


def check_fuse_clf(audio_features, text_features, targets, train_folds_idx,
                   ckpt_paths, fcfg: C.FusionConfig = C.FUSE_CLF,
                   fold_cfg: C.FoldConfig = C.FoldConfig(), device=None):
    """Fusion checking (``FuseModelChecking.py:62-105``)."""
    return _check_clf("fusion", fcfg, [audio_features, text_features],
                      targets, train_folds_idx, ckpt_paths, fold_cfg,
                      device)


def _check_reg(kind: str, cfg, feature_arrays, targets, dep_idxs, non_idxs,
               ckpt_paths, fold_cfg: C.FoldConfig, device):
    targets = np.asarray(targets)
    device = resolve_device(device)
    results = []
    for fold, ckpt in enumerate(ckpt_paths):
        _, _, te_d, te_n = folds.reg_fold_split(
            dep_idxs, non_idxs, fold, fold_cfg.reg_test_dep,
            fold_cfg.reg_test_non)
        te = np.concatenate([te_d, te_n]).astype(np.int64)
        model = checkpoints.load_model(ckpt, kind, cfg, device)
        out = fold_forward(model, [f[te] for f in feature_arrays])
        pred = out.ravel()
        results.append({
            "fold": fold + 1,
            "mae": metrics.mean_absolute_error(targets[te], pred),
            "rmse": metrics.root_mean_squared_error(targets[te], pred),
            "predictions": out,
        })
    return results, _mean(results, ("mae", "rmse"))


def check_branch_reg(kind: str, mcfg: C.RNNConfig, features, targets,
                     dep_idxs, non_idxs, ckpt_paths,
                     fold_cfg: C.FoldConfig = C.FoldConfig(), device=None):
    """Regression checking: MAE / RMSE on each fold's unaugmented test
    split (``Regression/AudioModelChecking.py:129-155`` checks one fold;
    all three here).  Also the reference's single-modality fusion
    diagnostics ``evaluate_audio`` / ``evaluate_text``
    (``Regression/fuse_net.py:458-524``): the same test indices through
    that fold's branch checkpoint."""
    return _check_reg(kind, mcfg, [features], targets, dep_idxs, non_idxs,
                      ckpt_paths, fold_cfg, device)


def check_audio_reg(features, targets, dep_idxs, non_idxs, ckpt_paths,
                    mcfg: C.RNNConfig = C.AUDIO_REG.model, **kw):
    return check_branch_reg("audio", mcfg, features, targets, dep_idxs,
                            non_idxs, ckpt_paths, **kw)


def check_text_reg(features, targets, dep_idxs, non_idxs, ckpt_paths,
                   mcfg: C.RNNConfig = C.TEXT_REG.model, **kw):
    return check_branch_reg("text", mcfg, features, targets, dep_idxs,
                            non_idxs, ckpt_paths, **kw)


def check_fuse_reg(audio_features, text_features, targets, dep_idxs,
                   non_idxs, ckpt_paths, fcfg: C.FusionConfig = C.FUSE_REG,
                   fold_cfg: C.FoldConfig = C.FoldConfig(), device=None):
    return _check_reg("fusion", fcfg, [audio_features, text_features],
                      targets, dep_idxs, non_idxs, ckpt_paths, fold_cfg,
                      device)
