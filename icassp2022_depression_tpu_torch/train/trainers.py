"""The audio track trainers (port of the audio half of
:mod:`icassp2022_depression_tpu.train.trainers`), each a thin wiring of:
fold recipe -> permutation augmentation plans -> fold tensors gathered on
the device -> :func:`..train.loop.run_fold` per fold -> gated-best
checkpoint on disk.

Reference counterparts:

* audio clf -- ``Classification/audio_gru_whole.py`` (AdamW lr 6e-6, CE,
  batch 8, 170 epochs, LayerNorm-exempt weight decay)
* audio reg -- ``Regression/audio_bilstm_perm.py`` (Adam lr 1e-5, L1,
  batch 2, 120 epochs)

Per fold, the initial weights come from a CPU ``torch.Generator`` seeded
from ``(seed, fold)``, so a run on the card and one on the CPU start from
the same weights; the dropout masks come from a generator on the run's
device seeded from ``(seed + 1000, fold)``.  Both streams differ from the
JAX package's threefry streams: parity runs carry weights across
(``init_params_per_fold``) and train with dropout 0.  The folds run one
after the other; fold vectorisation and multi-GPU are not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from icassp2022_depression_tpu_torch import config as C
from icassp2022_depression_tpu_torch.data import augment, folds
from icassp2022_depression_tpu_torch.models import porting
from icassp2022_depression_tpu_torch.models.audio_net import AudioNet
from icassp2022_depression_tpu_torch.ops.nn import (
    l1_loss,
    masked_cross_entropy_on_probs,
    smooth_l1_loss,
)
from icassp2022_depression_tpu_torch.train import checkpoints, loop, optim


def _fold_seed(seed: int, fold: int) -> int:
    """A well-mixed 32-bit seed for ``(seed, fold)``."""
    return int(np.random.SeedSequence([seed, fold]).generate_state(1)[0])


def _branch_fns(tcfg: C.TrainerConfig):
    """The track's ``loss_fn(pred, y, mask)``.  Acceptance matches dispatch
    exactly, so a misconfigured loss never trains with another one."""
    track = tcfg.track
    allowed = (("ce",) if track == "classification"
               else ("l1", "smooth_l1"))
    if tcfg.loss not in allowed:
        raise ValueError(
            f"loss {tcfg.loss!r} is not valid for track {track!r} "
            f"(expected one of {allowed})")
    num_classes = tcfg.model.num_classes

    def loss_fn(pred, y, mask):
        if track == "classification":
            return masked_cross_entropy_on_probs(pred, y, mask, num_classes)
        if tcfg.loss == "l1":
            return l1_loss(pred.squeeze(-1), y.to(torch.float32), mask)
        return smooth_l1_loss(pred.squeeze(-1), y.to(torch.float32), mask)

    return loss_fn


def init_model(tcfg: C.TrainerConfig, seed: int, fold: int, device,
               state_dict=None) -> AudioNet:
    """Fold ``fold``'s model on ``device``: torch-default init from a CPU
    generator seeded from ``(seed, fold)``, or ``state_dict`` (e.g.
    :func:`..models.porting.audio_net_state_dict_from_jax` of the JAX
    package's initial params)."""
    gen = torch.Generator().manual_seed(_fold_seed(seed, fold))
    model = AudioNet(tcfg.model, generator=gen)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(device)


def dropout_generator(seed: int, fold: int, device) -> torch.Generator:
    """Fold ``fold``'s dropout stream, on the run's device (a CPU
    generator cannot draw CUDA tensors)."""
    return torch.Generator(device=device).manual_seed(
        _fold_seed(seed + 1000, fold))


def _run_folds(tcfg: C.TrainerConfig, fold_datas, seed: int,
               init_params_per_fold=None):
    """Serial fold loop: init -> :func:`loop.run_fold` -> host summary.
    The device is the fold tensors'.  Returns one ``{"fold", "best",
    "logs", "step_losses"}`` per fold."""
    loss_fn = _branch_fns(tcfg)
    results = []
    for fold, data in enumerate(fold_datas, start=1):
        device = data.train_y.device
        model = init_model(
            tcfg, seed, fold, device,
            None if init_params_per_fold is None
            else init_params_per_fold[fold - 1])
        optimizer = optim.build(tcfg.optimizer, model)
        best, logs, step_losses = loop.run_fold(
            model, optimizer, loss_fn, data, tcfg.track, tcfg.gate,
            tcfg.epochs, dropout_generator(seed, fold, device))
        results.append({"fold": fold, "best": best, "logs": logs,
                        "step_losses": step_losses})
    return results


def _gated(results):
    """Folds whose metric gate fired at least once (the reference only
    torch-saves when the gate passes; a fold with no eligible epoch leaves
    no checkpoint)."""
    return [r for r in results if r["best"]["epoch"] >= 0]


def _save_gated(out_dir, name, r, task: str, seed: int,
                model_cfg: C.RNNConfig, train_idx=None,
                dump_idx: bool = False, extras: dict | None = None):
    """Gated-best save in the JAX package's npz layout with its JSON
    sidecar (task, seed, fold, the fold's train indices), and with
    ``dump_idx`` the winning train-idx artifact
    ``train_idxs_{f1:.2f}_{fold}.npy`` next to it, as the reference writes
    on gate fire (``Classification/audio_gru_whole.py:240``)."""
    meta = {k: v for k, v in r["best"].items() if k != "params"}
    meta.update(task=task, seed=seed, fold=r["fold"])
    if train_idx is not None:
        meta["train_idx"] = [int(i) for i in np.asarray(train_idx)]
    if extras:
        meta.update(extras)
    tree = porting.audio_net_tree_from_state_dict(r["best"]["params"],
                                                  model_cfg)
    saved = checkpoints.save(Path(out_dir) / name, tree, meta)
    if dump_idx and train_idx is not None:
        np.save(saved.parent / "train_idxs_{:.2f}_{}.npy".format(
            r["best"]["f1"], r["fold"]), np.asarray(train_idx))


def _intlist(a):
    return [int(i) for i in np.asarray(a)]


def _features(features, device) -> torch.Tensor:
    """The pristine [N, 3, D] features as a float32 tensor on ``device``
    (default: where a tensor already lies, else the CPU)."""
    if isinstance(features, torch.Tensor):
        return features.to(device if device is not None else
                           features.device, torch.float32)
    return torch.as_tensor(np.asarray(features, np.float32),
                           device=device if device is not None else "cpu")


def _plan_fold_datas(feature_arrays, plans, batch_size):
    """Every fold's tensors from (train_plan, test_plan) pairs, all folds
    padded to the same shapes, as the JAX package pads them."""
    test_total = max(len(te.targets) for _, te in plans)
    train_total = max(len(tr.targets) for tr, _ in plans)
    return [loop.fold_data_from_plans(feature_arrays, tr, te, batch_size,
                                      test_total, train_total)
            for tr, te in plans]


def _clf_fold_datas(feature_arrays, targets, train_folds_idx, batch_size,
                    fold_cfg: C.FoldConfig = C.FoldConfig()):
    dep = np.where(np.asarray(targets) == 1)[0]
    non = np.where(np.asarray(targets) == 0)[0]
    plans = [augment.plan_classification_fold(
        targets, tr_idx, dep, non,
        train_perm_ids=fold_cfg.train_perm_ids,
        test_perm_ids=fold_cfg.test_perm_ids)
        for tr_idx in train_folds_idx]
    return _plan_fold_datas(feature_arrays, plans, batch_size)


def _reg_fold_datas(feature_arrays, targets, dep_idxs, non_idxs, batch_size,
                    fold_cfg: C.FoldConfig = C.FoldConfig()):
    splits = [folds.reg_fold_split(dep_idxs, non_idxs, fold,
                                   fold_cfg.reg_test_dep,
                                   fold_cfg.reg_test_non)
              for fold in range(fold_cfg.n_folds)]
    plans = [augment.plan_regression_fold(
        targets, tr_d, tr_n, te_d, te_n, fold_cfg.reg_augment_first_n)
        for tr_d, tr_n, te_d, te_n in splits]
    return _plan_fold_datas(feature_arrays, plans, batch_size)


def train_audio_clf(features, targets: np.ndarray,
                    train_folds_idx: Sequence[np.ndarray],
                    tcfg: C.TrainerConfig = C.AUDIO_CLF,
                    out_dir: Optional[Path] = None, seed: int = 0,
                    fold_cfg: C.FoldConfig = C.FoldConfig(), device=None,
                    init_params_per_fold=None):
    """3-fold audio GRU classifier.  ``features``: [N, 3, 256], numpy or a
    tensor (trained where it lies unless ``device`` says otherwise)."""
    feats = _features(features, device)
    datas = _clf_fold_datas([feats], np.asarray(targets), train_folds_idx,
                            tcfg.batch_size, fold_cfg)
    results = _run_folds(tcfg, datas, seed, init_params_per_fold)
    if out_dir is not None:
        for r in _gated(results):
            name = checkpoints.audio_clf_name(
                tcfg.model.embedding_size, tcfg.model.hidden_dims,
                r["best"]["f1"], r["fold"])
            _save_gated(out_dir, name, r, "audio_clf", seed, tcfg.model,
                        train_idx=train_folds_idx[r["fold"] - 1],
                        dump_idx=True)
    return results


def train_audio_reg(features, targets: np.ndarray,
                    dep_idxs: np.ndarray, non_idxs: np.ndarray,
                    tcfg: C.TrainerConfig = C.AUDIO_REG,
                    out_dir: Optional[Path] = None, seed: int = 0,
                    fold_cfg: C.FoldConfig = C.FoldConfig(), device=None,
                    init_params_per_fold=None):
    """3-fold audio GRU SDS-score regressor (L1 loss, MAE gating)."""
    feats = _features(features, device)
    datas = _reg_fold_datas([feats], np.asarray(targets), dep_idxs,
                            non_idxs, tcfg.batch_size, fold_cfg)
    results = _run_folds(tcfg, datas, seed, init_params_per_fold)
    if out_dir is not None:
        for r in _gated(results):
            name = checkpoints.audio_reg_name(
                tcfg.model.embedding_size, tcfg.model.hidden_dims,
                r["best"]["mae"])
            _save_gated(Path(out_dir) / f"Audio{r['fold']}", name, r,
                        "audio_reg", seed, tcfg.model,
                        extras={"dep_idxs": _intlist(dep_idxs),
                                "non_idxs": _intlist(non_idxs)})
    return results
