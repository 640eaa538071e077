"""The six track trainers (port of
:mod:`icassp2022_depression_tpu.train.trainers`), each a thin wiring of:
fold recipe -> permutation augmentation plans -> fold tensors gathered on
the device -> :func:`..train.loop.run_fold` per fold -> gated-best
checkpoint on disk.

Reference counterparts:

* audio clf  -- ``Classification/audio_gru_whole.py`` (AdamW lr 6e-6, CE,
  batch 8, 170 epochs, LayerNorm-exempt weight decay)
* text clf   -- ``Classification/text_bilstm_whole.py`` (AdamW lr 1e-5,
  batch 4, 150 epochs)
* fusion clf -- ``Classification/fuse_net_whole.py`` (Adam lr 8e-6, MyLoss,
  batch 2, 100 epochs, branch init, only ``fc_final`` learns; the model
  and its Adam state carry from fold to fold)
* audio reg  -- ``Regression/audio_bilstm_perm.py`` (Adam lr 1e-5, L1,
  batch 2, 120 epochs)
* text reg   -- ``Regression/text_bilstm_perm.py`` (Adam lr 1e-5,
  SmoothL1, batch 2, 110 epochs)
* fusion reg -- ``Regression/fuse_net.py`` (Adam lr 8e-5, SmoothL1 MyLoss,
  batch 4, 150 epochs, every fold fresh)

Per fold, the initial weights come from a CPU ``torch.Generator`` seeded
from ``(seed, fold)`` (the clf fusion's one model from ``seed``), so a run
on the card and one on the CPU start from the same weights; the dropout
masks come from a generator on the run's device seeded from
``(seed + 1000, fold)``.  Both streams differ from the JAX package's
threefry streams: parity runs carry weights across
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
from icassp2022_depression_tpu_torch.models import losses, porting
from icassp2022_depression_tpu_torch.models.audio_net import AudioNet
from icassp2022_depression_tpu_torch.models.fusion import FusionNet
from icassp2022_depression_tpu_torch.models.text_net import TextNet
from icassp2022_depression_tpu_torch.ops.nn import (
    l1_loss,
    masked_cross_entropy_on_probs,
    smooth_l1_loss,
)
from icassp2022_depression_tpu_torch.train import checkpoints, loop, optim
from icassp2022_depression_tpu_torch.utils.device import resolve_device


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


#: the branch models by recurrent cell: the recipes' audio branch is the
#: GRU model, their text branch the BiLSTM one
_NETS = {"gru": AudioNet, "lstm": TextNet}
_TREES = {"gru": porting.audio_net_tree_from_state_dict,
          "lstm": porting.text_net_tree_from_state_dict}


def init_model(tcfg: C.TrainerConfig, seed: int, fold: int, device,
               state_dict=None):
    """Fold ``fold``'s branch model (:class:`AudioNet` for a GRU config,
    :class:`TextNet` for an LSTM one) on ``device``: its init drawn from a
    CPU generator seeded from ``(seed, fold)``, or ``state_dict`` (e.g.
    :func:`..models.porting.audio_net_state_dict_from_jax` of the JAX
    package's initial params)."""
    gen = torch.Generator().manual_seed(_fold_seed(seed, fold))
    model = _NETS[tcfg.model.cell](tcfg.model, generator=gen)
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
    """Serial fold loop of a branch trainer: init -> :func:`loop.run_fold`
    -> host summary.  The device is the fold tensors'.  Returns one
    ``{"fold", "best", "logs", "step_losses"}`` per fold."""
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
            model, optimizer, *loop.model_fns(model, loss_fn), data,
            tcfg.track, tcfg.gate, tcfg.epochs,
            dropout_generator(seed, fold, device))
        results.append({"fold": fold, "best": best, "logs": logs,
                        "step_losses": step_losses})
    return results


def _gated(results):
    """Folds whose metric gate fired at least once (the reference only
    torch-saves when the gate passes; a fold with no eligible epoch leaves
    no checkpoint)."""
    return [r for r in results if r["best"]["epoch"] >= 0]


def _save_gated(out_dir, name, r, task: str, seed: int, tree: dict,
                train_idx=None, dump_idx: bool = False,
                extras: dict | None = None):
    """Gated-best save of ``tree`` (the JAX package's param tree of
    ``r``'s gated state dict) in its npz layout with its JSON sidecar
    (task, seed, fold, the fold's train indices, ``extras``), and with
    ``dump_idx`` the winning train-idx artifact
    ``train_idxs_{f1:.2f}_{fold}.npy`` next to it, as the reference writes
    on gate fire (``Classification/audio_gru_whole.py:240``)."""
    meta = {k: v for k, v in r["best"].items() if k != "params"}
    meta.update(task=task, seed=seed, fold=r["fold"])
    if train_idx is not None:
        meta["train_idx"] = [int(i) for i in np.asarray(train_idx)]
    if extras:
        meta.update(extras)
    saved = checkpoints.save(Path(out_dir) / name, tree, meta)
    if dump_idx and train_idx is not None:
        np.save(saved.parent / "train_idxs_{:.2f}_{}.npy".format(
            r["best"]["f1"], r["fold"]), np.asarray(train_idx))


def _branch_tree(r, tcfg: C.TrainerConfig) -> dict:
    return _TREES[tcfg.model.cell](r["best"]["params"], tcfg.model)


def _intlist(a):
    return [int(i) for i in np.asarray(a)]


def _features(features, device) -> torch.Tensor:
    """The pristine [N, 3, D] features as a float32 tensor on ``device``
    (None: where a tensor already lies, else the first card, raising
    without one: :func:`..utils.device.resolve_device`)."""
    if isinstance(features, torch.Tensor):
        return features.to(device if device is not None else
                           features.device, torch.float32)
    return torch.as_tensor(np.asarray(features, np.float32),
                           device=resolve_device(device))


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


def _clf_branch(task: str, features, targets, train_folds_idx, tcfg,
                out_dir, seed, fold_cfg, device, init_params_per_fold,
                meta_extras=None):
    """A classification branch trainer: folds, training, gated saves."""
    feats = _features(features, device)
    datas = _clf_fold_datas([feats], np.asarray(targets), train_folds_idx,
                            tcfg.batch_size, fold_cfg)
    results = _run_folds(tcfg, datas, seed, init_params_per_fold)
    if out_dir is not None:
        m = tcfg.model
        for r in _gated(results):
            f1, fold = r["best"]["f1"], r["fold"]
            name = (checkpoints.audio_clf_name(m.embedding_size,
                                               m.hidden_dims, f1, fold)
                    if task == "audio_clf"
                    else checkpoints.text_clf_name(m.hidden_dims, f1, fold))
            _save_gated(out_dir, name, r, task, seed, _branch_tree(r, tcfg),
                        train_idx=train_folds_idx[fold - 1], dump_idx=True,
                        extras=meta_extras)
    return results


def _reg_branch(task: str, features, targets, dep_idxs, non_idxs, tcfg,
                out_dir, seed, fold_cfg, device, init_params_per_fold,
                meta_extras=None):
    """A regression branch trainer: folds, training, gated saves."""
    feats = _features(features, device)
    datas = _reg_fold_datas([feats], np.asarray(targets), dep_idxs,
                            non_idxs, tcfg.batch_size, fold_cfg)
    results = _run_folds(tcfg, datas, seed, init_params_per_fold)
    if out_dir is not None:
        m = tcfg.model
        for r in _gated(results):
            mae = r["best"]["mae"]
            if task == "audio_reg":
                name = checkpoints.audio_reg_name(m.embedding_size,
                                                  m.hidden_dims, mae)
                sub = f"Audio{r['fold']}"
            else:
                name = checkpoints.text_reg_name(m.hidden_dims, mae)
                sub = f"Text{r['fold']}"
            _save_gated(Path(out_dir) / sub, name, r, task, seed,
                        _branch_tree(r, tcfg),
                        extras={"dep_idxs": _intlist(dep_idxs),
                                "non_idxs": _intlist(non_idxs),
                                **(meta_extras or {})})
    return results


def train_audio_clf(features, targets: np.ndarray,
                    train_folds_idx: Sequence[np.ndarray],
                    tcfg: C.TrainerConfig = C.AUDIO_CLF,
                    out_dir: Optional[Path] = None, seed: int = 0,
                    fold_cfg: C.FoldConfig = C.FoldConfig(), device=None,
                    init_params_per_fold=None):
    """3-fold audio GRU classifier.  ``features``: [N, 3, 256], numpy or a
    tensor (trained where it lies unless ``device`` says otherwise; numpy
    features with ``device`` None go to the first card)."""
    return _clf_branch("audio_clf", features, targets, train_folds_idx,
                       tcfg, out_dir, seed, fold_cfg, device,
                       init_params_per_fold)


def train_text_clf(features, targets: np.ndarray,
                   train_folds_idx: Sequence[np.ndarray],
                   tcfg: C.TrainerConfig = C.TEXT_CLF,
                   out_dir: Optional[Path] = None, seed: int = 0,
                   fold_cfg: C.FoldConfig = C.FoldConfig(), device=None,
                   init_params_per_fold=None,
                   meta_extras: dict | None = None):
    """3-fold text BiLSTM classifier.  ``features``: [N, 3, 1024];
    ``meta_extras`` (the text embedder's provenance) goes into every
    checkpoint sidecar."""
    return _clf_branch("text_clf", features, targets, train_folds_idx,
                       tcfg, out_dir, seed, fold_cfg, device,
                       init_params_per_fold, meta_extras)


def train_audio_reg(features, targets: np.ndarray,
                    dep_idxs: np.ndarray, non_idxs: np.ndarray,
                    tcfg: C.TrainerConfig = C.AUDIO_REG,
                    out_dir: Optional[Path] = None, seed: int = 0,
                    fold_cfg: C.FoldConfig = C.FoldConfig(), device=None,
                    init_params_per_fold=None):
    """3-fold audio GRU SDS-score regressor (L1 loss, MAE gating).  Pass
    the same ``fold_cfg`` here and to :func:`train_fuse_reg`, which
    re-derives these splits."""
    return _reg_branch("audio_reg", features, targets, dep_idxs, non_idxs,
                       tcfg, out_dir, seed, fold_cfg, device,
                       init_params_per_fold)


def train_text_reg(features, targets: np.ndarray,
                   dep_idxs: np.ndarray, non_idxs: np.ndarray,
                   tcfg: C.TrainerConfig = C.TEXT_REG,
                   out_dir: Optional[Path] = None, seed: int = 0,
                   fold_cfg: C.FoldConfig = C.FoldConfig(), device=None,
                   init_params_per_fold=None,
                   meta_extras: dict | None = None):
    """As :func:`train_audio_reg` for the text BiLSTM (SmoothL1)."""
    return _reg_branch("text_reg", features, targets, dep_idxs, non_idxs,
                       tcfg, out_dir, seed, fold_cfg, device,
                       init_params_per_fold, meta_extras)


# -- fusion -------------------------------------------------------------------


def _fusion_fns(model: FusionNet, tcfg: C.TrainerConfig):
    """:func:`loop.run_fold`'s ``(train_loss, eval_fn)`` of the fusion
    (``trainers.py:553-577`` in the JAX package): MyLoss on the frozen
    branch features and ``fc_final``'s weight, the prediction of the head
    on their concatenation; the eval is only the head, over the test
    split's branch features computed once per fold."""
    cfg = model.cfg
    myloss = (losses.myloss_ce if tcfg.track == "classification"
              else losses.myloss_smooth_l1)

    def train_loss(xs, y, mask, generator):
        tf, af = model.pretrained_feature(xs[0], xs[1], generator)
        loss = myloss(tf, af, y, model.fc_final[0].weight,
                      cfg.text_hidden_dims, mask)
        return loss, model(torch.cat([tf, af], dim=-1))

    def eval_fn(xs):
        return model(xs[0])

    return train_loss, eval_fn


def _run_fusion_folds(fcfg: C.FusionConfig, tcfg: C.TrainerConfig,
                      fold_datas, branch_params, seed: int,
                      init_params_per_fold=None):
    """Fold loop of the fusion trainers, with the reference's cross-fold
    state:

    * classification (``fuse_net_whole.py:413-416``): the fusion net and
      its Adam optimizer are made once, from ``seed``; each fold only
      replaces the branch tensors, so fold k+1 continues from fold k's
      trained ``fc_final`` and Adam moments (only the first entry of
      ``init_params_per_fold`` is read);
    * regression (``Regression/fuse_net.py:549-552``): model and optimizer
      are made afresh for every fold, from ``(seed, fold)``.

    ``branch_params[fold - 1]`` is the (text, audio) pair of branch state
    dicts.  Only ``fc_final.0.weight`` may receive a gradient: a branch
    parameter that gets one raises."""
    carry = tcfg.track == "classification"
    model = optimizer = None
    results = []
    for fold, data in enumerate(fold_datas, start=1):
        device = data.train_y.device
        if model is None or not carry:
            gen = torch.Generator().manual_seed(
                seed if carry else _fold_seed(seed, fold))
            model = FusionNet(fcfg, generator=gen)
            if init_params_per_fold is not None:
                model.load_state_dict(init_params_per_fold[fold - 1],
                                      strict=True)
            model = model.to(device)
            optimizer = optim.build(tcfg.optimizer, model)
        text_sd, audio_sd = branch_params[fold - 1]
        model.init_from_branches(text_sd, audio_sd, tcfg.track)
        # the branches never train, so the test split's features are the
        # same every epoch: computed once, the per-epoch eval is the head
        model.eval()
        tf, af = model.pretrained_feature(*data.test_x)
        data = data._replace(test_x=(torch.cat([tf, af], dim=-1),))
        best, logs, step_losses = loop.run_fold(
            model, optimizer, *_fusion_fns(model, tcfg), data, tcfg.track,
            tcfg.gate, tcfg.epochs, dropout_generator(seed, fold, device))
        stray = [n for n, p in model.named_parameters()
                 if p.grad is not None and n != "fc_final.0.weight"]
        if stray:
            raise RuntimeError(f"fusion fold {fold}: frozen parameters "
                               f"received gradients: {stray}")
        results.append({"fold": fold, "best": best, "logs": logs,
                        "step_losses": step_losses})
    return results


def train_fuse_clf(audio_features, text_features, targets: np.ndarray,
                   train_folds_idx: Sequence[np.ndarray],
                   branch_params: Sequence[tuple],
                   fcfg: C.FusionConfig = C.FUSE_CLF,
                   tcfg: C.TrainerConfig = C.FUSE_CLF_TRAINER,
                   out_dir: Optional[Path] = None, seed: int = 0,
                   fold_cfg: C.FoldConfig = C.FoldConfig(), device=None,
                   init_params_per_fold=None,
                   meta_extras: dict | None = None):
    """3-fold multimodal fusion classifier.  ``branch_params[fold]`` is the
    (text, audio) pair of gated branch state dicts from
    :func:`train_text_clf` / :func:`train_audio_clf` (the reference's
    state-dict surgery); ``init_params_per_fold[0]``, when given, is the
    fusion's initial state dict."""
    xa = _features(audio_features, device)
    feats = [xa, _features(text_features, xa.device)]
    datas = _clf_fold_datas(feats, np.asarray(targets), train_folds_idx,
                            tcfg.batch_size, fold_cfg)
    results = _run_fusion_folds(fcfg, tcfg, datas, branch_params, seed,
                                init_params_per_fold)
    if out_dir is not None:
        for r in _gated(results):
            name = checkpoints.fuse_clf_name(r["best"]["f1"], r["fold"])
            _save_gated(out_dir, name, r, "fuse_clf", seed,
                        porting.fusion_tree_from_state_dict(
                            r["best"]["params"], fcfg),
                        train_idx=train_folds_idx[r["fold"] - 1],
                        dump_idx=True, extras=meta_extras)
    return results


def train_fuse_reg(audio_features, text_features, targets: np.ndarray,
                   dep_idxs: np.ndarray, non_idxs: np.ndarray,
                   branch_params: Sequence[tuple],
                   fcfg: C.FusionConfig = C.FUSE_REG,
                   tcfg: C.TrainerConfig = C.FUSE_REG_TRAINER,
                   out_dir: Optional[Path] = None, seed: int = 0,
                   fold_cfg: C.FoldConfig = C.FoldConfig(), device=None,
                   init_params_per_fold=None,
                   meta_extras: dict | None = None):
    """3-fold multimodal fusion SDS regressor (SmoothL1 MyLoss, MAE
    gating); arguments as :func:`train_fuse_clf`, folds as
    :func:`train_audio_reg` (pass the branches' ``fold_cfg``)."""
    xa = _features(audio_features, device)
    feats = [xa, _features(text_features, xa.device)]
    datas = _reg_fold_datas(feats, np.asarray(targets), dep_idxs, non_idxs,
                            tcfg.batch_size, fold_cfg)
    results = _run_fusion_folds(fcfg, tcfg, datas, branch_params, seed,
                                init_params_per_fold)
    if out_dir is not None:
        for r in _gated(results):
            _save_gated(Path(out_dir) / f"Fuse{r['fold']}",
                        checkpoints.fuse_reg_name(r["best"]["mae"]), r,
                        "fuse_reg", seed,
                        porting.fusion_tree_from_state_dict(
                            r["best"]["params"], fcfg),
                        extras={"dep_idxs": _intlist(dep_idxs),
                                "non_idxs": _intlist(non_idxs),
                                **(meta_extras or {})})
    return results
