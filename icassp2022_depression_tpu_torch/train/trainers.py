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

Per fold, the initial weights come from the threefry key
``fold_in(PRNGKey(seed), fold)`` (the clf fusion's one model from
``PRNGKey(seed)``) and the dropout masks from ``fold_in(PRNGKey(seed +
1000), fold)`` split once a batch, as in the JAX package
(``trainers.py:404-405``, ``loop.py:203-206``): the same seed gives the
JAX package's initial weights and dropout masks bit for bit, on the CPU
and on a card.

A fold runs as one :class:`..train.loop.FoldRun` (one CUDA graph an
epoch on a card), optionally in chunks of epochs with a resume bundle
committed after each (``resume_dir`` / ``chunk_epochs``, JAX
``_execute_fold``); with ``vmap_folds`` the three folds run as one
stacked program (JAX ``_vmapped_fold_results``; the reg fusion only, as
there: the clf fusion chains its folds).  ``fold_parallel`` runs that
stacked program with its fold axis over the ranks of a
``torch.distributed`` group, one fold a rank (JAX ``fold_mesh``), and
``data_parallel`` N more splits each fold's batch over N ranks (JAX
``fold_data_mesh``): every rank of the group calls the trainer, and every
rank gets every fold's results (:mod:`..parallel.distributed`).
"""

from __future__ import annotations

import sys
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
from icassp2022_depression_tpu_torch.models import folds as mfolds
from icassp2022_depression_tpu_torch.ops import prng
from icassp2022_depression_tpu_torch.ops.nn import (
    l1_loss,
    masked_cross_entropy_on_probs,
    smooth_l1_loss,
)
from icassp2022_depression_tpu_torch.parallel import distributed
from icassp2022_depression_tpu_torch.train import checkpoints, loop, optim
from icassp2022_depression_tpu_torch.utils.device import resolve_device


def init_key(seed: int, fold: int) -> torch.Tensor:
    """Fold ``fold``'s init key, ``fold_in(PRNGKey(seed), fold)``."""
    return prng.fold_in(prng.prng_key(seed), fold)


def dropout_key(seed: int, fold: int, device=None) -> torch.Tensor:
    """Fold ``fold``'s dropout key, ``fold_in(PRNGKey(seed + 1000),
    fold)``, on ``device``."""
    return prng.fold_in(prng.prng_key(seed + 1000), fold).to(device)


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
    :class:`TextNet` for an LSTM one) on ``device``: its init drawn from
    :func:`init_key` (the JAX package's weights), or ``state_dict`` (e.g.
    :func:`..models.porting.audio_net_state_dict_from_jax` of the JAX
    package's initial params)."""
    model = _NETS[tcfg.model.cell](
        tcfg.model, None if state_dict is not None else init_key(seed, fold))
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(device)


def _bundle_arrays(run: loop.FoldRun) -> dict:
    """A fold run's state as flat host arrays: params, optimizer state,
    key, gated best and ``epoch_done``."""
    out = {f"params/{k}": v for k, v in run.model.state_dict().items()}
    out.update({f"opt/{k}": v for k, v in
                optim.state_arrays(run.optimizer).items()})
    out.update({f"best/{k}": v for k, v in run.best.items()
                if k != "params"})
    out.update({f"best_params/{k}": v
                for k, v in run.best["params"].items()})
    if run.key is not None:
        out["key"] = run.key
    out = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
               else v) for k, v in out.items()}
    out["epoch_done"] = np.asarray(run.epoch_done, np.int64)
    return out


def _logs_arrays(run: loop.FoldRun) -> dict:
    """The epochs run so far: one array per log metric (epoch axis after
    the fold axis, when stacked) and ``step_losses``."""
    e = run.epoch_done
    keys = loop.CLF_LOGS if run.clf else loop.REG_LOGS
    logs = run.logs.narrow(-2, 0, e).cpu().numpy()
    out = {k: logs[..., i] for i, k in enumerate(keys)}
    out["step_losses"] = run.step_losses.narrow(-2, 0, e).cpu().numpy()
    return out


def _load_bundle(run: loop.FoldRun, state_path: Path, logs_path: Path,
                 folds: Optional[slice] = None) -> None:
    """Resume ``run`` from a bundle: every tensor back in place, and the
    logs sidecar truncated to ``epoch_done`` (the bundle is the commit
    point: a sidecar written after it may run ahead).  ``folds``: a
    fold-parallel rank's folds of a stacked bundle."""
    def mine(a):
        return a if folds is None else a[folds]

    with np.load(state_path) as z:
        arrays = {k: z[k] if k == "epoch_done" else mine(z[k])
                  for k in z.files}

    def put(dst: torch.Tensor, a) -> None:
        dst.copy_(torch.from_numpy(np.asarray(a)))

    with torch.no_grad():
        for k, v in run.model.state_dict().items():
            put(v, arrays[f"params/{k}"])
        optim.load_state_arrays(run.optimizer, {
            k[len("opt/"):]: v for k, v in arrays.items()
            if k.startswith("opt/")})
        for k, v in run.best.items():
            if k != "params":
                put(v, arrays[f"best/{k}"])
        for k, v in run.best["params"].items():
            put(v, arrays[f"best_params/{k}"])
        if run.key is not None:
            put(run.key, arrays["key"])
        e = int(arrays["epoch_done"])
        run.epoch_done = e
        run.epoch_at.fill_(e)
        if logs_path.exists():
            keys = loop.CLF_LOGS if run.clf else loop.REG_LOGS
            at = run.logs.dim() - 2
            with np.load(logs_path) as z:
                for i, k in enumerate(keys):
                    rows = torch.from_numpy(mine(z[k])).narrow(at, 0, e)
                    run.logs.select(-1, i).narrow(at, 0, e).copy_(rows)
                run.step_losses.narrow(at, 0, e).copy_(
                    torch.from_numpy(mine(z["step_losses"]))
                    .narrow(at, 0, e))


def _execute_fold(run: loop.FoldRun, chunk_epochs: Optional[int] = None,
                  resume_path: Optional[Path] = None,
                  mesh: Optional[distributed.FoldMesh] = None):
    """Run a fold to its end, in chunks of ``chunk_epochs`` epochs (each
    chunk is that many replays of the fold's graph) with a resume bundle
    ``<resume_path>.npz`` (+ ``_logs.npz``, written first, both atomic)
    committed after each, as JAX ``_execute_fold`` does: a run that finds
    a bundle continues from it, and a completed one only reads it back.
    On a fold-parallel rank (``mesh``) the bundle is the stacked run's:
    every rank loads its folds of it, and rank 0 writes it after
    gathering the folds.  Returns :meth:`..loop.FoldRun.results`."""
    total = run.n_epochs
    folds = None if mesh is None else mesh.folds
    if resume_path is not None:
        state_path = Path(str(resume_path) + ".npz")
        logs_path = Path(str(resume_path) + "_logs.npz")
        if state_path.exists():
            _load_bundle(run, state_path, logs_path, folds)
    chunk = chunk_epochs or total
    while run.epoch_done < total:
        n = min(chunk, total - run.epoch_done)
        if resume_path is not None:
            print(f"# chunk starting: {Path(resume_path).name} "
                  f"epochs {run.epoch_done}->{run.epoch_done + n}/{total}",
                  file=sys.stderr, flush=True)
        run.run(n)
        if resume_path is not None:
            logs, state = _logs_arrays(run), _bundle_arrays(run)
            if mesh is not None:
                logs = distributed.gather_folds(mesh, logs)
                state = distributed.gather_folds(mesh, state)
            if distributed.is_main():
                checkpoints.atomic_savez(logs_path, **logs)
                checkpoints.atomic_savez(state_path, **state)
            print(f"# chunk committed: {Path(resume_path).name} "
                  f"epochs {run.epoch_done}/{total}",
                  file=sys.stderr, flush=True)
    return run.results()


def _resume_path(resume_dir, name: str) -> Optional[Path]:
    return Path(resume_dir) / name if resume_dir is not None else None


_DP_WITHOUT_FOLDS = (
    "data_parallel shards each fold's batch over that fold's device group "
    "and therefore requires fold_parallel=True (otherwise it would be "
    "silently ignored)")


def _run_folds(tcfg: C.TrainerConfig, fold_datas, seed: int,
               init_params_per_fold=None, resume_dir=None,
               chunk_epochs=None, task_name: str = "task",
               vmap_folds: bool = False, fold_parallel: bool = False,
               data_parallel: int = 1):
    """Fold loop of a branch trainer: init -> one :class:`loop.FoldRun` a
    fold (or one for all folds, stacked, with ``vmap_folds`` or
    ``fold_parallel``) -> host summary.  The device is the fold tensors'.
    Returns one ``{"fold", "best", "logs", "step_losses"}`` per fold."""
    if data_parallel > 1 and not fold_parallel:
        raise ValueError(_DP_WITHOUT_FOLDS)
    loss_fn = _branch_fns(tcfg)

    def model(fold: int, device):
        return init_model(tcfg, seed, fold, device,
                          None if init_params_per_fold is None
                          else init_params_per_fold[fold - 1])

    if vmap_folds or fold_parallel:
        return _vmapped_results(
            tcfg, fold_datas, seed,
            lambda f, data: (model(f, data.train_y.device), data),
            lambda m: loop.model_fns(m, loss_fn), resume_dir, chunk_epochs,
            task_name, fold_parallel, data_parallel)
    results = []
    for fold, data in enumerate(fold_datas, start=1):
        device = data.train_y.device
        net = model(fold, device)
        optimizer = optim.build(tcfg.optimizer, net)
        run = loop.FoldRun(net, optimizer, *loop.model_fns(net, loss_fn),
                           data, tcfg.track, tcfg.gate, tcfg.epochs - 1,
                           dropout_key(seed, fold, device))
        best, logs, step_losses = _execute_fold(
            run, chunk_epochs, _resume_path(resume_dir,
                                            f"{task_name}_fold{fold}"))
        results.append({"fold": fold, "best": best, "logs": logs,
                        "step_losses": step_losses})
    return results


def _on_host(out) -> tuple:
    """A fold's ``(best, logs, step_losses)`` with its gated params on the
    host, to be gathered."""
    best, logs, step_losses = out
    best = dict(best, params={k: v.detach().cpu()
                              for k, v in best["params"].items()})
    return best, logs, step_losses


def _vmapped_results(tcfg: C.TrainerConfig, fold_datas, seed: int, build,
                     make_fns, resume_dir=None, chunk_epochs=None,
                     task_name: str = "task", fold_parallel: bool = False,
                     data_parallel: int = 1):
    """All folds as one stacked program (JAX ``_vmapped_fold_results``):
    ``build(fold, data) -> (model, data)`` for each fold, the models
    stacked (:func:`..models.folds.stack`), the fold tensors stacked, one
    dropout key per fold (the serial path's), a
    :class:`..optim.StackedAdam`, and one ``{task_name}_folds`` resume
    bundle.  ``make_fns(stacked_model)`` gives ``(train_loss,
    eval_fn)``.

    ``fold_parallel``: the default group's ranks share the folds (JAX
    ``fold_mesh``): each rank builds and runs the stacked program of its
    folds over the steps of all folds, and the results are gathered onto
    every rank.  ``data_parallel`` N (JAX ``fold_data_mesh``): N ranks a
    fold, each with its rows of every batch (:class:`..loop.FoldRun`'s
    ``data_group``), eager on Gloo and in the epoch's CUDA graph on
    NCCL."""
    n_folds = len(fold_datas)
    device = fold_datas[0].train_y.device
    mesh, folds = None, range(1, n_folds + 1)
    if fold_parallel:
        mesh = distributed.fold_data_mesh(n_folds, data_parallel)
        folds = folds[mesh.folds]
    models, datas = zip(*(build(f, fold_datas[f - 1]) for f in folds))
    stacked = mfolds.stack(models)
    optimizer = optim.build_stacked(tcfg.optimizer, stacked)
    keys = torch.stack([dropout_key(seed, f, device) for f in folds])
    data = loop.stack_fold_data(datas)
    group = None
    if mesh is not None and data_parallel > 1:
        data = distributed.shard_batch_rows(mesh, data)
        group = mesh.data_group
    batch = data.train_y.shape[-1]
    run = loop.FoldRun(stacked, optimizer, *make_fns(stacked), data,
                       tcfg.track, tcfg.gate, tcfg.epochs - 1, keys,
                       n_steps=max(-(-d.n_train // batch)
                                   for d in fold_datas),
                       data_group=group)
    if mesh is not None:
        print(f"# {task_name}: rank {distributed.rank()} of "
              f"{distributed.world_size()} trains fold(s) {list(folds)} as "
              f"data rank {mesh.data_rank} of {data_parallel} on {device}, "
              + ("epochs as one CUDA graph" if run.graph else "eager epochs")
              + (f" ({torch.distributed.get_backend(group)} data group)"
                 if group is not None else ""),
              file=sys.stderr, flush=True)
    outs = _execute_fold(run, chunk_epochs,
                         _resume_path(resume_dir, f"{task_name}_folds"),
                         mesh)
    if mesh is not None:
        outs = distributed.gather_folds(mesh, [_on_host(o) for o in outs])
        for best, _, _ in outs:
            best["params"] = {k: v.to(device)
                              for k, v in best["params"].items()}
    return [{"fold": f, "best": best, "logs": logs,
             "step_losses": step_losses}
            for f, (best, logs, step_losses) in enumerate(outs, start=1)]


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
    on gate fire (``Classification/audio_gru_whole.py:240``).  In a group
    of ranks only rank 0 writes."""
    if not distributed.is_main():
        return
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
                meta_extras=None, **run_kw):
    """A classification branch trainer: folds, training, gated saves."""
    feats = _features(features, device)
    datas = _clf_fold_datas([feats], np.asarray(targets), train_folds_idx,
                            tcfg.batch_size, fold_cfg)
    results = _run_folds(tcfg, datas, seed, init_params_per_fold,
                         task_name=task, **run_kw)
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
                meta_extras=None, **run_kw):
    """A regression branch trainer: folds, training, gated saves."""
    feats = _features(features, device)
    datas = _reg_fold_datas([feats], np.asarray(targets), dep_idxs,
                            non_idxs, tcfg.batch_size, fold_cfg)
    results = _run_folds(tcfg, datas, seed, init_params_per_fold,
                         task_name=task, **run_kw)
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
                    init_params_per_fold=None, resume_dir=None,
                    chunk_epochs=None, vmap_folds: bool = False,
                    fold_parallel: bool = False, data_parallel: int = 1):
    """3-fold audio GRU classifier.  ``features``: [N, 3, 256], numpy or a
    tensor (trained where it lies unless ``device`` says otherwise; numpy
    features with ``device`` None go to the first card, or a launched
    rank's card).
    ``resume_dir`` / ``chunk_epochs`` run each fold in chunks with a
    resume bundle, ``vmap_folds`` runs the folds as one stacked
    program, ``fold_parallel`` / ``data_parallel`` run it over the ranks
    of the default group (every rank calls the trainer)."""
    return _clf_branch("audio_clf", features, targets, train_folds_idx,
                       tcfg, out_dir, seed, fold_cfg, device,
                       init_params_per_fold,
                       resume_dir=resume_dir, chunk_epochs=chunk_epochs,
                       vmap_folds=vmap_folds, fold_parallel=fold_parallel,
                       data_parallel=data_parallel)


def train_text_clf(features, targets: np.ndarray,
                   train_folds_idx: Sequence[np.ndarray],
                   tcfg: C.TrainerConfig = C.TEXT_CLF,
                   out_dir: Optional[Path] = None, seed: int = 0,
                   fold_cfg: C.FoldConfig = C.FoldConfig(), device=None,
                   init_params_per_fold=None, resume_dir=None,
                   chunk_epochs=None, vmap_folds: bool = False,
                   meta_extras: dict | None = None,
                   fold_parallel: bool = False, data_parallel: int = 1):
    """3-fold text BiLSTM classifier.  ``features``: [N, 3, 1024];
    ``meta_extras`` (the text embedder's provenance) goes into every
    checkpoint sidecar; the fold options as :func:`train_audio_clf`."""
    return _clf_branch("text_clf", features, targets, train_folds_idx,
                       tcfg, out_dir, seed, fold_cfg, device,
                       init_params_per_fold, meta_extras,
                       resume_dir=resume_dir, chunk_epochs=chunk_epochs,
                       vmap_folds=vmap_folds, fold_parallel=fold_parallel,
                       data_parallel=data_parallel)


def train_audio_reg(features, targets: np.ndarray,
                    dep_idxs: np.ndarray, non_idxs: np.ndarray,
                    tcfg: C.TrainerConfig = C.AUDIO_REG,
                    out_dir: Optional[Path] = None, seed: int = 0,
                    fold_cfg: C.FoldConfig = C.FoldConfig(), device=None,
                    init_params_per_fold=None, resume_dir=None,
                    chunk_epochs=None, vmap_folds: bool = False,
                    fold_parallel: bool = False, data_parallel: int = 1):
    """3-fold audio GRU SDS-score regressor (L1 loss, MAE gating).  Pass
    the same ``fold_cfg`` here and to :func:`train_fuse_reg`, which
    re-derives these splits.  The fold options as
    :func:`train_audio_clf`."""
    return _reg_branch("audio_reg", features, targets, dep_idxs, non_idxs,
                       tcfg, out_dir, seed, fold_cfg, device,
                       init_params_per_fold,
                       resume_dir=resume_dir, chunk_epochs=chunk_epochs,
                       vmap_folds=vmap_folds, fold_parallel=fold_parallel,
                       data_parallel=data_parallel)


def train_text_reg(features, targets: np.ndarray,
                   dep_idxs: np.ndarray, non_idxs: np.ndarray,
                   tcfg: C.TrainerConfig = C.TEXT_REG,
                   out_dir: Optional[Path] = None, seed: int = 0,
                   fold_cfg: C.FoldConfig = C.FoldConfig(), device=None,
                   init_params_per_fold=None, resume_dir=None,
                   chunk_epochs=None, vmap_folds: bool = False,
                   meta_extras: dict | None = None,
                   fold_parallel: bool = False, data_parallel: int = 1):
    """As :func:`train_audio_reg` for the text BiLSTM (SmoothL1)."""
    return _reg_branch("text_reg", features, targets, dep_idxs, non_idxs,
                       tcfg, out_dir, seed, fold_cfg, device,
                       init_params_per_fold, meta_extras,
                       resume_dir=resume_dir, chunk_epochs=chunk_epochs,
                       vmap_folds=vmap_folds, fold_parallel=fold_parallel,
                       data_parallel=data_parallel)


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

    def train_loss(xs, y, mask, key, rows=None):
        tf, af = model.pretrained_feature(xs[0], xs[1], key, rows)
        loss = myloss(tf, af, y, model.fc_final[0].weight,
                      cfg.text_hidden_dims, mask)
        return loss, model(torch.cat([tf, af], dim=-1))

    def eval_fn(xs):
        return model(xs[0])

    return train_loss, eval_fn


def _fusion_model(fcfg: C.FusionConfig, key, init_sd, device) -> FusionNet:
    model = FusionNet(fcfg, None if init_sd is not None else key)
    if init_sd is not None:
        model.load_state_dict(init_sd, strict=True)
    return model.to(device)


def _head_test_split(model: FusionNet, data: loop.FoldData) -> loop.FoldData:
    """The branches never train, so the test split's features are the
    same every epoch: computed once, the per-epoch eval is the head."""
    model.eval()
    tf, af = model.pretrained_feature(*data.test_x)
    return data._replace(test_x=(torch.cat([tf, af], dim=-1),))


def _check_frozen(model: FusionNet, fold) -> None:
    stray = [n for n, p in model.named_parameters()
             if p.grad is not None and n != "fc_final.0.weight"]
    if stray:
        raise RuntimeError(f"fusion fold {fold}: frozen parameters "
                           f"received gradients: {stray}")


def _run_fusion_folds(fcfg: C.FusionConfig, tcfg: C.TrainerConfig,
                      fold_datas, branch_params, seed: int,
                      init_params_per_fold=None, resume_dir=None,
                      chunk_epochs=None, task_name: str = "fuse",
                      vmap_folds: bool = False, fold_parallel: bool = False,
                      data_parallel: int = 1):
    """Fold loop of the fusion trainers, with the reference's cross-fold
    state:

    * classification (``fuse_net_whole.py:413-416``): the fusion net and
      its Adam optimizer are made once, from ``PRNGKey(seed)``; each fold
      only replaces the branch tensors, so fold k+1 continues from fold k's
      trained ``fc_final`` and Adam moments (only the first entry of
      ``init_params_per_fold`` is read); one graph per fold over the
      carried state;
    * regression (``Regression/fuse_net.py:549-552``): model and optimizer
      are made afresh for every fold, from :func:`init_key`; with
      ``vmap_folds`` the folds run as one stacked program, with
      ``fold_parallel`` (and ``data_parallel``) over the ranks of the
      default group.

    ``branch_params[fold - 1]`` is the (text, audio) pair of branch state
    dicts.  Only ``fc_final.0.weight`` may receive a gradient: a branch
    parameter that gets one raises."""
    carry = tcfg.track == "classification"
    if (vmap_folds or fold_parallel) and carry:
        raise ValueError(
            "fold vectorisation is impossible for the clf fusion trainer: "
            "the reference chains folds sequentially -- fold k+1 starts "
            "from fold k's trained fc_final weights and accumulated Adam "
            "moments (fuse_net_whole.py:413-416) -- so fold programs "
            "cannot run concurrently")
    if data_parallel > 1 and not fold_parallel:
        raise ValueError(_DP_WITHOUT_FOLDS)

    def fresh(fold: int, device) -> FusionNet:
        model = _fusion_model(
            fcfg, prng.prng_key(seed) if carry else init_key(seed, fold),
            None if init_params_per_fold is None
            else init_params_per_fold[fold - 1], device)
        model.init_from_branches(*branch_params[fold - 1], tcfg.track)
        return model

    if vmap_folds or fold_parallel:
        models = []

        def build(fold, data):
            model = fresh(fold, data.train_y.device)
            models.append(model)
            return model, _head_test_split(model, data)

        results = _vmapped_results(
            tcfg, fold_datas, seed, build, lambda m: _fusion_fns(m, tcfg),
            resume_dir, chunk_epochs, task_name, fold_parallel,
            data_parallel)
        for m in models:
            _check_frozen(m, "all")
        return results
    model = optimizer = None
    results = []
    for fold, data in enumerate(fold_datas, start=1):
        device = data.train_y.device
        if model is None or not carry:
            model = fresh(fold, device)
            optimizer = optim.build(tcfg.optimizer, model)
        else:
            model.init_from_branches(*branch_params[fold - 1], tcfg.track)
        run = loop.FoldRun(model, optimizer, *_fusion_fns(model, tcfg),
                           _head_test_split(model, data), tcfg.track,
                           tcfg.gate, tcfg.epochs - 1,
                           dropout_key(seed, fold, device))
        best, logs, step_losses = _execute_fold(
            run, chunk_epochs, _resume_path(resume_dir,
                                            f"{task_name}_fold{fold}"))
        _check_frozen(model, fold)
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
                   init_params_per_fold=None, resume_dir=None,
                   chunk_epochs=None, vmap_folds: bool = False,
                   meta_extras: dict | None = None,
                   fold_parallel: bool = False, data_parallel: int = 1):
    """3-fold multimodal fusion classifier.  ``branch_params[fold]`` is the
    (text, audio) pair of gated branch state dicts from
    :func:`train_text_clf` / :func:`train_audio_clf` (the reference's
    state-dict surgery); ``init_params_per_fold[0]``, when given, is the
    fusion's initial state dict.  ``resume_dir`` / ``chunk_epochs`` as in
    :func:`train_audio_clf`; ``vmap_folds`` / ``fold_parallel`` raise: the
    folds chain their state."""
    xa = _features(audio_features, device)
    feats = [xa, _features(text_features, xa.device)]
    datas = _clf_fold_datas(feats, np.asarray(targets), train_folds_idx,
                            tcfg.batch_size, fold_cfg)
    results = _run_fusion_folds(fcfg, tcfg, datas, branch_params, seed,
                                init_params_per_fold, resume_dir,
                                chunk_epochs, "fuse_clf", vmap_folds,
                                fold_parallel, data_parallel)
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
                   init_params_per_fold=None, resume_dir=None,
                   chunk_epochs=None, vmap_folds: bool = False,
                   meta_extras: dict | None = None,
                   fold_parallel: bool = False, data_parallel: int = 1):
    """3-fold multimodal fusion SDS regressor (SmoothL1 MyLoss, MAE
    gating); arguments as :func:`train_fuse_clf` (``vmap_folds``,
    ``fold_parallel`` and ``data_parallel`` run the folds, which start
    afresh, as one stacked program), folds as :func:`train_audio_reg`
    (pass the branches' ``fold_cfg``)."""
    xa = _features(audio_features, device)
    feats = [xa, _features(text_features, xa.device)]
    datas = _reg_fold_datas(feats, np.asarray(targets), dep_idxs, non_idxs,
                            tcfg.batch_size, fold_cfg)
    results = _run_fusion_folds(fcfg, tcfg, datas, branch_params, seed,
                                init_params_per_fold, resume_dir,
                                chunk_epochs, "fuse_reg", vmap_folds,
                                fold_parallel, data_parallel)
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
