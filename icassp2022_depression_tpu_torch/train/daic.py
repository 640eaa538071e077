"""DAIC-WOZ downstream training over ragged response sets (port of
:mod:`icassp2022_depression_tpu.train.daic`).

The reference stops at DAIC feature extraction
(``DAICFeatureExtarction/feature_extraction.py``); the JAX package trains
on those features, and so does this module.  Participants have a variable
number of responses, so the features are padded at the tail to a common
count with a validity mask (:func:`..frontend.daic.pad_responses`, or
:func:`pad_flat_responses_device` for features that never left the card),
and the audio GRU model pools over the valid responses only (``time_mask``
of :class:`..models.audio_net.AudioNet`); the GRU still runs over the
padding.  The split is AVEC2017's train / dev, one fold, with the EATD
trainers' gated best-checkpoint selection.

The fold runs as one :class:`..train.loop.FoldRun` (on a card, one CUDA
graph an epoch); the mask is the fold's second input tensor beside ``x``,
gathered into the fold's static batches with it.  The initial weights come
from ``PRNGKey(seed)`` and the dropout masks from ``fold_in(PRNGKey(seed),
1)`` (JAX ``train/daic.py:188,199``), so a seed gives the JAX package's
weights and masks.  At batch 16 and H = 256 a participant with more than
83 responses makes the backward one the JAX package streams (TPU kernel
#3, counted under ``gru_bwd_streamed``: :func:`..ops.rnn_cuda.streamed`).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from icassp2022_depression_tpu_torch import config as C
from icassp2022_depression_tpu_torch.eval import metrics
from icassp2022_depression_tpu_torch.frontend.daic import (
    FlatResponses,
    gather_responses,
    pad_responses,
)
from icassp2022_depression_tpu_torch.models import porting
from icassp2022_depression_tpu_torch.models.audio_net import AudioNet
from icassp2022_depression_tpu_torch.ops import prng
from icassp2022_depression_tpu_torch.ops.nn import (
    l1_loss,
    masked_cross_entropy_on_probs,
)
from icassp2022_depression_tpu_torch.train import checkpoints, loop, optim
from icassp2022_depression_tpu_torch.utils.device import resolve_device

#: no reference counterpart: the EATD audio classifier over response
#: sequences (JAX ``DAIC_CLF``)
DAIC_CLF = C.TrainerConfig(
    model=C.RNNConfig(num_classes=2, dropout=0.5, rnn_layers=2,
                      embedding_size=256, hidden_dims=256,
                      bidirectional=False, cell="gru", input_layernorm=True,
                      pooling="mean", head_activation="softmax",
                      init="torch", head_input_dropout=True),
    optimizer=C.OptimizerConfig(name="adamw", learning_rate=1e-4),
    gate=C.GateConfig(f1_floor=0.0, train_acc_frac=0.0),
    batch_size=16, epochs=101, loss="ce", track="classification",
)

DAIC_REG = C.replace(
    DAIC_CLF,
    model=C.replace(DAIC_CLF.model, num_classes=1, input_layernorm=False,
                    pooling="sum", head_activation="relu"),
    optimizer=C.OptimizerConfig(name="adam", learning_rate=1e-4,
                                weight_decay=0.0),
    gate=C.GateConfig(mae_ceiling=100.0, train_mae_ceiling=1e9),
    loss="l1", track="regression",
)


def _fns(model: AudioNet, tcfg: C.TrainerConfig):
    """``(train_loss(xs, y, mask, key, rows), eval_fn(xs))`` for
    :class:`..train.loop.FoldRun`, ``xs = (x, time_mask)``: the masked CE
    on probabilities (clf) or the L1 loss (reg), as JAX ``_fns``."""
    num_classes = tcfg.model.num_classes

    def train_loss(xs, y, mask, key, rows=None):
        x, time_mask = xs
        pred = model(x, key, time_mask, rows)
        if tcfg.track == "classification":
            loss = masked_cross_entropy_on_probs(pred, y, mask, num_classes)
        else:
            loss = l1_loss(pred.squeeze(-1), y.to(torch.float32), mask)
        return loss, pred

    def eval_fn(xs):
        x, time_mask = xs
        return model(x, time_mask=time_mask)

    return train_loss, eval_fn


def concat_multimodal(audio_features: List[np.ndarray],
                      text_features: List[np.ndarray]) -> List[np.ndarray]:
    """Per-participant [n_i, 1, Da] audio + [n_i, Dt] text features ->
    [n_i, 1, Da + Dt] blocks for :func:`train_daic` (whose model's
    ``embedding_size`` is then Da + Dt)."""
    out = []
    for idx, (a, t) in enumerate(zip(audio_features, text_features)):
        a2 = a[:, 0, :] if a.ndim == 3 else a
        if len(a2) != len(t):
            raise ValueError(
                f"participant {idx}: {len(a2)} audio vs {len(t)} text "
                "responses - the modalities come from different "
                "segmentations (re-extract with "
                "extract_participant_multimodal)")
        out.append(np.concatenate([a2, t], axis=-1)[:, None, :]
                   .astype(np.float32))
    return out


def model_forward(model: AudioNet, x, mask) -> np.ndarray:
    """Eval forward of padded responses ``x`` [N, R, D] and ``mask``
    [N, R] (numpy or tensors) on the model's device -> [N, C] host."""
    device = next(model.parameters()).device
    with torch.inference_mode():
        out = model(torch.as_tensor(x, dtype=torch.float32, device=device),
                    time_mask=torch.as_tensor(mask, dtype=torch.float32,
                                              device=device))
    return out.cpu().numpy()


def check_daic(features: List[np.ndarray], labels, ckpt_path,
               tcfg: C.TrainerConfig = DAIC_CLF, device=None) -> dict:
    """The eval split's metrics of a ``train_daic`` checkpoint (npz of
    either package, or a reference ``.pt``) on ``device`` (None: the
    first card): P / R / F1 / accuracy and the confusion matrix (clf), MAE
    / RMSE (reg), the training-time best when fed the same split."""
    max_r = max((f.shape[0] for f in features), default=1)
    x, mask = pad_responses(features, max_r)
    y = np.asarray(labels)
    model = checkpoints.load_model(ckpt_path, "audio", tcfg.model,
                                   resolve_device(device))
    pred = model_forward(model, x, mask)
    if tcfg.track == "classification":
        cm = metrics.standard_confusion_matrix(y, np.argmax(pred, axis=-1))
        out = metrics.classification_metrics(cm)
        out["confusion_matrix"] = cm.tolist()
        return out
    pred = pred.ravel()
    return {"mae": metrics.mean_absolute_error(y, pred),
            "rmse": metrics.root_mean_squared_error(y, pred)}


def pad_flat_responses_device(resp: FlatResponses, max_responses: int):
    """:func:`..frontend.daic.pad_responses` of features on the device:
    flat [M, D] rows + per-participant counts -> ([N, R, D] on their
    device, by :func:`..frontend.daic.gather_responses`, and the host mask
    [N, R]).  Bitwise the host padding."""
    counts = list(resp.counts)
    mask = (np.arange(max_responses)
            < np.asarray(counts, np.int64)[:, None]).astype(np.float32)
    return (gather_responses(resp.flat, counts, len(counts), max_responses),
            mask)


def _max_responses(features) -> int:
    if isinstance(features, FlatResponses):
        return max(features.counts, default=1)
    return max((f.shape[0] for f in features), default=1)


def _resp_matrix(features, max_r: int):
    if isinstance(features, FlatResponses):
        return pad_flat_responses_device(features, max_r)
    return pad_responses(features, max_r)


def _labels(labels, track: str) -> np.ndarray:
    """Class ids as int64, scores as float32 (the JAX package's arrays
    without 64-bit floats)."""
    return np.asarray(labels, np.int64 if track == "classification"
                      else np.float32)


def train_daic(train_features, train_labels, test_features, test_labels,
               tcfg: C.TrainerConfig = DAIC_CLF,
               out_dir: Optional[Path] = None, seed: int = 0,
               meta_extras: Optional[dict] = None, device=None,
               init_state_dict=None) -> dict:
    """Train on the AVEC2017 train split, gate on the dev split.

    ``*_features``: ragged per-participant [n_i, 1, D] blocks (host,
    :func:`..frontend.daic.extract_split`) or a :class:`FlatResponses`
    whose rows lie on the device
    (:func:`..frontend.daic.extract_split_device`, padded there by a
    gather).  The fold trains on ``device``, by default where a
    :class:`FlatResponses` lies, else the first card.
    ``init_state_dict`` replaces the seeded initial weights (e.g. the JAX
    package's, through :func:`..models.porting.audio_net_state_dict_from_jax`).

    Returns ``{"best", "logs", "step_losses"}`` (``best`` with the gated
    state dict under ``"params"``); with ``out_dir`` and an open gate, the
    checkpoint ``daic_{clf|reg}_{metric:.2f}`` (npz in the JAX package's
    layout) with ``embedding_size`` and ``meta_extras`` in its sidecar.
    """
    if device is None and isinstance(train_features, FlatResponses):
        device = train_features.flat.device
    device = resolve_device(device)
    max_r = max(_max_responses(train_features),
                _max_responses(test_features))
    xtr, mtr = _resp_matrix(train_features, max_r)
    xte, mte = _resp_matrix(test_features, max_r)
    data = loop.make_fold_data(
        [xtr, mtr], _labels(train_labels, tcfg.track), [xte, mte],
        _labels(test_labels, tcfg.track), tcfg.batch_size, device=device)

    model = AudioNet(tcfg.model, None if init_state_dict is not None
                     else prng.prng_key(seed))
    if init_state_dict is not None:
        model.load_state_dict(init_state_dict, strict=True)
    model = model.to(device)
    # the unused attention layer gets no gradient, so torch's Adam skips
    # it, decay included: JAX's dead_paths=("attn",)
    optimizer = optim.build(tcfg.optimizer, model)
    key = prng.fold_in(prng.prng_key(seed), 1).to(device)
    run = loop.FoldRun(model, optimizer, *_fns(model, tcfg), data,
                       tcfg.track, tcfg.gate, tcfg.epochs - 1, key)
    run.run(tcfg.epochs - 1)
    best, logs, step_losses = run.results()
    if out_dir is not None and best["epoch"] >= 0:
        metric = best.get("f1", best.get("mae"))
        kind = "clf" if tcfg.track == "classification" else "reg"
        meta = {k: v for k, v in best.items() if k != "params"}
        # lets DaicPredictor.from_checkpoint rebuild the model (and detect
        # --multimodal checkpoints, whose input is audio + text)
        meta["embedding_size"] = tcfg.model.embedding_size
        if meta_extras:
            meta.update(meta_extras)
        checkpoints.save(
            Path(out_dir) / f"daic_{kind}_{metric:.2f}",
            porting.audio_net_tree_from_state_dict(best["params"],
                                                   tcfg.model), meta)
    return {"best": best, "logs": logs, "step_losses": step_losses}
