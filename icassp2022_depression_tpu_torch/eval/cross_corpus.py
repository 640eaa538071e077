"""Cross-corpus evaluation: EATD-trained audio models on DAIC-WOZ features
(port of :mod:`icassp2022_depression_tpu.eval.cross_corpus`).

The reference ships the DAIC frontend for cross-corpus work
(``DAICFeatureExtarction/``; BASELINE config 5) but no evaluation code:
its EATD models take exactly 3 answers per speaker, while a DAIC
participant gives a variable number of responses.  Here:

* each participant's response features are cut into consecutive windows
  of 3 (:func:`windows_of_3`), the last padded by repeating its final
  response;
* every participant's windows go through the EATD model as one batch on
  the device, padded to a power of two (the GRU forward kernel at (3,
  next_pow2(windows), H)), and are read back once;
* classification soft-votes: the windows' probabilities are averaged per
  participant; a participant with no responses is predicted 0;
  regression averages the windows' scores and reports MAE / RMSE beside
  those of a least-squares affine calibration (SDS 25-75 against PHQ8
  0-24).

The JAX CLI never registers its ``check-cross`` command, so neither does
the port's: these functions are the ported surface.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from icassp2022_depression_tpu_torch import config as C
from icassp2022_depression_tpu_torch.eval import metrics
from icassp2022_depression_tpu_torch.utils import shapes


def windows_of_3(responses: np.ndarray) -> np.ndarray:
    """[n, D] (or the ragged-block layout [n, 1, D]) response features ->
    [ceil(n/3), 3, D] windows, the tail padded by repeating the last
    response."""
    responses = np.asarray(responses)
    if responses.ndim == 3:
        responses = responses[:, 0, :]
    n, d = responses.shape
    if n == 0:
        return np.zeros((0, 3, d), np.float32)
    n_win = -(-n // 3)
    padded = np.concatenate(
        [responses, np.repeat(responses[-1:], n_win * 3 - n, axis=0)], axis=0)
    return padded.reshape(n_win, 3, d).astype(np.float32)


def _all_window_outputs(model, features):
    """Every participant's windows through ``model`` as one batch padded
    to a power of two, read back once -> (per-participant window counts,
    [total, C] numpy outputs or None when there is no window)."""
    wins = [windows_of_3(f) for f in features]
    counts = [len(w) for w in wins]
    total = sum(counts)
    if total == 0:
        return counts, None
    flat = np.concatenate([w for w in wins if len(w)], axis=0)
    batch = np.zeros((shapes.next_pow2(total),) + flat.shape[1:], np.float32)
    batch[:total] = flat
    device = next(model.parameters()).device
    with torch.inference_mode():
        out = model(torch.from_numpy(batch).to(device))
    return counts, out[:total].cpu().numpy()


def _model(model, mcfg, device):
    from icassp2022_depression_tpu_torch.train import checkpoints

    return checkpoints.load_model(model, "audio", mcfg, device)


def evaluate_clf(model, features: Sequence[np.ndarray], labels,
                 mcfg: C.RNNConfig = C.AUDIO_CLF.model, device=None) -> dict:
    """An EATD audio classifier on DAIC participants (soft-voted windows).
    ``model``: an :class:`..models.audio_net.AudioNet`, a JAX-layout param
    tree or a checkpoint path (under ``mcfg``), run on ``device`` (None:
    the first card).  Returns the NaN-safe metrics, the confusion matrix
    and the per-participant predictions."""
    counts, probs = _all_window_outputs(_model(model, mcfg, device),
                                        features)
    preds = []
    pos = 0
    for c in counts:
        if c == 0:
            preds.append(0)
            continue
        preds.append(int(np.argmax(probs[pos:pos + c].mean(axis=0))))
        pos += c
    cm = metrics.standard_confusion_matrix(np.asarray(labels),
                                           np.asarray(preds))
    m = metrics.safe_classification_metrics(cm)
    m["confusion_matrix"] = cm.tolist()
    m["predictions"] = preds
    return m


def evaluate_reg(model, features: Sequence[np.ndarray], scores,
                 mcfg: C.RNNConfig = C.AUDIO_REG.model, device=None) -> dict:
    """An EATD audio regressor on DAIC participants (window-mean scores;
    ``model`` and ``device`` as :func:`evaluate_clf` takes them): raw MAE
    and RMSE, and those of the least-squares affine rescaling of the
    predictions (``*_calibrated``)."""
    counts, out = _all_window_outputs(_model(model, mcfg, device), features)
    preds = []
    pos = 0
    for c in counts:
        if c == 0:
            preds.append(0.0)
            continue
        preds.append(float(out[pos:pos + c].mean()))
        pos += c
    preds = np.asarray(preds)
    scores = np.asarray(scores, np.float64)
    result = {
        "mae": metrics.mean_absolute_error(scores, preds),
        "rmse": metrics.root_mean_squared_error(scores, preds),
    }
    a_mat = np.stack([preds, np.ones_like(preds)], axis=1)
    coef, *_ = np.linalg.lstsq(a_mat, scores, rcond=None)
    calibrated = a_mat @ coef
    result["mae_calibrated"] = metrics.mean_absolute_error(scores, calibrated)
    result["rmse_calibrated"] = metrics.root_mean_squared_error(scores,
                                                               calibrated)
    return result
