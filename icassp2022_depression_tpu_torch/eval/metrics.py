"""Evaluation metrics with the reference's exact conventions (port of
:mod:`icassp2022_depression_tpu.eval.metrics`).

The reference reorders sklearn's confusion matrix into
``[[TP, FP], [FN, TN]]`` with *depressed = positive class* and computes
precision/recall/F1 from that matrix by hand
(``Classification/audio_gru_whole.py:128-159,222-230``).  Regression uses
sklearn MAE / RMSE (``Regression/audio_bilstm_perm.py:167,197-198``).

Two implementations:

* host (NumPy) versions for reporting, copied from the JAX package;
* device (torch) versions used inside the fold loop, so the metric-gated
  best-checkpoint selection runs on the device without a host sync.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Host (NumPy)
# ---------------------------------------------------------------------------


def standard_confusion_matrix(y_true, y_pred) -> np.ndarray:
    """Confusion matrix in the reference's ``[[TP, FP], [FN, TN]]`` layout.

    Mirrors ``standard_confusion_matrix`` (``audio_gru_whole.py:128-146``),
    which destructures sklearn's ``[[tn, fp], [fn, tp]]`` and reorders it.
    """
    y_true = np.asarray(y_true).astype(np.int64).ravel()
    y_pred = np.asarray(y_pred).astype(np.int64).ravel()
    tp = int(np.sum((y_true == 1) & (y_pred == 1)))
    tn = int(np.sum((y_true == 0) & (y_pred == 0)))
    fp = int(np.sum((y_true == 0) & (y_pred == 1)))
    fn = int(np.sum((y_true == 1) & (y_pred == 0)))
    return np.array([[tp, fp], [fn, tn]])


def classification_metrics(conf_matrix: np.ndarray) -> dict:
    """Accuracy / precision / recall / F1 from the standard confusion matrix,
    with the reference's exact formulas (``audio_gru_whole.py:223-226``).

    Division by zero propagates as in the reference (raises/returns nan);
    callers that need NaN-safety use :func:`safe_classification_metrics`.
    """
    cm = np.asarray(conf_matrix, dtype=np.float64)
    accuracy = float(cm[0][0] + cm[1][1]) / np.sum(cm)
    precision = float(cm[0][0]) / (cm[0][0] + cm[0][1])
    recall = float(cm[0][0]) / (cm[0][0] + cm[1][0])
    f1 = 2 * (precision * recall) / (precision + recall)
    return {
        "accuracy": float(accuracy),
        "precision": float(precision),
        "recall": float(recall),
        "f1": float(f1),
    }


def safe_classification_metrics(conf_matrix: np.ndarray) -> dict:
    """NaN->0 variant used by the traditional-classifier baselines
    (``Classification/AudioTraditionalClassifiers.py:112-114``)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        m = classification_metrics(conf_matrix)
    return {k: (0.0 if not np.isfinite(v) else v) for k, v in m.items()}


def fold_mean(results, keys) -> dict:
    """Mean of per-fold metric dicts over ``keys``."""
    return {k: float(np.mean([r[k] for r in results])) for k in keys}


def mean_absolute_error(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_pred = np.asarray(y_pred, dtype=np.float64).ravel()
    return float(np.mean(np.abs(y_true - y_pred)))


def root_mean_squared_error(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_pred = np.asarray(y_pred, dtype=np.float64).ravel()
    return float(np.sqrt(np.mean((y_true - y_pred) ** 2)))


# ---------------------------------------------------------------------------
# Device (torch): 0-d float32 tensors on the inputs' device, no host sync
# ---------------------------------------------------------------------------


def _flat(t: torch.Tensor, folded: bool, dtype) -> torch.Tensor:
    """``t`` as one row ([N]), or one row per fold ([F, N]) when
    ``folded``: the reductions below run over the last axis."""
    t = t.to(dtype)
    return t.reshape(t.shape[0], -1) if folded else t.reshape(-1)


def _mask(like: torch.Tensor, mask: Optional[torch.Tensor],
          folded: bool) -> torch.Tensor:
    if mask is None:
        return torch.ones_like(like, dtype=torch.float32)
    return _flat(mask, folded, torch.float32)


def confusion_counts(y_true: torch.Tensor, y_pred: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     folded: bool = False):
    """(tp, fp, fn, tn) as float32 scalars; ``mask`` excludes padded rows.
    ``folded``: inputs ``[F, ...]`` give one count per fold ([F])."""
    y_true = _flat(y_true, folded, torch.int32)
    y_pred = _flat(y_pred, folded, torch.int32)
    mask = _mask(y_true, mask, folded)
    tp = (mask * ((y_true == 1) & (y_pred == 1))).sum(dim=-1)
    fp = (mask * ((y_true == 0) & (y_pred == 1))).sum(dim=-1)
    fn = (mask * ((y_true == 1) & (y_pred == 0))).sum(dim=-1)
    tn = (mask * ((y_true == 0) & (y_pred == 0))).sum(dim=-1)
    return tp, fp, fn, tn


def _ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return torch.where(den > 0, num / torch.clamp(den, min=1.0),
                       torch.zeros_like(num))


def f1_from_counts(tp, fp, fn, tn):
    """accuracy, precision, recall, f1 on the device.

    Zero denominators yield 0 (the host path would yield nan/inf; the gating
    comparisons ``f1 > floor`` treat both identically since nan fails any
    comparison and 0 fails the floor)."""
    accuracy = _ratio(tp + tn, tp + fp + fn + tn)
    precision = _ratio(tp, tp + fp)
    recall = _ratio(tp, tp + fn)
    denom = precision + recall
    f1 = torch.where(denom > 0,
                     2 * precision * recall / torch.clamp(denom, min=1e-12),
                     torch.zeros_like(denom))
    return accuracy, precision, recall, f1


def masked_mae(y_true: torch.Tensor, y_pred: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               folded: bool = False) -> torch.Tensor:
    """Mean absolute error over the valid rows (per fold when
    ``folded``)."""
    y_true = _flat(y_true, folded, torch.float32)
    y_pred = _flat(y_pred, folded, torch.float32)
    if mask is None:
        return (y_true - y_pred).abs().mean(dim=-1)
    mask = _mask(y_true, mask, folded)
    return ((mask * (y_true - y_pred).abs()).sum(dim=-1)
            / torch.clamp(mask.sum(dim=-1), min=1.0))


def masked_rmse(y_true: torch.Tensor, y_pred: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                folded: bool = False) -> torch.Tensor:
    """Root mean squared error over the valid rows (per fold when
    ``folded``)."""
    y_true = _flat(y_true, folded, torch.float32)
    y_pred = _flat(y_pred, folded, torch.float32)
    if mask is None:
        return ((y_true - y_pred) ** 2).mean(dim=-1).sqrt()
    mask = _mask(y_true, mask, folded)
    return ((mask * (y_true - y_pred) ** 2).sum(dim=-1)
            / torch.clamp(mask.sum(dim=-1), min=1.0)).sqrt()
