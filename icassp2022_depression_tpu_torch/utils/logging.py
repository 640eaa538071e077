"""Structured metrics logging (port of
:mod:`icassp2022_depression_tpu.utils.logging`, host-only, copied).

The reference's only observability is stdout prints (per-epoch loss/acc,
confusion matrices, save banners — ``audio_gru_whole.py:198-201,222-231,
241-243``).  Here: a JSONL metrics writer + stdout formatting helpers that
reproduce the reference's report shapes, fed from the per-epoch log arrays
the fold loop returns (metrics computed on the device, logged on the
host).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import numpy as np


class MetricsLogger:
    """Append-only JSONL logger, one record per event; in a group of
    ranks only rank 0 writes the file."""

    def __init__(self, path: Optional[Path] = None, echo: bool = False):
        from icassp2022_depression_tpu_torch.parallel import distributed

        self.path = Path(path) if path and distributed.is_main() else None
        self.echo = echo
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, event: str, **fields):
        record = {"event": event, "time": time.time(), **fields}
        line = json.dumps(record, default=_jsonable)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line)
        return record

    def log_fold(self, trainer: str, fold: int, logs: dict, best: dict):
        """Write the per-epoch arrays + best summary for one fold."""
        n = len(next(iter(logs.values()))) if logs else 0
        for ep in range(n):
            self.log("epoch", trainer=trainer, fold=fold, epoch=ep + 1,
                     **{k: float(v[ep]) for k, v in logs.items()})
        self.log("fold_best", trainer=trainer, fold=fold,
                 **{k: v for k, v in best.items() if k != "params"})


def _jsonable(x):
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


def format_confusion_matrix(cm) -> str:
    """The reference's printed layout (``audio_gru_whole.py:156-157``)."""
    cm = np.asarray(cm)
    return ("Confusion Matrix:\n"
            f"[[{cm[0][0]} {cm[0][1]}]\n [{cm[1][0]} {cm[1][1]}]]")


def format_epoch_clf(epoch: int, lr: float, loss: float, correct: int,
                     total: int) -> str:
    """Per-epoch train line (``audio_gru_whole.py:198-201``)."""
    return ("Train Epoch: {:2d}\t Learning rate: {:.4f}\tLoss: {:.6f}\t "
            "Accuracy: {}/{} ({:.0f}%)".format(
                epoch, lr, loss, correct, total,
                100.0 * correct / max(total, 1)))


def format_eval_clf(m: dict) -> str:
    return ("Accuracy: {accuracy}\nPrecision: {precision}\n"
            "Recall: {recall}\nF1-Score: {f1}\n".format(**m) + "=" * 89)


def format_eval_reg(mae: float, rmse: float) -> str:
    return "MAE: {:.4f}\t RMSE: {:.4f}\n".format(mae, rmse) + "=" * 89
