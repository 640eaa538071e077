"""The whole-fold training loop (port of
:mod:`icassp2022_depression_tpu.train.loop`).

The reference trains with a Python step loop: 100-170 epochs of
minibatch slices, a full-batch evaluation of the test split every epoch,
and a torch-save whenever the metric gate fires
(``Classification/audio_gru_whole.py:161-245,316-318``).  The JAX package
compiles that whole fold into one ``lax.scan`` program; PyTorch runs
eagerly, so here it is a Python loop that keeps everything on the device
and never waits for it:

* minibatches are pre-padded to ``[n_batches, B, ...]`` with validity
  masks (the reference's ragged last slice is a masked batch), and are
  consecutive and unshuffled, as the reference's are
  (``audio_gru_whole.py:170-175``);
* a batch with no valid row (padding that gives every fold the same
  shapes) is skipped on the host -- which batches those are is known from
  ``FoldData.n_train`` -- so it updates nothing, not even Adam's step
  count, exactly as the JAX program's masked no-op;
* the gated "save best" is a ``torch.where`` select on the device against
  the gate, with the JAX package's thresholds and its exact rational
  train-accuracy compare;
* per-epoch metrics stay on the device, and each fold is read back once.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from icassp2022_depression_tpu_torch.config import GateConfig
from icassp2022_depression_tpu_torch.data.augment import PERM_TABLE
from icassp2022_depression_tpu_torch.eval import metrics as M

CLF_LOGS = ("loss", "train_correct", "f1", "accuracy", "precision",
            "recall")
REG_LOGS = ("loss", "train_mae", "mae", "rmse")
CLF_BEST = ("f1", "accuracy", "precision", "recall", "epoch")
REG_BEST = ("mae", "rmse", "epoch")


class FoldData(NamedTuple):
    """Device-ready fold tensors.  ``train_x``/``test_x`` are tuples of
    tensors (length 1 for unimodal), batched as ``[n_batches, B, ...]`` for
    train and flat ``[N, ...]`` for test.  The valid train rows are the
    first ``n_train`` (a host int), so the fold loop knows without reading
    the device which batches hold one."""

    train_x: tuple
    train_y: torch.Tensor      # [NB, B]
    train_mask: torch.Tensor   # [NB, B]
    test_x: tuple
    test_y: torch.Tensor       # [N]
    test_mask: torch.Tensor    # [N]
    n_train: int


def _device(arrays, device):
    if device is not None:
        return torch.device(device)
    first = arrays[0]
    return first.device if isinstance(first, torch.Tensor) else \
        torch.device("cpu")


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


def _pad(a: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])


def _valid_mask(n: int, total: int, device) -> torch.Tensor:
    return (torch.arange(total, device=device) < n).to(torch.float32)


def batchify(xs: Sequence, y, batch_size: int,
             total_rows: Optional[int] = None, device=None):
    """Pad the row count to a multiple of ``batch_size`` (or to
    ``total_rows``, which gives every fold the same shapes) and reshape to
    [n_batches, B, ...] plus a validity mask.  Arrays may be numpy or
    torch; the results lie on ``device`` (default: where ``xs[0]`` is)."""
    device = _device(xs, device)
    n = len(y)
    nb = -(-(total_rows if total_rows is not None else n) // batch_size)
    pad = nb * batch_size - n
    if pad < 0:
        raise ValueError(f"{n} rows do not fit total_rows={total_rows}")

    def p(a):
        a = _tensor(a, device)
        return _pad(a, pad).reshape((nb, batch_size) + tuple(a.shape[1:]))

    mask = _valid_mask(n, nb * batch_size, device).reshape(nb, batch_size)
    return tuple(p(a) for a in xs), p(y), mask


def pad_rows(xs: Sequence, y, total: int, device=None):
    """Pad a flat eval split to ``total`` rows with a validity mask."""
    device = _device(xs, device)
    n = len(y)
    pad = total - n
    if pad < 0:
        raise ValueError(f"{n} rows do not fit total={total}")
    return (tuple(_pad(_tensor(a, device), pad) for a in xs),
            _pad(_tensor(y, device), pad), _valid_mask(n, total, device))


def make_fold_data(train_xs, train_y, test_xs, test_y, batch_size,
                   test_total=None, train_total=None,
                   device=None) -> FoldData:
    """Fold tensors from host-materialised splits."""
    bx, by, bm = batchify(train_xs, train_y, batch_size, train_total, device)
    if test_total is None:
        test_total = len(test_y)
    tx, ty, tm = pad_rows(test_xs, test_y, test_total, device)
    return FoldData(bx, by, bm, tx, ty, tm, len(train_y))


def _pad_plan(plan, total_rows):
    pad = total_rows - len(plan.targets)
    if pad < 0:
        raise ValueError(f"{len(plan.targets)} rows do not fit {total_rows}")
    spk = np.concatenate([plan.spk, np.zeros(pad, plan.spk.dtype)])
    perm = np.concatenate([plan.perm, np.zeros(pad, plan.perm.dtype)])
    y = np.concatenate([plan.targets, np.zeros(pad, plan.targets.dtype)])
    return spk, perm, y


def _gather_plan_rows(arr: torch.Tensor, spk, perm, n_valid: int,
                      total_rows: int) -> torch.Tensor:
    """``total_rows`` split rows from a pristine [N, 3, ...] tensor by
    gathers on its device: row r = ``arr[spk[r]][PERMS[perm[r]]]``, zeroed
    beyond ``n_valid`` (the host path's zero padding)."""
    dev = arr.device
    sel = arr.index_select(0, torch.as_tensor(spk, dtype=torch.long,
                                              device=dev))    # [R, 3, ...]
    table = torch.as_tensor(PERM_TABLE, dtype=torch.long, device=dev)
    order = table[torch.as_tensor(perm, dtype=torch.long, device=dev)]
    order = order.reshape(order.shape + (1,) * (arr.dim() - 2))
    rows = torch.gather(sel, 1, order.expand(sel.shape))
    valid = torch.arange(total_rows, device=dev) < n_valid
    valid = valid.reshape((total_rows,) + (1,) * (arr.dim() - 1))
    return torch.where(valid, rows, torch.zeros((), dtype=arr.dtype,
                                                device=dev))


def fold_data_from_plans(feature_arrays: Sequence[torch.Tensor], train_plan,
                         test_plan, batch_size: int, test_total=None,
                         train_total=None) -> FoldData:
    """Fold tensors from ``data.augment.SplitPlan`` index plans over the
    pristine [N, 3, ...] feature tensors, gathered where those tensors lie
    (the card, for features straight out of extraction), so features never
    go back to the host.  Bit-equal to :func:`make_fold_data` over the
    host-materialised splits."""
    dev = feature_arrays[0].device
    n_train = len(train_plan.targets)
    nb = -(-(train_total if train_total is not None else n_train)
           // batch_size)
    rows = nb * batch_size
    spk, perm, y = _pad_plan(train_plan, rows)
    train_x = tuple(
        _gather_plan_rows(a, spk, perm, n_train, rows)
        .reshape((nb, batch_size) + tuple(a.shape[1:]))
        for a in feature_arrays)
    train_y = torch.as_tensor(y.reshape(nb, batch_size), device=dev)
    train_mask = _valid_mask(n_train, rows, dev).reshape(nb, batch_size)

    if test_total is None:
        test_total = len(test_plan.targets)
    tspk, tperm, ty = _pad_plan(test_plan, test_total)
    n_test = len(test_plan.targets)
    test_x = tuple(_gather_plan_rows(a, tspk, tperm, n_test, test_total)
                   for a in feature_arrays)
    return FoldData(train_x, train_y, train_mask, test_x,
                    torch.as_tensor(ty, device=dev),
                    _valid_mask(n_test, test_total, dev), n_train)


def init_best(track: str, model: nn.Module, device) -> dict:
    """Initial gated-best record (reference init values: ``max_f1 = -1`` /
    ``min_mae = 100``), the metrics as 0-d device tensors."""
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    init = -1.0 if track == "classification" else 100.0
    keys = CLF_BEST if track == "classification" else REG_BEST
    best = {k: torch.tensor(-1.0 if k == "epoch" else init, device=device)
            for k in keys}
    best["params"] = params
    return best


def model_fns(model: nn.Module, loss_fn: Callable):
    """:func:`run_fold`'s ``(train_loss, eval_fn)`` for a one-input model:
    ``loss_fn(pred, y, mask)`` on ``model(xs[0], generator)``, and the
    eval forward ``model(xs[0])``."""
    def train_loss(xs, y, mask, generator):
        pred = model(xs[0], generator)
        return loss_fn(pred, y, mask), pred

    def eval_fn(xs):
        return model(xs[0])

    return train_loss, eval_fn


def run_fold(model: nn.Module, optimizer: torch.optim.Optimizer,
             train_loss: Callable, eval_fn: Callable, data: FoldData,
             track: str, gate: GateConfig, epochs: int,
             generator: Optional[torch.Generator] = None):
    """Train one fold in place, the counterpart of the JAX package's
    ``make_fold_runner(train_loss, eval_fn, ...)(params, opt_state, data,
    key)``.

    Runs ``epochs - 1`` epochs (the reference's ``range(1, epochs)``) of
    consecutive minibatches, each a step on ``train_loss(xs, y, mask,
    generator) -> (loss, pred)`` with ``model`` in train mode (dropout from
    ``generator``), then ``eval_fn(data.test_x)`` in eval mode without a
    graph and the metric gate.  ``model`` holds every parameter (its
    ``state_dict()`` is what the gate keeps); ``optimizer`` may carry state
    in from an earlier fold.  Returns ``(best, logs, step_losses)``
    on the host: ``best`` holds the gated metrics as floats and, under
    ``"params"``, the gated state dict on the device; ``logs`` one array
    per metric over the epochs, ``"steps"`` the optimizer steps of each;
    ``step_losses`` [epochs - 1, steps] the loss of every step.
    """
    if data.n_train <= 0:
        raise ValueError("the fold has no training rows")
    n_epochs = epochs - 1
    n_steps = -(-data.n_train // data.train_y.shape[1])   # later batches are all padding
    device = data.train_y.device
    clf = track == "classification"
    best = init_best(track, model, device)
    live = model.state_dict()           # views of the trained params
    epoch_ids = torch.arange(n_epochs, dtype=torch.float32, device=device)
    # EXACT boundary semantics (JAX loop.py:236-253): the reference tests
    # `train_acc > len(train_idxs) * 0.9` in float64, where 0.9 is slightly
    # above 9/10, so `correct == 0.9 * n` does NOT gate; both counts are
    # integers, so compare the exact rational `correct * den > num * n`
    frac = Fraction(gate.train_acc_frac).limit_denominator(10000)
    acc_bound = frac.numerator * data.n_train
    train_y = data.train_y[:n_steps]
    train_mask = data.train_mask[:n_steps]
    log_rows, loss_rows = [], []
    for epoch in range(n_epochs):
        model.train()
        losses, preds = [], []
        for i in range(n_steps):
            optimizer.zero_grad(set_to_none=True)
            loss, pred = train_loss(tuple(x[i] for x in data.train_x),
                                    data.train_y[i], data.train_mask[i],
                                    generator)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
            preds.append(pred.detach())
        model.eval()
        with torch.no_grad():
            test_pred = eval_fn(data.test_x)
        losses = torch.stack(losses)
        preds = torch.stack(preds)
        if clf:
            train_correct = (train_mask
                             * (preds.argmax(dim=-1) == train_y)).sum()
            tp, fp, fn, tn = M.confusion_counts(
                data.test_y, test_pred.argmax(dim=-1), data.test_mask)
            acc, prec, rec, f1 = M.f1_from_counts(tp, fp, fn, tn)
            improve = (f1 >= best["f1"]) if gate.f1_tie_update \
                else (f1 > best["f1"])
            corr = train_correct.to(torch.int64) * frac.denominator
            acc_ok = (corr > acc_bound) if gate.train_acc_strict \
                else (corr >= acc_bound)
            should = improve & acc_ok & (f1 > gate.f1_floor)
            new = {"f1": f1, "accuracy": acc, "precision": prec,
                   "recall": rec}
            row = (losses.sum(), train_correct, f1, acc, prec, rec)
        else:
            train_mae = M.masked_mae(train_y, preds.squeeze(-1), train_mask)
            pred_flat = test_pred.squeeze(-1)
            mae = M.masked_mae(data.test_y, pred_flat, data.test_mask)
            rmse = M.masked_rmse(data.test_y, pred_flat, data.test_mask)
            should = ((mae <= best["mae"]) & (mae < gate.mae_ceiling)
                      & (train_mae < gate.train_mae_ceiling))
            new = {"mae": mae, "rmse": rmse}
            row = (losses.sum(), train_mae, mae, rmse)
        new["epoch"] = epoch_ids[epoch]
        for k, v in new.items():
            best[k] = torch.where(should, v, best[k])
        for k, v in live.items():
            best["params"][k] = torch.where(should, v, best["params"][k])
        log_rows.append(torch.stack(row))
        loss_rows.append(losses)
    return _to_host(best, log_rows, loss_rows, clf, n_epochs, n_steps)


def _to_host(best, log_rows, loss_rows, clf: bool, n_epochs: int,
             n_steps: int):
    """One device-to-host copy for the whole fold."""
    log_keys = CLF_LOGS if clf else REG_LOGS
    best_keys = CLF_BEST if clf else REG_BEST
    parts = [torch.stack([best[k] for k in best_keys])]
    if n_epochs:
        parts += [torch.stack(log_rows).reshape(-1),
                  torch.stack(loss_rows).reshape(-1)]
    flat = torch.cat(parts).cpu().numpy()
    host_best = {k: float(v) for k, v in zip(best_keys, flat)}
    host_best["params"] = best["params"]
    n_logs = n_epochs * len(log_keys)
    table = flat[len(best_keys):len(best_keys) + n_logs].reshape(
        n_epochs, len(log_keys))
    logs = {k: table[:, i] for i, k in enumerate(log_keys)}
    logs["steps"] = np.full(n_epochs, float(n_steps), np.float32)
    step_losses = flat[len(best_keys) + n_logs:].reshape(n_epochs, n_steps)
    return host_best, logs, step_losses
