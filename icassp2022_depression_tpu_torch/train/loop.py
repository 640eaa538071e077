"""The whole-fold training loop (port of
:mod:`icassp2022_depression_tpu.train.loop`).

The reference trains with a Python step loop: 100-170 epochs of
minibatch slices, a full-batch evaluation of the test split every epoch,
and a torch-save whenever the metric gate fires
(``Classification/audio_gru_whole.py:161-245,316-318``).  The JAX package
compiles that whole fold into one ``lax.scan``-over-epochs program and
dispatches it once (``make_fold_runner``).  Here one epoch is one
function, :meth:`FoldRun.epoch`, that keeps everything on the device and
never waits for it; on a card :class:`FoldRun` captures it once into a
``torch.cuda.CUDAGraph`` and replays the graph once an epoch, on the CPU
it runs the same function eagerly:

* minibatches are pre-padded to ``[n_batches, B, ...]`` with validity
  masks (the reference's ragged last slice is a masked batch), and are
  consecutive and unshuffled, as the reference's are
  (``audio_gru_whole.py:170-175``);
* a batch with no valid row (padding that gives every fold the same
  shapes) is skipped on the host -- which batches those are is known from
  ``FoldData.n_train`` -- so it updates nothing, not even Adam's step
  count, exactly as the JAX program's masked no-op; its dropout key is
  still split off, as the JAX scan splits it;
* dropout keys are split per batch from the fold key (``key, sub =
  split(key)``, JAX ``loop.py:206``), in a device buffer updated in place;
* the gated "save best" is a ``torch.where`` select on the device against
  the gate, with the JAX package's thresholds and its exact rational
  train-accuracy compare, written in place into static buffers, as are
  the per-epoch logs (indexed by a device epoch counter);
* each fold is read back once.

Stacked folds (``--vmap-folds``, JAX ``make_multi_fold_runner``): a
:func:`stack_fold_data` of F folds, a model of :func:`..models.folds.stack`
and an :class:`..train.optim.StackedAdam` run all folds in one epoch
program, each with its own key, gated best and optimizer count.

Data parallelism (``--fold-parallel --data-parallel N``, the JAX
package's batch axis over a ``data`` mesh axis): a :class:`FoldRun` with
a ``data_group`` holds its rank's rows of every batch's features
(:func:`..parallel.distributed.shard_stacked_fold_data`) and computes
what the single-process run computes: its dropout masks are its rows of
the whole batch's (``train_loss``'s ``rows``), its loss is its rows'
sum over the whole batch's valid count, the gradients are summed over the
group before the replicated optimizer steps, and the epoch's per-step
losses and train predictions are summed back together before the gate,
which reads the whole batch; the test split is evaluated whole on every
rank.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from icassp2022_depression_tpu_torch.config import GateConfig
from icassp2022_depression_tpu_torch.data.augment import PERM_TABLE
from icassp2022_depression_tpu_torch.eval import metrics as M
from icassp2022_depression_tpu_torch.ops import prng, rnn_cuda
from icassp2022_depression_tpu_torch.parallel import collectives
from icassp2022_depression_tpu_torch.train import optim

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
    the device which batches hold one.  :func:`stack_fold_data` gives every
    tensor a leading fold axis and ``n_train`` one int per fold."""

    train_x: tuple
    train_y: torch.Tensor      # [NB, B]
    train_mask: torch.Tensor   # [NB, B]
    test_x: tuple
    test_y: torch.Tensor       # [N]
    test_mask: torch.Tensor    # [N]
    n_train: int               # a tuple, one per fold, when stacked


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


def stack_fold_data(datas: Sequence[FoldData]) -> FoldData:
    """Shape-uniform folds (one ``train_total`` / ``test_total``) stacked
    along a leading fold axis, JAX ``stack_fold_data``."""
    return FoldData(
        tuple(torch.stack(xs) for xs in zip(*(d.train_x for d in datas))),
        torch.stack([d.train_y for d in datas]),
        torch.stack([d.train_mask for d in datas]),
        tuple(torch.stack(xs) for xs in zip(*(d.test_x for d in datas))),
        torch.stack([d.test_y for d in datas]),
        torch.stack([d.test_mask for d in datas]),
        tuple(d.n_train for d in datas))


def init_best(track: str, model: nn.Module, device, folds: int = 0) -> dict:
    """Initial gated-best record (reference init values: ``max_f1 = -1`` /
    ``min_mae = 100``), the metrics as device tensors ([] or, for ``folds``
    stacked folds, [F])."""
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    init = -1.0 if track == "classification" else 100.0
    keys = CLF_BEST if track == "classification" else REG_BEST
    shape = (folds,) if folds else ()
    best = {k: torch.full(shape, -1.0 if k == "epoch" else init,
                          device=device)
            for k in keys}
    best["params"] = params
    return best


def model_fns(model: nn.Module, loss_fn: Callable):
    """:func:`run_fold`'s ``(train_loss, eval_fn)`` for a one-input model:
    ``loss_fn(pred, y, mask)`` on ``model(xs[0], key)`` (``model(xs[0],
    key, rows=rows)`` on a data-parallel rank), and the eval forward
    ``model(xs[0])``."""
    def train_loss(xs, y, mask, key, rows=None):
        pred = (model(xs[0], key) if rows is None
                else model(xs[0], key, rows=rows))
        return loss_fn(pred, y, mask), pred

    def eval_fn(xs):
        return model(xs[0])

    return train_loss, eval_fn


def _where(cond: torch.Tensor, new: torch.Tensor,
           old: torch.Tensor) -> torch.Tensor:
    """``torch.where`` with ``cond`` ([] or [F]) over leading axes."""
    cond = cond.reshape(cond.shape + (1,) * (new.dim() - cond.dim()))
    return torch.where(cond, new, old)


class FoldRun:
    """One fold's training (or F stacked folds'), the counterpart of the
    JAX package's ``make_fold_runner(...)(params, opt_state, data, key,
    best, epoch0)``, with everything it updates in place on the device:
    ``model``'s parameters and ``optimizer``'s state, the dropout ``key``
    (a ``[2]`` threefry key, ``[F, 2]`` stacked; None: no dropout),
    :attr:`best` (the gated metrics and params), :attr:`logs` /
    :attr:`step_losses` over the fold's ``n_epochs`` epochs and the epoch
    counter :attr:`epoch_at`.

    :meth:`epoch` runs one epoch: ``n_steps`` steps of ``train_loss(xs, y,
    mask, key, rows) -> (loss, pred)`` with ``model`` in train mode, then
    ``eval_fn(data.test_x)`` in eval mode without a graph, the metric
    gate, and the epoch's log row.  :meth:`run` runs epochs: on CUDA with
    ``graph`` (the default there) it captures :meth:`epoch` once into a
    CUDA graph -- after a warm-up epoch on copies of the state, which is
    then put back -- and replays it; otherwise it calls :meth:`epoch`.  A
    failed capture raises: there is no fallback.  The kernels' launch
    counters (:mod:`..ops.rnn_cuda`) count the warm-up's calls, and the
    captured calls (:attr:`captured`) once per replay.

    ``n_steps`` (default: the last batch with a valid row in any fold) is
    the steps an epoch takes; a fold-parallel rank takes the steps of all
    folds, so its program and logs are the stacked run's.  ``data_group``
    (a ``torch.distributed`` group): data parallelism over its ranks (the
    module docstring); ``data.train_x`` then holds this rank's rows, the
    rest of ``data`` the whole batch, and ``train_loss`` gets ``rows =
    (first, batch)``, the place of those rows, for its dropout masks
    (None without a group).  The graph route is the default
    there only on NCCL, whose collectives a CUDA graph captures (Gloo's it
    cannot)."""

    def __init__(self, model: nn.Module, optimizer, train_loss: Callable,
                 eval_fn: Callable, data: FoldData, track: str,
                 gate: GateConfig, n_epochs: int,
                 key: Optional[torch.Tensor] = None,
                 graph: Optional[bool] = None,
                 n_steps: Optional[int] = None, data_group=None):
        self.folded = isinstance(data.n_train, tuple)
        n_train = data.n_train if self.folded else (data.n_train,)
        if min(n_train) <= 0:
            raise ValueError("the fold has no training rows")
        self.model, self.optimizer = model, optimizer
        if data.train_y.device.type == "cuda":
            optim.init_state(optimizer)     # a capture must not create it
        self.train_loss, self.eval_fn = train_loss, eval_fn
        self.data, self.gate = data, gate
        self.clf = track == "classification"
        device = data.train_y.device
        self.data_group = data_group
        if graph is None:
            graph = device.type == "cuda" and (
                data_group is None
                or dist.get_backend(data_group) == "nccl")
        self.graph = graph
        if self.graph and device.type != "cuda":
            raise ValueError("a CUDA graph needs the fold on a card")
        self.n_batches, batch = data.train_y.shape[-2:]
        # later batches are all padding
        self.fold_steps = [-(-n // batch) for n in n_train]
        self.n_steps = max(self.fold_steps) if n_steps is None else n_steps
        if self.n_steps < max(self.fold_steps):
            raise ValueError(f"{self.n_steps} steps cut the fold's "
                             f"{max(self.fold_steps)}")
        self.rows = None
        if data_group is not None:
            # this rank's rows: (first, count) of each batch of `batch`
            local = data.train_x[0].shape[2 if self.folded else 1]
            self.rows = (dist.get_rank(data_group) * local, local)
            mask = data.train_mask
            # n_local / n_global of each batch (0 for a batch of padding)
            self.share = (mask.narrow(-1, self.rows[0], local).sum(-1)
                          / torch.clamp(mask.sum(-1), min=1.0))
        self.n_epochs = n_epochs
        self.key = None if key is None else key.to(device).clone()
        folds = len(n_train) if self.folded else 0
        lead = (folds,) if folds else ()
        self.best = init_best(track, model, device, folds)
        self.live = model.state_dict()      # views of the trained params
        n_logs = len(CLF_LOGS if self.clf else REG_LOGS)
        self.logs = torch.zeros(lead + (n_epochs, n_logs), device=device)
        self.step_losses = torch.zeros(lead + (n_epochs, self.n_steps),
                                       device=device)
        self.epoch_done = 0
        self.epoch_at = torch.zeros(1, dtype=torch.int64, device=device)
        # EXACT boundary semantics (JAX loop.py:236-253): the reference
        # tests `train_acc > len(train_idxs) * 0.9` in float64, where 0.9
        # is slightly above 9/10, so `correct == 0.9 * n` does NOT gate;
        # both counts are integers, so compare the exact rational
        # `correct * den > num * n`
        self.frac = Fraction(gate.train_acc_frac).limit_denominator(10000)
        bound = [self.frac.numerator * n for n in n_train]
        self.acc_bound = (torch.tensor(bound, device=device) if folds
                          else bound[0])
        # which folds step at each batch (stacked folds only)
        self.active = [torch.tensor([i < s for s in self.fold_steps],
                                    device=device)
                       for i in range(self.n_steps)] if folds else None
        self._graph = None
        self.captured = {}      # kernel calls in the captured epoch

    # -- the epoch program ------------------------------------------------

    def _split_key(self):
        if self.key is None:
            return None
        key, sub = prng.split2(self.key)
        self.key.copy_(key)
        return sub

    def _batch(self, i: int):
        """Batch ``i``'s (features, labels, mask) as this rank holds them,
        and the place of its rows in the whole batch (None: all of it)."""
        data = self.data
        axis = 1 if self.folded else 0     # the batch index of train_x
        xs = tuple(x.select(axis, i) for x in data.train_x)
        y, mask = data.train_y.select(axis, i), data.train_mask.select(axis, i)
        if self.rows is None:
            return xs, y, mask, None
        first, count = self.rows
        return (xs, y.narrow(-1, first, count), mask.narrow(-1, first, count),
                (first, y.shape[-1]))

    def _whole(self, losses: torch.Tensor, preds: torch.Tensor):
        """The epoch's per-step losses ([..., steps], each rank's share of
        the mean) and train predictions ([..., steps, rows, C], this
        rank's rows) summed over the data group into the whole batch's."""
        first, count = self.rows
        shape = list(preds.shape)
        shape[-2] = self.data.train_y.shape[-1]
        whole = preds.new_zeros(shape)
        whole.narrow(-2, first, count).copy_(preds)
        dist.all_reduce(losses, group=self.data_group)
        dist.all_reduce(whole, group=self.data_group)
        return losses, whole

    def epoch(self) -> None:
        """One epoch, every result written in place (what the graph
        captures)."""
        model, opt = self.model, self.optimizer
        model.train()
        losses, preds = [], []
        for i in range(self.n_steps):
            opt.zero_grad(set_to_none=True)
            sub = self._split_key()
            xs, y, mask, rows = self._batch(i)
            loss, pred = self.train_loss(xs, y, mask, sub, rows)
            if self.rows is not None:
                loss = loss * self.share.select(-1, i)
            (loss.sum() if self.folded else loss).backward()
            if self.rows is not None:
                collectives.all_reduce_grads(model.parameters(),
                                             self.data_group)
            if self.folded:
                opt.step(self.active[i])
            else:
                opt.step()
            losses.append(loss.detach())
            preds.append(pred.detach())
        for _ in range(self.n_batches - self.n_steps):
            self._split_key()    # the JAX scan splits on padding batches
        losses = torch.stack(losses, dim=-1)
        preds = torch.stack(preds, dim=-3)
        if self.rows is not None:
            losses, preds = self._whole(losses, preds)
        model.eval()
        with torch.no_grad():
            test_pred = self.eval_fn(self.data.test_x)
            self._gate(losses, preds, test_pred)

    def _gate(self, losses, preds, test_pred) -> None:
        data, gate, best = self.data, self.gate, self.best
        folded = self.folded
        train_y = data.train_y.narrow(-2, 0, self.n_steps)
        train_mask = data.train_mask.narrow(-2, 0, self.n_steps)
        if self.clf:
            train_correct = (train_mask * (preds.argmax(dim=-1) == train_y)
                             ).sum(dim=(-2, -1))
            tp, fp, fn, tn = M.confusion_counts(
                data.test_y, test_pred.argmax(dim=-1), data.test_mask,
                folded)
            acc, prec, rec, f1 = M.f1_from_counts(tp, fp, fn, tn)
            improve = (f1 >= best["f1"]) if gate.f1_tie_update \
                else (f1 > best["f1"])
            corr = train_correct.to(torch.int64) * self.frac.denominator
            acc_ok = (corr > self.acc_bound) if gate.train_acc_strict \
                else (corr >= self.acc_bound)
            should = improve & acc_ok & (f1 > gate.f1_floor)
            new = {"f1": f1, "accuracy": acc, "precision": prec,
                   "recall": rec}
            row = (losses.sum(dim=-1), train_correct, f1, acc, prec, rec)
        else:
            train_mae = M.masked_mae(train_y, preds.squeeze(-1), train_mask,
                                     folded)
            pred_flat = test_pred.squeeze(-1)
            mae = M.masked_mae(data.test_y, pred_flat, data.test_mask,
                               folded)
            rmse = M.masked_rmse(data.test_y, pred_flat, data.test_mask,
                                 folded)
            should = ((mae <= best["mae"]) & (mae < gate.mae_ceiling)
                      & (train_mae < gate.train_mae_ceiling))
            new = {"mae": mae, "rmse": rmse}
            row = (losses.sum(dim=-1), train_mae, mae, rmse)
        new["epoch"] = self.epoch_at[0].to(torch.float32)
        for k, v in new.items():
            best[k].copy_(torch.where(should, v, best[k]))
        for k, v in self.live.items():
            best["params"][k].copy_(_where(should, v, best["params"][k]))
        at = self.logs.dim() - 2
        row = torch.stack([r.to(torch.float32) for r in row], dim=-1)
        self.logs.index_copy_(at, self.epoch_at, row.unsqueeze(-2))
        self.step_losses.index_copy_(at, self.epoch_at, losses.unsqueeze(-2))
        self.epoch_at.add_(1)

    # -- running it -------------------------------------------------------

    def state_tensors(self) -> list:
        """Every tensor an epoch updates in place."""
        out = list(self.model.parameters())
        out += optim.state_tensors(self.optimizer)
        out += [t for t in (self.key, self.logs, self.step_losses,
                            self.epoch_at) if t is not None]
        out += [v for k, v in self.best.items() if k != "params"]
        out += list(self.best["params"].values())
        return out

    def _capture(self) -> None:
        state = self.state_tensors()
        saved = [t.detach().clone() for t in state]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.epoch()                  # warm-up, then undone below
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        graph = torch.cuda.CUDAGraph()
        before = rnn_cuda.launch_counts()
        with torch.cuda.graph(graph):
            self.epoch()
        # the wrappers counted their calls, but nothing ran: the kernels
        # launch at each replay, and are counted there
        after = rnn_cuda.launch_counts()
        self.captured = {k: after[k] - before[k] for k in after}
        rnn_cuda.add_launches(self.captured, -1)
        self._graph = graph

    def run(self, n: int) -> None:
        """Run the next ``n`` epochs (``n`` graph replays on the graph
        route)."""
        if n > self.n_epochs - self.epoch_done:
            raise ValueError(f"{n} epochs past the fold's {self.n_epochs}")
        if n <= 0:
            return
        if self.graph:
            if self._graph is None:
                self._capture()
            for _ in range(n):
                self._graph.replay()
            rnn_cuda.add_launches(self.captured, n)
        else:
            for _ in range(n):
                self.epoch()
        self.epoch_done += n

    def results(self):
        """``(best, logs, step_losses)`` on the host after one
        device-to-host copy: ``best`` holds the gated metrics as floats
        and, under ``"params"``, the gated state dict on the device;
        ``logs`` one array per metric over the epochs run, ``"steps"`` the
        optimizer steps of each; ``step_losses`` [epochs, steps] the loss
        of every step.  Stacked folds: one such triple per fold."""
        keys = CLF_BEST if self.clf else REG_BEST
        log_keys = CLF_LOGS if self.clf else REG_LOGS
        e = self.epoch_done
        parts = [torch.stack([self.best[k] for k in keys], dim=-1),
                 self.logs.narrow(-2, 0, e).flatten(-2),
                 self.step_losses.narrow(-2, 0, e).flatten(-2)]
        flat = torch.cat(parts, dim=-1).cpu().numpy()
        rows = flat if self.folded else flat[None]
        out = []
        for f, row in enumerate(rows):
            best = {k: float(v) for k, v in zip(keys, row)}
            params = self.best["params"]
            best["params"] = ({k: v[f] for k, v in params.items()}
                              if self.folded else params)
            n_logs = e * len(log_keys)
            table = row[len(keys):len(keys) + n_logs].reshape(
                e, len(log_keys))
            logs = {k: table[:, i] for i, k in enumerate(log_keys)}
            logs["steps"] = np.full(e, float(self.fold_steps[f]), np.float32)
            step_losses = row[len(keys) + n_logs:].reshape(e, self.n_steps)
            if self.folded:
                step_losses = step_losses[:, :self.fold_steps[f]]
            out.append((best, logs, step_losses))
        return out if self.folded else out[0]


def run_fold(model: nn.Module, optimizer, train_loss: Callable,
             eval_fn: Callable, data: FoldData, track: str,
             gate: GateConfig, epochs: int,
             key: Optional[torch.Tensor] = None,
             graph: Optional[bool] = None):
    """Train one fold in place for ``epochs - 1`` epochs (the reference's
    ``range(1, epochs)``) in one :class:`FoldRun` and return its
    :meth:`FoldRun.results`.  ``graph`` (default: on a card) takes the CUDA
    graph route; ``graph=False`` on a card runs the same epochs eagerly."""
    run = FoldRun(model, optimizer, train_loss, eval_fn, data, track, gate,
                  epochs - 1, key, graph)
    run.run(epochs - 1)
    return run.results()
