"""The data-parallel training steps with explicit collectives (port of
:mod:`icassp2022_depression_tpu.parallel.collectives`).

Each rank of a data group holds some rows of the global batch and a
replica of the model and optimizer.  :func:`dp_train_step` computes the
rank's loss, scales it by its share of the global valid rows, all-reduces
the gradients (SUM) and steps the replicated optimizer, so every replica
makes the update of the global-batch mean.  :func:`dp_tp_train_step` is
the clf fusion's step on a ``(data, model)`` mesh: the same update over
the data group, with the frozen branches' recurrences split over the
model group by gate rows (:mod:`.rnn_tp`), the port's counterpart of the
JAX package's GSPMD step in ``dryrun_multichip``.  :func:`psum_metrics`
sums a tree of metrics over the group.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from icassp2022_depression_tpu_torch.models import losses
from icassp2022_depression_tpu_torch.models.fusion import FusionNet
from icassp2022_depression_tpu_torch.ops import prng
from icassp2022_depression_tpu_torch.parallel import mesh as mesh_mod
from icassp2022_depression_tpu_torch.parallel import rnn_tp


def all_reduce_grads(params, group=None) -> None:
    """SUM the gradients of ``params`` over ``group`` in place, as one
    flat buffer (one collective).  Parameters without a gradient (frozen
    ones) take no part; which have one is the same on every rank."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()


def dp_train_step(model: nn.Module, train_loss_fn: Callable, optimizer,
                  group=None) -> Callable:
    """A data-parallel step over ``group`` (default: the whole default
    group): ``step(key, xs, y, mask) -> (loss, pred)`` on this rank's rows
    ``xs`` / ``y`` / ``mask``, updating ``model`` and ``optimizer`` in
    place.

    ``train_loss_fn(xs, y, mask, key) -> (loss, pred)`` computes a masked
    mean over its rows.  Each rank draws its own dropout masks: the
    replicated ``key`` is folded with the rank's index in ``group``
    (``fold_in(key, rank)``, with the port's threefry).  The local mean is
    scaled by ``n_local / n_global`` (valid rows), so the SUM of the
    ranks' gradients is the global-batch mean's gradient; the returned
    loss is the global mean.  When the global batch has no valid row the
    step is an exact no-op: the optimizer does not step, so neither the
    parameters, nor its step count, nor the weight decay move, and the
    loss is 0."""
    params = [p for p in model.parameters() if p.requires_grad]

    def step(key: Optional[torch.Tensor], xs, y, mask):
        if key is not None:
            key = prng.fold_in(key, dist.get_rank(group))
        optimizer.zero_grad(set_to_none=True)
        loss, pred = train_loss_fn(xs, y, mask, key)
        return _global_mean_update(loss, mask, params, optimizer,
                                   group), pred.detach()

    return step


def _global_mean_update(loss: torch.Tensor, mask: torch.Tensor, params,
                        optimizer, group) -> torch.Tensor:
    """Scale this rank's masked-mean ``loss`` by its share of the valid
    rows of ``group``'s global batch, backward, SUM the gradients over
    ``group`` and step -> the global loss (0, and no step, when no row of
    the global batch is valid)."""
    n_local = mask.to(torch.float32).sum()
    n_global = n_local.clone()
    dist.all_reduce(n_global, group=group)
    scale = torch.where(n_global > 0,
                        n_local / torch.clamp(n_global, min=1.0),
                        torch.zeros_like(n_global))
    scaled = loss * scale
    scaled.backward()
    all_reduce_grads(params, group)
    total = scaled.detach().clone()
    dist.all_reduce(total, group=group)
    if float(n_global) > 0:
        optimizer.step()
        return total
    return torch.zeros_like(total)


def dp_tp_train_step(model: FusionNet, mesh: mesh_mod.Mesh,
                     optimizer) -> Callable:
    """The clf fusion's DP x TP step on ``mesh``: ``step(key, x_audio,
    x_text, y, mask) -> (loss, text_feature, audio_feature)`` on this
    rank's rows (its data index's slice of the global batch, the same on
    every rank of its model group), updating ``model`` and ``optimizer``
    in place.

    Global-batch semantics, as the JAX package's GSPMD step: the one
    replicated ``key`` is split 6 ways as :meth:`FusionNet.
    pretrained_feature` splits it and every mask is drawn for the global
    batch, this rank taking its rows (no ``fold_in`` of the rank, unlike
    :func:`dp_train_step`).  The frozen branches' GRU and BiLSTM run
    through :func:`.rnn_tp.rnn_tp` on this rank's gate rows.  The loss is
    ``myloss_ce`` over this rank's rows scaled by ``n_local / n_global``;
    ``fc_final``'s gradient is SUMmed over ``mesh.data_group`` only (the
    model group's ranks hold the same rows), then the optimizer steps on
    every rank.  The returned loss is the global mean."""
    params = [p for p in model.parameters() if p.requires_grad]
    recurrences = []
    for module in (model.lstm_net, model.lstm_net_audio):
        layers = rnn_tp.shard_layers(mesh, module)

        def run(x, key, rows, module=module, layers=layers):
            return rnn_tp.rnn_tp(mesh, layers, x, module.cell,
                                 module.dropout, module.training, key, rows)

        recurrences.append(run)

    def step(key: Optional[torch.Tensor], x_audio, x_text, y, mask):
        n = x_audio.shape[0]
        optimizer.zero_grad(set_to_none=True)
        tf, af = model.pretrained_feature(
            x_audio, x_text, key, (mesh.data_index * n, mesh.data * n),
            *recurrences)
        loss = losses.myloss_ce(tf, af, y, model.fc_final[0].weight,
                                model.cfg.text_hidden_dims, mask)
        return _global_mean_update(loss, mask, params, optimizer,
                                   mesh.data_group), tf, af

    return step


def psum_metrics(tree, group=None):
    """A tree (dicts, lists, tuples) of metric tensors summed over
    ``group``; the input is left as it was."""
    if isinstance(tree, torch.Tensor):
        out = tree.detach().clone()
        dist.all_reduce(out, group=group)
        return out
    if isinstance(tree, dict):
        return {k: psum_metrics(v, group) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(psum_metrics(v, group) for v in tree)
    return tree
