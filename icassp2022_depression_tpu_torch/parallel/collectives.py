"""The data-parallel training step with explicit collectives (port of
:mod:`icassp2022_depression_tpu.parallel.collectives`).

Each rank of a data group holds some rows of the global batch and a
replica of the model and optimizer.  :func:`dp_train_step` computes the
rank's loss, scales it by its share of the global valid rows, all-reduces
the gradients (SUM) and steps the replicated optimizer, so every replica
makes the update of the global-batch mean.  :func:`psum_metrics` sums a
tree of metrics over the group.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from icassp2022_depression_tpu_torch.ops import prng


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
            return total, pred.detach()
        return torch.zeros_like(total), pred.detach()

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
