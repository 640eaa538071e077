"""Fold-stacked models, the counterpart of the JAX package's stacked param
trees under ``jax.vmap`` (``train/trainers.py::_vmapped_fold_results``).

:func:`stack` turns F models of one class and config into one model whose
every parameter carries a leading fold axis ``[F, ...]``; its forward
(the same code: :mod:`..ops.nn`, :mod:`..ops.rnn` and the attention take
parameters with a fold axis) runs on inputs ``[F, ...]`` with keys
``[F, 2]``, and each fold's numbers are the ones its own model gives.
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch
from torch import nn


def stack(models: Sequence[nn.Module]) -> nn.Module:
    """One model holding the parameters of ``models`` (same class and
    config) stacked along a new leading fold axis; ``.folds`` is F."""
    stacked = copy.deepcopy(models[0])
    for name, _ in models[0].named_parameters():
        owner, _, leaf = name.rpartition(".")
        module = stacked.get_submodule(owner)
        module._parameters[leaf] = nn.Parameter(torch.stack(
            [m.get_parameter(name).detach() for m in models]))
    stacked.folds = len(models)
    return stacked

