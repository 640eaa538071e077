"""The ``(data, model)`` grid of ranks and the tensor-parallel placement
rule (port of :mod:`icassp2022_depression_tpu.parallel.mesh`).

The JAX package lays its devices out as a 2D mesh and annotates shardings
on it: ``data`` splits the batch axis, ``model`` the RNN gate matrices'
rows.  Here a device is a rank of the default ``torch.distributed``
group: :func:`make_mesh` puts the first ``n_devices`` ranks on the grid
and makes the row and column subgroups the collectives run in,
:func:`batch_sharding` gives a rank its rows of a batch, and
:func:`param_shardings` states which parameters the gate-row tensor
parallelism would split (the rule the JAX package's ``_param_spec``
applies).  The gate-row tensor-parallel RNN step itself is reached in the
JAX package only from its dry runs and benchmark, not from its CLI, and
is not ported; the tensor-parallel biLM that the CLI runs is
:mod:`.elmo_tp`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

from icassp2022_depression_tpu_torch.parallel import distributed


class Mesh(NamedTuple):
    """A rank's place in a ``(data, model)`` grid of ``n_devices`` ranks
    (rank ``r`` at ``(r // model, r % model)``): ``data_group`` holds the
    ranks of its column (same model index), ``model_group`` those of its
    row (same data index).  A one-process mesh has no groups."""

    data: int
    model: int
    data_index: int
    model_index: int
    data_group: Optional[object]
    model_group: Optional[object]

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}


def make_mesh(n_devices: Optional[int] = None,
              model_parallel: int = 1) -> Mesh:
    """2D ``(data, model)`` grid over the first ``n_devices`` ranks of the
    default group (all of them by default); ``model_parallel=1`` is pure
    data parallelism.  Every rank of the group calls it (it makes the
    subgroups); a rank beyond ``n_devices`` gets no groups."""
    world = distributed.world_size()
    if n_devices is None:
        n_devices = world
    if n_devices % model_parallel:
        raise AssertionError(f"{n_devices} devices not divisible by "
                             f"model_parallel={model_parallel}")
    if n_devices > world:
        raise AssertionError(f"a mesh of {n_devices} devices needs "
                             f"{n_devices} ranks, have {world}")
    data = n_devices // model_parallel
    r = distributed.rank()
    data_group = model_group = None
    if world > 1:
        for m in range(model_parallel):
            g = dist.new_group(list(range(m, n_devices, model_parallel)))
            if r < n_devices and r % model_parallel == m:
                data_group = g
        for d in range(data):
            g = dist.new_group(list(range(d * model_parallel,
                                          (d + 1) * model_parallel)))
            if r < n_devices and r // model_parallel == d:
                model_group = g
    return Mesh(data, model_parallel, r // model_parallel,
                r % model_parallel, data_group, model_group)


def batch_sharding(mesh: Mesh, x: torch.Tensor,
                   batch_axis: int = 0) -> torch.Tensor:
    """This rank's rows of ``x``: the ``data``-th of ``mesh.data`` equal
    slices of its ``batch_axis``."""
    n = x.shape[batch_axis]
    if n % mesh.data:
        raise AssertionError(f"batch of {n} not divisible by "
                             f"data={mesh.data}")
    rows = n // mesh.data
    return x.narrow(batch_axis, mesh.data_index * rows, rows)


#: the RNN gate parameters (``nn.GRU`` / ``nn.LSTM`` names, ``[G*H, ...]``)
_GATE_MATRICES = ("weight_ih", "weight_hh")
_GATE_BIASES = ("bias_ih", "bias_hh")


def _param_spec(name: str, leaf: torch.Tensor, model_size: int) -> tuple:
    """Tensor-parallel placement of one parameter: the RNN gate matrices
    (``weight_ih_l*`` / ``weight_hh_l*``, ``[G*H, ...]``) and their biases
    split their rows over ``model`` when divisible; everything else -- tiny
    heads like ``[num_classes, H]`` included -- is replicated (``()``)."""
    leafname = name.rpartition(".")[2]
    if leafname.startswith(_GATE_MATRICES) and leaf.dim() == 2 and \
            leaf.shape[0] % model_size == 0:
        return ("model", None)
    if leafname.startswith(_GATE_BIASES) and leaf.dim() == 1 and \
            leaf.shape[0] % model_size == 0:
        return ("model",)
    return ()


def param_shardings(mesh: Mesh, model: nn.Module) -> dict:
    """The placement of every parameter of ``model`` by name (a
    ``PartitionSpec``'s entries as a tuple).  With a ``model`` axis of 1
    the rule still names the gate rows, which then split one way."""
    return {name: _param_spec(name, p, mesh.model)
            for name, p in model.named_parameters()}
