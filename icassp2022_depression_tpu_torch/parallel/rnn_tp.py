"""Gate-row tensor-parallel GRU and LSTM: the JAX package's ``("model",
None)`` placement of the gate matrices (:func:`.mesh.param_shardings`)
run as a recurrence over the ranks of a mesh's ``model`` axis.

Layout, as :func:`.mesh.shard_params` cuts it: a rank holds rows ``[m R /
M, (m + 1) R / M)`` of ``w_ih`` / ``w_hh`` ``[G*H, ...]`` and of their
biases (the flat split of the ``G*H`` gate rows).  In each layer and
direction a rank

* computes its slice of the input projection ``x @ W_ih^T + b_ih`` for
  every step at once and gathers it once over the model group;
* at each step computes its slice of ``h @ W_hh^T + b_hh`` and gathers it
  (ONE ``all_gather`` a step), then runs the whole cell elementwise, so
  ``h`` (and the LSTM's ``c``) stay the same on every rank of the group.

The two projections are gathered apart, not summed first: the GRU's ``n``
gate takes ``r * (W_hn h + b_hn)``.  The cell math is the serial plain
loop's (:func:`..ops.rnn_cuda.gru_cell`, :func:`..ops.rnn_cuda.lstm_cell`),
and the layer loop, the bidirectional concatenation and the inter-layer
dropout are :func:`..ops.rnn.rnn`'s, so a one-process mesh (no groups)
gives the serial math.  No CUDA kernel runs here: the products are
PyTorch matmuls on the tensors' device, held against the serial path's
``gru_fwd`` / ``lstm_fwd`` kernels.

``dist.all_gather`` carries no gradient, so :func:`rnn_tp` is a forward
only and refuses to run where autograd would record it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from icassp2022_depression_tpu_torch.ops import rnn, rnn_cuda
from icassp2022_depression_tpu_torch.ops.nn import linear
from icassp2022_depression_tpu_torch.parallel import mesh as mesh_mod


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """``t``'s last axis from every rank of ``group`` in rank order (the
    whole gate rows from the ranks' slices); ``t`` itself without a
    group."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def _layer_tp(mesh: mesh_mod.Mesh, p_tp: dict, x: torch.Tensor, cell: str,
              reverse: bool):
    """One direction of one layer on this rank's gate rows ``p_tp`` ->
    (ys [B, T, H], h_last [B, H], c_last [B, H] or None)."""
    group = mesh.model_group
    if reverse:
        x = torch.flip(x, dims=(-2,))
    xp = _gather(linear(x, p_tp["w_ih"], p_tp["b_ih"]), group)  # [B, T, GH]
    w_hh_t = p_tp["w_hh"].t()
    h = x.new_zeros(xp.shape[:-2] + (xp.shape[-1] // rnn.GATES[cell],))
    c = torch.zeros_like(h) if cell == "lstm" else None
    ys = []
    for t in range(x.shape[-2]):
        hp = _gather(torch.matmul(h, w_hh_t) + p_tp["b_hh"], group)
        if cell == "gru":
            h = rnn_cuda.gru_cell(xp[..., t, :], hp, h)
        else:
            h, c = rnn_cuda.lstm_cell(xp[..., t, :] + hp, c)
        ys.append(h)
    ys = torch.stack(ys, dim=-2)
    if reverse:
        ys = torch.flip(ys, dims=(-2,))
    return ys, h, c


def gru_layer_tp(mesh: mesh_mod.Mesh, p_tp: dict, x: torch.Tensor,
                 reverse: bool = False):
    """Tensor-parallel twin of :func:`..ops.rnn.gru_layer`: ``p_tp`` this
    rank's rows of {w_ih, w_hh, b_ih, b_hh}, ``x`` [B, T, D] the same on
    every rank of the model group -> (ys [B, T, H], h_last [B, H]), the
    same on every rank."""
    ys, h, _ = _layer_tp(mesh, p_tp, x, "gru", reverse)
    return ys, h


def lstm_layer_tp(mesh: mesh_mod.Mesh, p_tp: dict, x: torch.Tensor,
                  reverse: bool = False):
    """Tensor-parallel twin of :func:`..ops.rnn.lstm_layer` -> (ys [B, T,
    H], h_last [B, H], c_last [B, H]), the same on every rank."""
    return _layer_tp(mesh, p_tp, x, "lstm", reverse)


def shard_layers(mesh: mesh_mod.Mesh, module: rnn.RNN) -> list:
    """``module.layers()`` with every tensor replaced by this rank's rows
    under :func:`.mesh.shard_params` (views of the parameters)."""
    shards = mesh_mod.shard_params(mesh, module)
    names = {id(p): n for n, p in module.named_parameters()}
    return [{d: {k: shards[names[id(v)]] for k, v in p.items()}
             for d, p in layer.items()} for layer in module.layers()]


def rnn_tp(mesh: mesh_mod.Mesh, layers_tp: Sequence[dict], x: torch.Tensor,
           cell: str = "gru", dropout: float = 0.0, train: bool = False,
           key: Optional[torch.Tensor] = None, rows=None):
    """Tensor-parallel twin of :func:`..ops.rnn.rnn` over ``mesh``'s model
    group: ``layers_tp`` from :func:`shard_layers` (or the layer list of
    :func:`..ops.rnn.init_params` cut by rows), ``x`` [B, T, D] the same on
    every rank of the group.  The inter-layer dropout masks come from
    ``key`` as :func:`..ops.rnn.rnn` draws them, ``rows`` of a larger
    batch.  Returns ``(y, h_n, c_n)`` in :func:`..ops.rnn.rnn`'s layout,
    the same on every rank of the group.

    A forward only: with grad enabled and an input that requires it, it
    raises rather than return gradients that miss the other ranks'
    rows."""
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for layer in layers_tp for p in layer.values()
            for t in p.values())):
        raise RuntimeError(
            "rnn_tp is a forward only (dist.all_gather carries no "
            "gradient): run it under torch.no_grad(), as the fusion's "
            "frozen branches run, or on inputs that do not require grad")

    def direction(p, y, cell_, reverse, backend):
        if cell_ == "gru":
            return gru_layer_tp(mesh, p, y, reverse) + (None,)
        return lstm_layer_tp(mesh, p, y, reverse)

    return rnn.rnn(layers_tp, x, cell, dropout, train, key, "torch", rows,
                   direction)
