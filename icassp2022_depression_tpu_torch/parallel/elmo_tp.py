"""The tensor-parallel LSTMP biLM (port of
:mod:`icassp2022_depression_tpu.parallel.elmo_tp`): the pretrained text
encoder's 4096-wide cell split over the ranks of a mesh's ``model`` axis.

Layout, as in the JAX package (Megatron-style):

* ``w_x [4C, In]`` / ``w_h [4C, P]`` / ``b [4C]`` are reshaped to expose
  the cell axis (``[4, C, ...]``) and cut along it: each rank computes its
  ``C/d`` slice of all four gates from the replicated ``h``;
* the memory cell ``c`` stays cut (``[B, C/d]`` a rank): it is
  elementwise and never communicated;
* ``w_p [P, C]`` is cut along its input (cell) axis: each rank makes a
  partial ``[B, P]`` projection, summed by ONE all-reduce a step, the only
  collective, before the projection clip.

A rank holds and streams ``1/d`` of the weights.  The step is a loop of
PyTorch matmuls, as the JAX package's is a ``lax.scan`` with no Pallas
kernel: the serial path's ``lstmp_fwd`` kernel is what it is held against.
The outputs equal the serial encoder's up to the all-reduce's summation
order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from icassp2022_depression_tpu_torch.models import elmo as elmo_mod
from icassp2022_depression_tpu_torch.parallel import distributed
from icassp2022_depression_tpu_torch.parallel import mesh as mesh_mod


def _axis(mesh: mesh_mod.Mesh, axis: str) -> tuple:
    """(size, this rank's index, group) of ``mesh``'s ``axis``."""
    return (getattr(mesh, axis), getattr(mesh, f"{axis}_index"),
            getattr(mesh, f"{axis}_group"))


def shard_lstmp_params(mesh: mesh_mod.Mesh, p: dict,
                       axis: str = "model") -> dict:
    """This rank's share of one LSTMP cell's params: the gate tensors as
    ``[4, C/d, ...]`` (its slice of the cell axis), ``w_p`` as ``[P,
    C/d]``.  ``C`` must divide by the axis size."""
    c_dim = p["w_x"].shape[0] // 4
    d, index, _ = _axis(mesh, axis)
    if c_dim % d:
        raise AssertionError(f"cell dim {c_dim} not divisible by {axis}={d}")
    size = c_dim // d
    cells = slice(index * size, (index + 1) * size)
    return {
        "w_x": p["w_x"].reshape(4, c_dim, -1)[:, cells].contiguous(),
        "w_h": p["w_h"].reshape(4, c_dim, -1)[:, cells].contiguous(),
        "b": p["b"].reshape(4, c_dim)[:, cells].contiguous(),
        "w_p": p["w_p"][:, cells].contiguous(),
    }


def lstmp_layer_tp(mesh: mesh_mod.Mesh, p_tp: dict, x: torch.Tensor,
                   reverse: bool = False, cell_clip: float = 3.0,
                   proj_clip: float = 3.0, axis: str = "model"):
    """Tensor-parallel twin of :func:`..ops.rnn.lstmp_layer`.

    ``p_tp`` from :func:`shard_lstmp_params`; ``x`` [B, T, In] the same on
    every rank of the axis.  Per step: ``gp = xp_t + h w_h_shard + b``,
    the gates, the cut cell and its clip, the partial projection, one
    all-reduce of ``[B, P]``, then the projection clip.  Returns (ys [B,
    T, P] and h_last [B, P], the same on every rank, and c_last [B, C]
    gathered from the ranks' slices)."""
    _, _, group = _axis(mesh, axis)
    if reverse:
        x = torch.flip(x, dims=(1,))
    b, t_steps, _ = x.shape
    four, size, in_dim = p_tp["w_x"].shape
    p_dim = p_tp["w_p"].shape[0]
    # every step's gate input at once (the serial path's hoisted product)
    xp = torch.matmul(x, p_tp["w_x"].reshape(four * size, in_dim).t())
    xp = xp.reshape(b, t_steps, four, size)
    w_h_t = p_tp["w_h"].reshape(four * size, p_dim).t()
    w_p_t = p_tp["w_p"].t()
    h = x.new_zeros((b, p_dim))
    c = x.new_zeros((b, size))
    ys = []
    for t in range(t_steps):
        gp = xp[:, t] + torch.matmul(h, w_h_t).reshape(b, four, size) \
            + p_tp["b"]
        i = torch.sigmoid(gp[:, 0])
        f = torch.sigmoid(gp[:, 1])
        g = torch.tanh(gp[:, 2])
        o = torch.sigmoid(gp[:, 3])
        c = f * c + i * g
        if cell_clip:
            c = torch.clamp(c, -cell_clip, cell_clip)
        h = torch.matmul(o * torch.tanh(c), w_p_t)     # partial [B, P]
        if group is not None:
            dist.all_reduce(h, group=group)   # the one collective a step
        if proj_clip:
            h = torch.clamp(h, -proj_clip, proj_clip)
        ys.append(h)
    ys = torch.stack(ys, dim=1)
    if reverse:
        ys = torch.flip(ys, dims=(1,))
    if group is not None:
        parts = [torch.empty_like(c) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, c.contiguous(), group=group)
        c = torch.cat(parts, dim=-1)
    return ys, h, c


def shard_encoder_params(mesh: mesh_mod.Mesh, params: dict,
                         axis: str = "model") -> dict:
    """This rank's share of a stacked biLM (``{"layers": [{"fwd",
    "bwd"}, ...]}``, :mod:`..models.elmo`'s layout)."""
    return {"layers": [
        {"fwd": shard_lstmp_params(mesh, layer["fwd"], axis),
         "bwd": shard_lstmp_params(mesh, layer["bwd"], axis)}
        for layer in params["layers"]]}


def encode_lstmp_from_reps_tp(mesh: mesh_mod.Mesh, params_tp: dict,
                              token_reps: torch.Tensor,
                              lengths: torch.Tensor, cfg,
                              axis: str = "model"):
    """Tensor-parallel twin of
    :func:`..models.elmo.encode_lstmp_from_reps` (the shared
    ``bilm_stack`` composition), every direction cut over ``axis``.
    Returns (rep [B, T, 2P], pooled [B, 2P])."""

    def direction(layer, name, x, idx):
        ys, _, _ = lstmp_layer_tp(mesh, layer[name], x, False,
                                  cfg.cell_clip, cfg.proj_clip, axis)
        return ys, None

    rep, pooled, _ = elmo_mod.bilm_stack(params_tp["layers"], token_reps,
                                         lengths, direction)
    return rep, pooled


# -- the product path (``extract-text --elmo-tp N``) ------------------------


def model_mesh(n_devices: int) -> mesh_mod.Mesh:
    """A pure model-parallel ``(data=1, model=n)`` mesh over the first
    ``n_devices`` ranks of the default group: the mesh ``extract-text
    --elmo-tp N`` builds.  Raises when the group is smaller."""
    have = distributed.world_size()
    if have < n_devices:
        raise ValueError(
            f"--elmo-tp {n_devices} needs >= {n_devices} devices but only "
            f"{have} are available (on a single-card host use the serial "
            "encoder; the CLI launches one rank a card, torchrun launches "
            "ranks across hosts, and --device cpu runs Gloo ranks on the "
            "CPU)")
    return mesh_mod.make_mesh(n_devices, model_parallel=n_devices)


def encode_pooled_tp(mesh: mesh_mod.Mesh, cc_params, enc_tp, char_ids,
                     word_ids, lengths, char_cfg, lstmp_cfg,
                     axis: str = "model") -> torch.Tensor:
    """Tensor-parallel twin of
    :func:`..models.elmo_pretrained.encode_pooled`: the char-CNN token
    embedder (the same on every rank), the TP biLM, then the mean over
    each row's real tokens -> pooled [B, 2P]."""
    from icassp2022_depression_tpu_torch.models import char_cnn
    from icassp2022_depression_tpu_torch.models import elmo_pretrained

    reps = char_cnn.embed_tokens(cc_params, char_ids, char_cfg, word_ids)
    rep, _ = encode_lstmp_from_reps_tp(mesh, enc_tp, reps, lengths,
                                       lstmp_cfg, axis)
    return elmo_pretrained._interior_mean(rep, lengths)


def make_tp_encode(mesh: mesh_mod.Mesh, params: dict, cfg,
                   axis: str = "model"):
    """An ``encode(params, ids, lengths, cfg) -> (rep, pooled)`` drop-in
    for :func:`..models.elmo.encode_lstmp` (the hashed-token encoders: the
    seeded stand-in, explicit params) that runs the biLM tensor-parallel
    over ``axis``.  ``params`` is a serial param tree with its ``embed``
    table; the encoder weights are cut once, here."""
    enc_tp = shard_encoder_params(mesh, params, axis)
    embed = params["embed"]

    def encode(_params, token_ids, lengths, _cfg):
        return encode_lstmp_from_reps_tp(mesh, enc_tp, embed[token_ids],
                                         lengths, cfg, axis)

    return encode
