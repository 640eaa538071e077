"""Rank programs that run one piece of :mod:`..parallel` on a launched
group and hand back host numbers to compare with a single process (the
port's counterpart of the JAX repo's ``scripts/multihost_dryrun.py``).

Launch them with :func:`.distributed.launch`, e.g. ``launch(dp_step, 2,
["cpu"] * 2, args=(tcfg, x, y, mask))``, or several in one launch with
:func:`several`; each runs on its rank's device
(:func:`..utils.device.default_device`).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from icassp2022_depression_tpu_torch.models import losses
from icassp2022_depression_tpu_torch.models.elmo_pretrained import tree_to
from icassp2022_depression_tpu_torch.models.fusion import FusionNet
from icassp2022_depression_tpu_torch.ops import prng, rnn
from icassp2022_depression_tpu_torch.parallel import (
    collectives as coll,
    distributed,
    elmo_tp,
    mesh as mesh_mod,
    rnn_tp as rnn_tp_mod,
)
from icassp2022_depression_tpu_torch.utils.device import default_device


def several(calls) -> list:
    """Run ``fn(*args, **kwargs)`` for each ``(fn, args, kwargs)`` of
    ``calls`` in turn (module-level functions of this package: these rank
    programs, the trainers, ...) -> their values: one launch, one
    group, for many checks."""
    return [fn(*args, **kwargs) for fn, args, kwargs in calls]


def collectives(n: int = 8) -> dict:
    """Each collective the port uses, on tensors of ``n`` floats on the
    rank's device (rank r holds ``arange(n) + r``): ``all_reduce`` (SUM),
    ``broadcast`` from rank 0, ``all_gather``, and the host objects'
    ``all_gather_object`` and ``broadcast_object_list``; the all-reduce
    through :func:`.collectives.psum_metrics`."""
    device = default_device()
    r, world = distributed.rank(), distributed.world_size()
    x = torch.arange(n, dtype=torch.float32, device=device) + r
    total = coll.psum_metrics({"x": x})["x"]
    first = x.clone()
    dist.broadcast(first, 0)
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    objects = [None] * world
    dist.all_gather_object(objects, {"rank": r})
    sent = [{"from": r}]
    dist.broadcast_object_list(sent, 0)
    return {"device": str(x.device), "all_reduce": total,
            "broadcast": first, "all_gather": torch.stack(parts),
            "all_gather_object": objects,
            "broadcast_object_list": sent[0]}


def _audio_model(tcfg, seed: int, device, init_sd=None):
    from icassp2022_depression_tpu_torch.train import loop, optim, trainers

    model = trainers.init_model(tcfg, seed, 1, device)
    if init_sd is not None:
        model.load_state_dict(init_sd, strict=True)
    optimizer = optim.build(tcfg.optimizer, model)
    train_loss, _ = loop.model_fns(model, trainers._branch_fns(tcfg))
    return model, optimizer, train_loss


def _step_result(model, optimizer, loss, pred) -> dict:
    return {"loss": float(loss),
            "param_l1": float(sum(p.detach().abs().sum()
                                  for p in model.parameters())),
            "adam_steps": [float(st["step"]) for st in
                           optimizer.state.values() if "step" in st],
            "params": {k: v.detach().clone()
                       for k, v in model.state_dict().items()},
            "pred": pred}


def dp_step(tcfg, x, y, mask, seed: int = 0, key_seed: int = 9,
            init_sd=None) -> dict:
    """One :func:`.collectives.dp_train_step` of fold 1's audio model
    (``tcfg``, init seed ``seed``, or the state dict ``init_sd``) over the
    default group, pure data parallelism (:func:`.mesh.make_mesh`): this
    rank's rows of the global batch ``x`` [B, 3, D] / ``y`` / ``mask``
    (numpy), the dropout key ``PRNGKey(key_seed)``.  Returns the global
    loss, the L1 norm of the updated parameters, the optimizer's step
    counts, the updated parameters and this rank's predictions."""
    device = default_device()
    model, optimizer, train_loss = _audio_model(tcfg, seed, device, init_sd)
    mesh = mesh_mod.make_mesh()

    def rows(a):
        return mesh_mod.batch_sharding(mesh, torch.as_tensor(
            np.asarray(a), device=device))

    step = coll.dp_train_step(model, train_loss, optimizer,
                              mesh.data_group)
    loss, pred = step(prng.prng_key(key_seed, device), (rows(x),), rows(y),
                      rows(mask))
    return _step_result(model, optimizer, loss, pred)


def dp_step_reference(tcfg, x, y, mask, shards: int, seed: int = 0,
                      key_seed: int = 9, device=None) -> dict:
    """:func:`dp_step` in one process: each of ``shards`` equal row blocks
    of the batch through the model with its own key ``fold_in(key,
    shard)``, the blocks' losses weighted by their share of the valid
    rows and summed, then one optimizer step (none when no row is
    valid)."""
    device = default_device() if device is None else torch.device(device)
    model, optimizer, train_loss = _audio_model(tcfg, seed, device)
    key = prng.prng_key(key_seed, device)
    x, y, mask = (torch.as_tensor(np.asarray(a), device=device)
                  for a in (x, y, mask))
    n = float(mask.sum())
    optimizer.zero_grad(set_to_none=True)
    total, preds = 0.0, []
    for s, (xs, ys, ms) in enumerate(zip(x.chunk(shards), y.chunk(shards),
                                         mask.chunk(shards))):
        loss, pred = train_loss((xs,), ys, ms, prng.fold_in(key, s))
        total = total + loss * (float(ms.sum()) / max(n, 1.0))
        preds.append(pred.detach())
    total.backward()
    if n > 0:
        optimizer.step()
    return _step_result(model, optimizer, total.detach() if n > 0 else 0.0,
                        torch.cat(preds))


def rnn_tp(layers, x, cell: str, dropout: float = 0.0, key_seed=None,
           model_parallel: int = 2) -> tuple:
    """:func:`.rnn_tp.rnn_tp` in train mode of the layer list ``layers``
    (:func:`..ops.rnn.init_params`' layout, host arrays) over a ``(data,
    model_parallel)`` mesh of the whole group: this rank's rows of ``x``
    [B, T, D] with the masks of ``PRNGKey(key_seed)`` (none for None) ->
    (y, h_n, c_n) of those rows."""
    device = default_device()
    module = rnn.RNN(x.shape[-1], layers[0]["fwd"]["w_hh"].shape[1],
                     len(layers), len(layers[0]) == 2, dropout, cell,
                     device=device)
    with torch.no_grad():
        for src, dst in zip(layers, module.layers()):
            for d, p in dst.items():
                for k, t in p.items():
                    t.copy_(torch.as_tensor(np.asarray(src[d][k])))
    mesh = mesh_mod.make_mesh(model_parallel=model_parallel)
    xs = mesh_mod.batch_sharding(mesh, torch.as_tensor(np.asarray(x),
                                                       device=device))
    key = None if key_seed is None else prng.prng_key(key_seed, device)
    n = xs.shape[0]
    with torch.no_grad():
        return rnn_tp_mod.rnn_tp(mesh, rnn_tp_mod.shard_layers(mesh, module),
                                 xs, cell, dropout, True, key,
                                 (mesh.data_index * n, mesh.data * n))


def _fusion(fcfg, tcfg, state_dict, device):
    from icassp2022_depression_tpu_torch.train import optim

    model = FusionNet(fcfg, None, device)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in state_dict.items()}, strict=True)
    model.train()
    return model, optim.build(tcfg.optimizer, model)


def _fusion_result(model, state_dict, loss, tf, af, t0: float) -> dict:
    loss = float(loss.detach())             # waits for the step
    seconds = time.perf_counter() - t0
    w = model.fc_final[0].weight
    frozen = [(k, v) for k, v in model.state_dict().items()
              if k != "fc_final.0.weight"]
    return {"loss": loss, "step_s": seconds, "tf": tf.detach(),
            "af": af.detach(), "grad": w.grad.detach().clone(),
            "fc_final": w.detach().clone(),
            "frozen_l1": float(sum(v.abs().sum() for _, v in frozen)),
            "frozen_same": all(torch.equal(v.cpu(), torch.as_tensor(
                np.asarray(state_dict[k]))) for k, v in frozen)}


def _as_tensors(device, *arrays):
    return [torch.as_tensor(np.asarray(a), device=device) for a in arrays]


def dp_tp_fusion_step(fcfg, tcfg, state_dict, x_audio, x_text, y, mask,
                      key_seed: int = 1, model_parallel: int = 2) -> dict:
    """One :func:`.collectives.dp_tp_train_step` of the clf fusion
    ``fcfg`` (optimizer of ``tcfg``) from ``state_dict`` over a ``(data,
    model_parallel)`` mesh of the whole group, as the JAX package's
    ``dryrun_multichip`` lays its devices out: this rank's rows of the
    global batch ``x_audio`` [B, T, Da] / ``x_text`` [B, T, Dt] / ``y`` /
    ``mask`` (host arrays), the key ``PRNGKey(key_seed)``.  Returns the
    global loss, this rank's ``tf`` / ``af``, ``fc_final``'s gradient and
    updated weight, the L1 of the frozen parameters and whether each
    equals ``state_dict``'s bitwise, and the step's wall time."""
    device = default_device()
    model, optimizer = _fusion(fcfg, tcfg, state_dict, device)
    mesh = mesh_mod.make_mesh(model_parallel=model_parallel)
    step = coll.dp_tp_train_step(model, mesh, optimizer)
    args = [mesh_mod.batch_sharding(mesh, a) for a in _as_tensors(
        device, x_audio, x_text, y, mask)]
    t0 = time.perf_counter()
    loss, tf, af = step(prng.prng_key(key_seed, device), *args)
    return _fusion_result(model, state_dict, loss, tf, af, t0)


def dp_tp_fusion_step_reference(fcfg, tcfg, state_dict, x_audio, x_text, y,
                                mask, key_seed: int = 1,
                                device=None) -> dict:
    """:func:`dp_tp_fusion_step` in one process through the serial
    :meth:`FusionNet.pretrained_feature` (on a card: the ``gru_fwd`` and
    ``lstm_fwd`` kernels): the global batch's ``myloss_ce``, its gradient
    and one optimizer step."""
    device = default_device() if device is None else torch.device(device)
    model, optimizer = _fusion(fcfg, tcfg, state_dict, device)
    x_audio, x_text, y, mask = _as_tensors(device, x_audio, x_text, y, mask)
    t0 = time.perf_counter()
    optimizer.zero_grad(set_to_none=True)
    tf, af = model.pretrained_feature(x_audio, x_text,
                                      prng.prng_key(key_seed, device))
    loss = losses.myloss_ce(tf, af, y, model.fc_final[0].weight,
                            fcfg.text_hidden_dims, mask)
    loss.backward()
    optimizer.step()
    return _fusion_result(model, state_dict, loss, tf, af, t0)


def cli_main(argv, presets: dict) -> tuple:
    """``cli.main(argv)`` on this rank of a launched group (the command
    runs on the group, as under ``torchrun``), the config module's presets
    named in ``presets`` replaced by their values there -> (exit code,
    rank 0's standard output, the code of a ``SystemExit`` or None)."""
    from icassp2022_depression_tpu_torch import cli
    from icassp2022_depression_tpu_torch import config as C

    for name, value in presets.items():
        getattr(C, name)                # a preset the module has
        setattr(C, name, value)
    return cli._rank_main(argv)


def lstmp_tp(p: dict, x, reverse: bool = False, cell_clip: float = 3.0,
             proj_clip: float = 3.0) -> tuple:
    """:func:`.elmo_tp.lstmp_layer_tp` of the LSTMP cell ``p`` (host
    arrays, cut here) on ``x`` [B, T, In] over a model mesh of the whole
    group -> (ys, h_last, c_last)."""
    device = default_device()
    mesh = elmo_tp.model_mesh(distributed.world_size())
    p_tp = elmo_tp.shard_lstmp_params(mesh, tree_to(p, device))
    return elmo_tp.lstmp_layer_tp(mesh, p_tp, torch.as_tensor(
        np.asarray(x), device=device), reverse, cell_clip, proj_clip)


def encode_tp(params: dict, reps, lengths, cfg) -> tuple:
    """:func:`.elmo_tp.encode_lstmp_from_reps_tp` of the biLM ``params``
    (``{"layers": ...}``, host arrays) on ``reps`` [B, T, In] over a model
    mesh of the whole group -> (rep, pooled)."""
    device = default_device()
    mesh = elmo_tp.model_mesh(distributed.world_size())
    params_tp = elmo_tp.shard_encoder_params(mesh, tree_to(params, device))
    return elmo_tp.encode_lstmp_from_reps_tp(
        mesh, params_tp, torch.as_tensor(np.asarray(reps), device=device),
        torch.as_tensor(np.asarray(lengths), device=device), cfg)


def embed(sentences, elmo_tp_ranks: int, **kw) -> tuple:
    """:func:`..frontend.text.make_embedder` with ``elmo_tp`` (and
    ``kw``) on the rank's device, applied to ``sentences`` -> (embeddings,
    embedder id)."""
    from icassp2022_depression_tpu_torch.frontend import text

    fn, _, ident = text.make_embedder(with_id=True, elmo_tp=elmo_tp_ranks,
                                      **kw)
    return fn(sentences), ident
