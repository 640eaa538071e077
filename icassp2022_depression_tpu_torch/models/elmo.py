"""ELMo-style sentence encoders (port of
:mod:`icassp2022_depression_tpu.models.elmo`).

Two encoders, both ``[B, T]`` inputs with per-row ``lengths`` -> per-token
``[B, T, 1024]`` and a masked-mean ``[B, 1024]``:

* the stand-in (:class:`ElmoConfig`, :func:`init`, :func:`encode`): hashed
  token ids -> embedding -> 2-layer BiLSTM (512 per direction) through the
  port's LSTM seam (:func:`..ops.rnn.lstm_layer`: the ``lstm_fwd`` CUDA
  kernel on a card);
* the ELMo-faithful biLM (:class:`ElmoLstmpConfig`, :func:`bilm_stack`,
  :func:`encode_lstmp_from_reps`): stacked LSTMP layers
  (:func:`..ops.rnn.lstmp_layer`: the ``lstmp_fwd`` CUDA kernel on a card)
  with residuals between layers, averaged with the token layer; and its
  stateful twin (:func:`encode_lstmp_from_reps_stateful`), whose layers
  start from carried states (:func:`..ops.rnn.lstmp_layer_stateful`, a
  plain step loop).

The backward direction of a padded batch reverses each row by its own
length (:func:`reverse_padded`), so padding never reaches a real token; the
cells are always called with ``reverse=False`` on those reversed rows.

The seeded weights (:func:`init`, :func:`init_lstmp_encoder`) are drawn
with the port's threefry in the JAX package's order, so a provenance id
``prng:seed=S`` / ``prng-lstmp:seed=S`` names the same weights in both
packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Mapping

import numpy as np
import torch

from icassp2022_depression_tpu_torch.ops import prng
from icassp2022_depression_tpu_torch.ops import rnn as rnn_ops


@dataclasses.dataclass(frozen=True)
class ElmoConfig:
    vocab_size: int = 32768      # hash buckets
    embed_dim: int = 256
    hidden: int = 512            # per direction; output = 2 * hidden = 1024
    layers: int = 2
    output_dim: int = 1024


def token_id(token: str, vocab_size: int = 32768) -> int:
    """Stable cross-run hash bucket for a token (md5, not Python hash)."""
    h = hashlib.md5(token.encode("utf-8")).digest()
    return int.from_bytes(h[:8], "little") % vocab_size


def _embedding(key: torch.Tensor, rows: int, dim: int) -> torch.Tensor:
    return prng.normal(key, (rows, dim)) * float(np.float32(1.0 / np.sqrt(dim)))


def _torch_lstm_layer(key: torch.Tensor, hidden: int, input_size: int):
    """``initializers.torch_rnn_layer`` (4 gates) on threefry keys."""
    k1, k2, k3, k4 = prng.split(key, 4)
    bound = 1.0 / np.sqrt(hidden)
    g = 4 * hidden
    return {"w_ih": prng.uniform(k1, (g, input_size), -bound, bound),
            "w_hh": prng.uniform(k2, (g, hidden), -bound, bound),
            "b_ih": prng.uniform(k3, (g,), -bound, bound),
            "b_hh": prng.uniform(k4, (g,), -bound, bound)}


def init(key: torch.Tensor, cfg: ElmoConfig = ElmoConfig()) -> dict:
    """The stand-in's seeded weights (``elmo.init``), on the key's
    device."""
    k_embed, k_rnn = prng.split(key, 2)
    keys = prng.split(k_rnn, 2 * cfg.layers)
    return {
        "embed": _embedding(k_embed, cfg.vocab_size, cfg.embed_dim),
        "rnn": [{d: _torch_lstm_layer(keys[2 * layer + j], cfg.hidden,
                                      cfg.embed_dim if layer == 0
                                      else 2 * cfg.hidden)
                 for j, d in enumerate(("fwd", "bwd"))}
                for layer in range(cfg.layers)],
    }


def reverse_padded(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each row's first ``lengths[b]`` positions; padding stays
    put."""
    b, t = x.shape[0], x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    n = lengths.to(x.device)[:, None]
    rev = torch.where(pos < n, n - 1 - pos, pos)
    idx = rev.reshape(b, t, *([1] * (x.dim() - 2))).expand_as(x)
    return torch.gather(x, 1, idx)


def _masked_mean(y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.to(y.dtype)
    return (y * mask[:, :, None]).sum(dim=1) / \
        mask.sum(dim=1, keepdim=True).clamp_min(1.0)


def _valid(t: int, lengths: torch.Tensor) -> torch.Tensor:
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


def encode(params: Mapping, token_ids: torch.Tensor, lengths: torch.Tensor,
           cfg: ElmoConfig = ElmoConfig(), backend: str = "auto"):
    """[B, T] token ids + [B] lengths -> per-token [B, T, 1024] and
    mean-pooled [B, 1024] sentence embeddings (the stand-in encoder)."""
    y = params["embed"][token_ids]
    for layer in params["rnn"]:
        yf, _, _ = rnn_ops.lstm_layer(layer["fwd"], y, False, backend)
        yb, _, _ = rnn_ops.lstm_layer(layer["bwd"],
                                      reverse_padded(y, lengths), False,
                                      backend)
        y = torch.cat([yf, reverse_padded(yb, lengths)], dim=-1)
    return y, _masked_mean(y, _valid(token_ids.shape[1], lengths))


@dataclasses.dataclass(frozen=True)
class ElmoLstmpConfig:
    """The zhs ELMoForManyLangs biLM geometry: 512-d token streams, 4096
    cells with 512 projections per direction, 2 layers, residual between
    layers, +-3 cell/projection clipping."""

    vocab_size: int = 32768
    input_dim: int = 512
    cell_size: int = 4096
    proj_size: int = 512
    layers: int = 2
    cell_clip: float = 3.0
    proj_clip: float = 3.0

    @property
    def output_dim(self) -> int:
        return 2 * self.proj_size


def init_lstmp_encoder(key: torch.Tensor,
                       cfg: ElmoLstmpConfig = ElmoLstmpConfig()) -> dict:
    """Seeded biLM weights (``elmo.init_lstmp_encoder``), on the key's
    device."""
    keys = prng.split(key, 1 + 2 * cfg.layers)
    layers = []
    for layer in range(cfg.layers):
        in_dim = cfg.input_dim if layer == 0 else cfg.proj_size
        layers.append({d: rnn_ops.init_lstmp(keys[1 + 2 * layer + j], in_dim,
                                             cfg.cell_size, cfg.proj_size)
                       for j, d in enumerate(("fwd", "bwd"))})
    return {"embed": _embedding(keys[0], cfg.vocab_size, cfg.input_dim),
            "layers": layers}


def bilm_stack(layers, token_reps: torch.Tensor, lengths: torch.Tensor,
               direction_fn):
    """The stacked-biLM composition (upstream ``ElmobiLm`` / allennlp
    ``ElmoLstm``): per layer, ``direction_fn(layer, name, x, idx) -> (ys,
    aux)`` on the forward stream and on the length-reversed backward
    stream, the reversal undone, residuals from the second layer on; the
    ELMo layers ([emb; emb] and every LSTMP layer) averaged, then
    masked-mean-pooled.  Returns (rep [B, T, 2P], pooled [B, 2P], the
    per-layer ``(fwd aux, bwd aux)`` pairs)."""
    e = token_reps
    f_in, b_in = e, e
    layer_reps = [torch.cat([e, e], dim=-1)]
    auxes = []
    for idx, layer in enumerate(layers):
        f_out, f_aux = direction_fn(layer, "fwd", f_in, idx)
        b_rev, b_aux = direction_fn(layer, "bwd",
                                    reverse_padded(b_in, lengths), idx)
        b_out = reverse_padded(b_rev, lengths)
        if idx > 0:
            f_out = f_out + f_in
            b_out = b_out + b_in
        layer_reps.append(torch.cat([f_out, b_out], dim=-1))
        auxes.append((f_aux, b_aux))
        f_in, b_in = f_out, b_out
    rep = sum(layer_reps) / len(layer_reps)
    return (rep, _masked_mean(rep, _valid(token_reps.shape[1], lengths)),
            auxes)


def encode_lstmp_from_reps(params: Mapping, token_reps: torch.Tensor,
                           lengths: torch.Tensor,
                           cfg: ElmoLstmpConfig = ElmoLstmpConfig(),
                           backend: str = "auto"):
    """Precomputed [B, T, In] token representations (e.g. the char-CNN's)
    through the stacked LSTMP biLM -> (per-token [B, T, 2P], pooled
    [B, 2P])."""

    def direction(layer, name, x, idx):
        ys, _, _ = rnn_ops.lstmp_layer(layer[name], x, False, cfg.cell_clip,
                                       cfg.proj_clip, backend)
        return ys, None

    rep, pooled, _ = bilm_stack(params["layers"], token_reps, lengths,
                                direction)
    return rep, pooled


def encode_lstmp_from_reps_stateful(params: Mapping, token_reps: torch.Tensor,
                                    lengths: torch.Tensor, h0: torch.Tensor,
                                    c0: torch.Tensor,
                                    cfg: ElmoLstmpConfig = ElmoLstmpConfig()):
    """Stateful :func:`encode_lstmp_from_reps`, upstream ``ElmobiLm``'s
    allennlp ``_EncoderBase(stateful=True)`` layout: ``h0`` [L, B, 2P] /
    ``c0`` [L, B, 2C] are the per-layer initial states, the forward
    direction in the first half of the last axis and the backward in the
    second.  Each direction runs :func:`..ops.rnn.lstmp_layer_stateful`
    (a plain step loop, no kernel).

    Returns (rep, pooled, h_n, c_n): ``h_n`` / ``c_n`` are each row's
    states at its last valid step in the same layout, to be carried into
    the next batch (:class:`..models.elmo_pretrained.PretrainedElmo`)."""
    pdim, cdim = cfg.proj_size, cfg.cell_size
    valid = _valid(token_reps.shape[1], lengths)

    def direction(layer, name, x, idx):
        # a reversed row holds its valid tokens at [0, len) too, so one
        # mask serves both directions, and the backward scan consumes its
        # initial state at the row's original index len - 1, where
        # upstream's backward cell starts
        off_h = 0 if name == "fwd" else pdim
        off_c = 0 if name == "fwd" else cdim
        ys, h, c = rnn_ops.lstmp_layer_stateful(
            layer[name], x, valid, h0[idx, :, off_h:off_h + pdim],
            c0[idx, :, off_c:off_c + cdim], cfg.cell_clip, cfg.proj_clip)
        return ys, (h, c)

    rep, pooled, auxes = bilm_stack(params["layers"], token_reps, lengths,
                                    direction)
    h_n = torch.stack([torch.cat([f[0], b[0]], dim=-1) for f, b in auxes])
    c_n = torch.stack([torch.cat([f[1], b[1]], dim=-1) for f, b in auxes])
    return rep, pooled, h_n, c_n


def zero_lstmp_states(batch: int, cfg: ElmoLstmpConfig = ElmoLstmpConfig(),
                      device=None):
    """Fresh (h, c) for :func:`encode_lstmp_from_reps_stateful`, upstream's
    first-batch ``initial_states=None``: zeros [L, B, 2P] / [L, B, 2C]."""
    return (torch.zeros((cfg.layers, batch, 2 * cfg.proj_size),
                        dtype=torch.float32, device=device),
            torch.zeros((cfg.layers, batch, 2 * cfg.cell_size),
                        dtype=torch.float32, device=device))


def encode_lstmp(params: Mapping, token_ids: torch.Tensor,
                 lengths: torch.Tensor,
                 cfg: ElmoLstmpConfig = ElmoLstmpConfig(),
                 backend: str = "auto"):
    """Hashed token ids through the embedding and the stacked LSTMP biLM
    (the average of the 3 ELMo layers, ``sents2elmo(output_layer=-1)``).
    Returns (per-token [B, T, 2P], masked mean-pooled [B, 2P])."""
    return encode_lstmp_from_reps(params, params["embed"][token_ids],
                                  lengths, cfg, backend)


def from_elmoformanylangs(sd: Mapping, cfg: ElmoLstmpConfig = ElmoLstmpConfig(),
                          word_embedding=None, embed_key=None) -> dict:
    """An ELMoForManyLangs encoder state dict (``{name: array}``, allennlp
    ``LstmCellWithProjection`` names
    ``encoder.{forward,backward}_layer_{k}.{input_linearity.weight,
    state_linearity.weight, state_linearity.bias, state_projection.weight}``)
    -> :func:`init_lstmp_encoder`'s tree (float32 CPU tensors).
    ``word_embedding`` ([V, In]) or ``embed_key`` names the embedding of
    the hashed-id path; without either it is a seeded normal, as in the
    JAX package."""
    def a(x):
        return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))

    def cell(direction: str, k: int):
        p = f"encoder.{direction}_layer_{k}"
        return {"w_x": a(sd[f"{p}.input_linearity.weight"]),
                "w_h": a(sd[f"{p}.state_linearity.weight"]),
                "b": a(sd[f"{p}.state_linearity.bias"]),
                "w_p": a(sd[f"{p}.state_projection.weight"])}

    if word_embedding is None and embed_key is not None:
        word_embedding = sd[embed_key]
    if word_embedding is None:
        word_embedding = (np.random.default_rng(0).standard_normal(
            (cfg.vocab_size, cfg.input_dim)) / np.sqrt(cfg.input_dim))
    return {"embed": a(word_embedding),
            "layers": [{"fwd": cell("forward", k), "bwd": cell("backward", k)}
                       for k in range(cfg.layers)]}
