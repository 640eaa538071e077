"""Char-CNN token embedder, the ELMo ``ConvTokenEmbedder`` char branch (port
of :mod:`icassp2022_depression_tpu.models.char_cnn`).

Each token: char embeddings -> one 1-D convolution per (width, channels)
filter over the char axis (cross-correlation, no padding) -> max over all
``max_chars`` positions, pad ids included, with no mask -> activation ->
highway layers (ReLU whatever the activation, as allennlp's ``Highway``) ->
the optional word embedding concatenated *after* the char features ->
a Linear projection to ``output_dim``.

The convolutions are ``F.conv1d`` (the JAX package leaves them to XLA,
outside any Pallas kernel), run with cuDNN's TF32 off, so the card computes
them in full float32 like the CPU.  Parameters are a dict in the JAX
package's layout (``char_emb``, ``convs/i/{w, b}`` with ``w [out, char_dim,
width]``, ``highways/i/{w, b}``, ``projection/{w, b}``, ``word_emb``), so
a bundle's arrays load unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from icassp2022_depression_tpu_torch.ops import prng
from icassp2022_depression_tpu_torch.ops.nn import no_tf32_convs


@dataclasses.dataclass(frozen=True)
class CharCnnConfig:
    n_chars: int = 6784          # zhs char vocab size (model's char.dic)
    char_dim: int = 50
    #: (kernel width, out channels) pairs
    filters: Tuple[Tuple[int, int], ...] = (
        (1, 32), (2, 32), (3, 64), (4, 128), (5, 256), (6, 512), (7, 1024))
    n_highway: int = 2
    output_dim: int = 512
    activation: str = "relu"
    #: optional word-embedding branch concatenated before projection
    word_vocab: Optional[int] = None
    word_dim: int = 100
    max_chars: int = 50

    @property
    def n_filters(self) -> int:
        return sum(c for _, c in self.filters)


def init(key: torch.Tensor, cfg: CharCnnConfig = CharCnnConfig()) -> dict:
    """Seeded parameters on the key's device, drawn with the port's
    threefry in the JAX package's order (``char_cnn.init``): the same key
    gives the same weights in both packages."""
    keys = prng.split(key, 2 + len(cfg.filters) + cfg.n_highway + 1)

    def uni(k, shape, bound):
        return prng.uniform(k, shape, -float(bound), float(bound))

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=key.device)

    params = {"char_emb": prng.normal(keys[0], (cfg.n_chars, cfg.char_dim))
              * float(np.float32(1.0 / np.sqrt(cfg.char_dim))),
              "convs": [], "highways": []}
    k = 2
    for width, out in cfg.filters:
        params["convs"].append({
            "w": uni(keys[k], (out, cfg.char_dim, width),
                     1.0 / np.sqrt(cfg.char_dim * width)),
            "b": zeros(out)})
        k += 1
    f = cfg.n_filters
    for _ in range(cfg.n_highway):
        params["highways"].append({
            "w": uni(keys[k], (2 * f, f), 1.0 / np.sqrt(f)),
            "b": zeros(2 * f)})
        k += 1
    proj_in = f + (cfg.word_dim if cfg.word_vocab else 0)
    params["projection"] = {
        "w": uni(keys[k], (cfg.output_dim, proj_in), 1.0 / np.sqrt(proj_in)),
        "b": zeros(cfg.output_dim)}
    if cfg.word_vocab:
        params["word_emb"] = prng.normal(
            keys[1], (cfg.word_vocab, cfg.word_dim)) \
            * float(np.float32(1.0 / np.sqrt(cfg.word_dim)))
    return params


def embed_tokens(params: Mapping, char_ids: torch.Tensor, cfg: CharCnnConfig,
                 word_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """char_ids [B, T, max_chars] int -> token representations [B, T,
    output_dim]."""
    b, t, c = char_ids.shape
    act = torch.relu if cfg.activation == "relu" else torch.tanh
    x = params["char_emb"][char_ids.reshape(b * t, c)]       # [BT, C, D]
    x = x.transpose(1, 2)                                     # [BT, D, C]
    outs = []
    with no_tf32_convs():
        for conv in params["convs"]:
            y = F.conv1d(x, conv["w"], conv["b"])
            outs.append(act(y.amax(dim=-1)))                  # max over pos
    h = torch.cat(outs, dim=-1)                               # [BT, F]
    f = cfg.n_filters
    for hw in params["highways"]:
        proj = torch.matmul(h, hw["w"].t()) + hw["b"]
        gate = torch.sigmoid(proj[:, f:])
        h = gate * h + (1.0 - gate) * torch.relu(proj[:, :f])
    if word_ids is not None and "word_emb" in params:
        h = torch.cat([h, params["word_emb"][word_ids.reshape(b * t)]],
                      dim=-1)
    out = torch.matmul(h, params["projection"]["w"].t()) \
        + params["projection"]["b"]
    return out.reshape(b, t, cfg.output_dim)


def from_elmoformanylangs_token_embedder(sd: Mapping,
                                         cfg: CharCnnConfig) -> dict:
    """ELMoForManyLangs ``token_embedder.*`` arrays -> this param tree
    (float32 CPU tensors).  Upstream concatenates the word embedding
    *before* the char features; :func:`embed_tokens` concatenates it after,
    so the projection's columns are reordered here when the word branch is
    present."""
    def a(key):
        return torch.from_numpy(np.array(sd[key], dtype=np.float32,
                                         copy=True))

    params = {
        "char_emb": a("token_embedder.char_emb_layer.embedding.weight"),
        "convs": [{"w": a(f"token_embedder.convolutions.{i}.weight"),
                   "b": a(f"token_embedder.convolutions.{i}.bias")}
                  for i in range(len(cfg.filters))],
        "highways": [{"w": a(f"token_embedder.highways._layers.{i}.weight"),
                      "b": a(f"token_embedder.highways._layers.{i}.bias")}
                     for i in range(cfg.n_highway)],
        "projection": {"w": a("token_embedder.projection.weight"),
                       "b": a("token_embedder.projection.bias")},
    }
    wkey = "token_embedder.word_emb_layer.embedding.weight"
    if wkey in sd:
        params["word_emb"] = a(wkey)
        word_dim = params["word_emb"].shape[1]
        pw = params["projection"]["w"]
        if pw.shape[1] == word_dim + cfg.n_filters:
            # upstream column order [word | char] -> ours [char | word]
            params["projection"]["w"] = torch.cat(
                [pw[:, word_dim:], pw[:, :word_dim]], dim=1)
    return params
