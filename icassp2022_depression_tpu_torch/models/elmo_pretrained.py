"""Pretrained ELMoForManyLangs (zhs) pipeline: convert, load, embed (port
of :mod:`icassp2022_depression_tpu.models.elmo_pretrained`).

* :func:`convert_model_dir` reads a released model directory
  (``config.json``, ``char.dic`` [, ``word.dic``], ``token_embedder.pkl``,
  ``encoder.pkl``; the pickles are plain state dicts, read with
  ``torch.load(weights_only=True)``) into a :class:`PretrainedElmo`.
* :func:`save_npz` / :func:`load_npz` write and read the single-file
  bundle in the JAX package's format (``__meta__`` JSON with the configs
  and lexicons, ``cc/...`` and ``enc/...`` arrays, no pickles), so either
  package reads the other's bundle.
* :meth:`PretrainedElmo.embed_sentences` is ``sents2elmo(output_layer=-1)``
  plus the per-sentence token mean, batched: char-CNN token embedder ->
  stacked LSTMP biLM (the ``lstmp_fwd`` CUDA kernel on a card) -> average
  of the 3 ELMo layers -> mean over the real tokens (BOS/EOS stripped).

Faithfulness notes, each as in the JAX package: every sentence is wrapped
in ``<bos>``/``<eos>``; a token longer than ``max_chars - 2`` is cut; each
token's chars are ``[bow, chars..., eow]`` padded with ``<pad>``, with
upstream's swapped bow/eow ids (``SWAP_BOW_EOW``).

Upstream's ``ElmobiLm`` is stateful across batches (allennlp
``_EncoderBase(stateful=True)``), so its embeddings depend on the order a
corpus is processed in.  By default the encoder here is zero-state per
sentence, the JAX package's documented reproducibility fix (upstream's
very first batch).  ``stateful=True`` emulates upstream batch for batch
(:meth:`PretrainedElmo._embed_sentences_stateful`): sentences sorted by
length, descending and stable, batches of 64 without row padding, and the
biLM states carried across batches and across
:meth:`PretrainedElmo.embed_sentences` calls, with allennlp's rules for a
batch that grows or shrinks and for unused rows.  ``reset_states()``
forgets them.  That mode's recurrence is a plain step loop
(:func:`..ops.rnn.lstmp_layer_stateful`): the ``lstmp_fwd`` kernel is
zero-state by contract, as the Pallas kernel it ports is.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from icassp2022_depression_tpu_torch.models import char_cnn, elmo
from icassp2022_depression_tpu_torch.utils import profiling
from icassp2022_depression_tpu_torch.utils.device import resolve_device

#: upstream create_one_batch reads ('<eow>', '<bow>', ...) into
#: (bow_id, eow_id, ...): markers swapped, reproduced for fidelity
SWAP_BOW_EOW = True

BOS, EOS, OOV, PAD, BOW, EOW = ("<bos>", "<eos>", "<oov>", "<pad>",
                                "<bow>", "<eow>")


def load_lexicon(path) -> Dict[str, int]:
    """Tab-separated ``token\\tid`` lexicon (upstream ``char.dic`` /
    ``word.dic`` format, including its full-width-space special case)."""
    lex: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) == 1:  # the token was the ideographic space
                parts.insert(0, "　")
            lex[parts[0]] = int(parts[1])
    return lex


def build_batch(sents: Sequence[Sequence[str]],
                char_lexicon: Mapping[str, int],
                word_lexicon: Optional[Mapping[str, int]],
                max_chars: int, pad_to: Optional[int] = None):
    """Tokenised sentences -> (char_ids [B, T, C], word_ids [B, T] or None,
    lengths [B]) as int numpy arrays, with BOS/EOS wrapping, upstream's
    truncation rule and char markers.  ``T`` covers the wrapped length.
    It is the profiling region ``elmo/build_batch``."""
    with profiling.annotate("elmo/build_batch"):
        bow_key, eow_key = (EOW, BOW) if SWAP_BOW_EOW else (BOW, EOW)
        bow = char_lexicon[bow_key]
        eow = char_lexicon[eow_key]
        cpad = char_lexicon[PAD]
        coov = char_lexicon[OOV]

        wrapped: List[List[str]] = []
        for sent in sents:
            toks = [BOS]
            for tok in sent:
                if len(tok) + 2 > max_chars:
                    tok = tok[:max_chars - 2]
                toks.append(tok)
            toks.append(EOS)
            wrapped.append(toks)

        lengths = np.asarray([len(t) for t in wrapped], np.int32)
        max_t = int(pad_to if pad_to is not None else lengths.max())
        b = len(wrapped)
        char_ids = np.full((b, max_t, max_chars), cpad, np.int32)
        word_ids = None
        if word_lexicon is not None:
            woov = word_lexicon[OOV]
            word_ids = np.full((b, max_t), word_lexicon[PAD], np.int32)
        for i, toks in enumerate(wrapped):
            for j, tok in enumerate(toks):
                char_ids[i, j, 0] = bow
                if tok in (BOS, EOS):
                    char_ids[i, j, 1] = char_lexicon[tok]
                    char_ids[i, j, 2] = eow
                else:
                    for k, ch in enumerate(tok):
                        char_ids[i, j, k + 1] = char_lexicon.get(ch, coov)
                    char_ids[i, j, len(tok) + 1] = eow
                if word_ids is not None:
                    word_ids[i, j] = word_lexicon.get(tok, woov)
        return char_ids, word_ids, lengths


def _interior_mean(rep: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Mean over each row's real tokens: BOS/EOS and padding excluded (the
    ``data[1:lens-1]`` strip in upstream ``sents2elmo``)."""
    pos = torch.arange(rep.shape[1], device=rep.device)[None, :]
    interior = ((pos >= 1) & (pos < lengths[:, None] - 1)).to(rep.dtype)
    return (rep * interior[:, :, None]).sum(dim=1) / \
        interior.sum(dim=1, keepdim=True).clamp_min(1.0)


def encode_pooled(cc_params, enc_params, char_ids, word_ids, lengths,
                  char_cfg: char_cnn.CharCnnConfig,
                  lstmp_cfg: elmo.ElmoLstmpConfig, backend: str = "auto"):
    """ids (tensors) -> ([B, T, 2P] 3-layer-averaged reps, [B, 2P] mean
    over the real tokens), in the profiling region ``elmo/encode``."""
    with profiling.annotate("elmo/encode", char_ids.device):
        reps = char_cnn.embed_tokens(cc_params, char_ids, char_cfg, word_ids)
        rep, _ = elmo.encode_lstmp_from_reps(enc_params, reps, lengths,
                                             lstmp_cfg, backend)
        return rep, _interior_mean(rep, lengths)


def encode_pooled_stateful(cc_params, enc_params, char_ids, word_ids,
                           lengths, h0, c0, char_cfg: char_cnn.CharCnnConfig,
                           lstmp_cfg: elmo.ElmoLstmpConfig):
    """Stateful :func:`encode_pooled`: carries the biLM states ([L, B, 2P]
    / [L, B, 2C], allennlp's layout) in and out -> (pooled [B, 2P], h_n,
    c_n)."""
    reps = char_cnn.embed_tokens(cc_params, char_ids, char_cfg, word_ids)
    rep, _, h_n, c_n = elmo.encode_lstmp_from_reps_stateful(
        enc_params, reps, lengths, h0, c0, lstmp_cfg)
    return _interior_mean(rep, lengths), h_n, c_n


def tree_to(tree, device):
    """A nested dict / list of arrays -> the same tree of float32 tensors
    on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return torch.as_tensor(tree, dtype=torch.float32).to(device)


@dataclasses.dataclass
class PretrainedElmo:
    char_cfg: char_cnn.CharCnnConfig
    lstmp_cfg: elmo.ElmoLstmpConfig
    cc_params: dict
    enc_params: dict
    char_lexicon: Dict[str, int]
    word_lexicon: Optional[Dict[str, int]]
    #: emulate upstream ElmobiLm's cross-batch state (module docstring);
    #: False is the zero-state mode
    stateful: bool = False
    _states: Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    #: (mesh, axis, this rank's share of the encoder) once
    #: :meth:`enable_tp` ran
    _tp: Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def output_dim(self) -> int:
        return self.lstmp_cfg.output_dim

    def reset_states(self) -> None:
        """Forget the carried biLM states (a fresh process's)."""
        self._states = None

    @property
    def device(self) -> torch.device:
        return self.cc_params["char_emb"].device

    def to(self, device) -> "PretrainedElmo":
        """The same model with every parameter on ``device``."""
        return dataclasses.replace(
            self, cc_params=tree_to(self.cc_params, device),
            enc_params=tree_to(self.enc_params, device))

    def enable_tp(self, mesh, axis: str = "model") -> None:
        """Run the biLM tensor-parallel over ``mesh``'s ``axis``
        (:mod:`..parallel.elmo_tp`; every rank of the axis calls
        :meth:`embed_sentences` with the same sentences): the encoder is
        cut once, here.  Stateless mode only: the stateful emulation
        carries state from batch to batch, serially."""
        if self.stateful:
            raise ValueError("tensor-parallel biLM is stateless-only "
                             "(--elmo-stateful carries cross-batch state "
                             "serially); drop one of the two flags")
        from icassp2022_depression_tpu_torch.parallel import elmo_tp

        self._tp = (mesh, axis,
                    elmo_tp.shard_encoder_params(mesh, self.enc_params,
                                                 axis))

    def embed_sentences(self, sentences: Sequence[Sequence[str]],
                        batch_size: Optional[int] = None) -> torch.Tensor:
        """Tokenised sentences -> [N, 1024] on the parameters' device:
        batches of ``batch_size`` sentences (default 128), rows padded to a
        multiple of 8 (empty sentences: BOS/EOS only) and tokens to a
        multiple of 16, as in the JAX package.  The encoder is zero-state
        per sentence, so a sentence gets the same vector in any batch;
        with ``stateful`` it is :meth:`_embed_sentences_stateful` (default
        batch 64, upstream's); after :meth:`enable_tp` the biLM runs
        tensor-parallel."""
        if self.stateful:
            return self._embed_sentences_stateful(sentences,
                                                  batch_size or 64)
        batch_size = batch_size or 128
        device = self.device
        pooled = []
        with torch.inference_mode():
            for start in range(0, len(sentences), batch_size):
                chunk = list(sentences[start:start + batch_size])
                real = len(chunk)
                chunk += [[]] * ((-real) % 8)
                max_t = max(2, max(len(s) for s in chunk) + 2)
                char_ids, word_ids, lengths = build_batch(
                    chunk, self.char_lexicon, self.word_lexicon,
                    self.char_cfg.max_chars, pad_to=-(-max_t // 16) * 16)
                ids = (torch.from_numpy(char_ids).to(device),
                       None if word_ids is None
                       else torch.from_numpy(word_ids).to(device),
                       torch.from_numpy(lengths).to(device))
                if self._tp is not None:
                    from icassp2022_depression_tpu_torch.parallel import (
                        elmo_tp,
                    )

                    mesh, axis, enc_tp = self._tp
                    out = elmo_tp.encode_pooled_tp(
                        mesh, self.cc_params, enc_tp, *ids, self.char_cfg,
                        self.lstmp_cfg, axis)
                else:
                    _, out = encode_pooled(self.cc_params, self.enc_params,
                                           *ids, self.char_cfg,
                                           self.lstmp_cfg)
                pooled.append(out[:real])
        if not pooled:
            return torch.zeros((0, self.output_dim), dtype=torch.float32,
                               device=device)
        return torch.cat(pooled)

    # -- upstream-faithful stateful mode -----------------------------------

    def _prepare_states(self, batch: int):
        """allennlp ``_EncoderBase._get_initial_states``: zeros at the very
        first batch; a batch larger than the store grows the stored states
        with zero rows (upstream mutates its ``_states``), a smaller one
        takes the first rows.  The sort indices are the identity here,
        since the sentences arrive sorted."""
        if self._states is None:
            return elmo.zero_lstmp_states(batch, self.lstmp_cfg, self.device)
        h, c = self._states
        grow = batch - h.shape[1]
        if grow > 0:
            h = torch.cat([h, h.new_zeros((h.shape[0], grow, h.shape[2]))], 1)
            c = torch.cat([c, c.new_zeros((c.shape[0], grow, c.shape[2]))], 1)
            self._states = (h, c)
        return h[:, :batch], c[:, :batch]

    def _update_states(self, h_n, c_n) -> None:
        """allennlp ``_EncoderBase._update_states``: a row whose returned
        first-layer state sums to exactly 0 counts as unused and keeps its
        old state; rows of the store beyond the batch stay as they were
        (the store never shrinks)."""
        if self._states is None:
            self._states = (h_n, c_n)
            return
        old_h, old_c = self._states
        batch = h_n.shape[1]
        used_h = (h_n[0].sum(-1) != 0.0)[None, :, None]
        used_c = (c_n[0].sum(-1) != 0.0)[None, :, None]
        new_h = old_h.clone()
        new_c = old_c.clone()
        new_h[:, :batch] = torch.where(used_h, h_n, old_h[:, :batch])
        new_c[:, :batch] = torch.where(used_c, c_n, old_c[:, :batch])
        self._states = (new_h, new_c)

    def _embed_sentences_stateful(self, sentences: Sequence[Sequence[str]],
                                  batch_size: int = 64) -> torch.Tensor:
        """Upstream ``sents2elmo`` batch for batch: a stable sort by length,
        descending (``create_batches(..., sort=True)``; ties keep corpus
        order), batches without row padding (a padded row would perturb
        the carried states), tokens padded to a multiple of 16 (masked
        updates make trailing padding a no-op), the states carried across
        batches and calls, outputs in input order."""
        device = self.device
        n = len(sentences)
        if n == 0:
            return torch.zeros((0, self.output_dim), dtype=torch.float32,
                               device=device)
        order = sorted(range(n), key=lambda i: -len(sentences[i]))
        pooled = []
        with torch.inference_mode():
            for start in range(0, n, batch_size):
                chunk = [sentences[i] for i in order[start:start + batch_size]]
                max_t = max(2, max(len(s) for s in chunk) + 2)
                char_ids, word_ids, lengths = build_batch(
                    chunk, self.char_lexicon, self.word_lexicon,
                    self.char_cfg.max_chars, pad_to=-(-max_t // 16) * 16)
                h0, c0 = self._prepare_states(len(chunk))
                out, h_n, c_n = encode_pooled_stateful(
                    self.cc_params, self.enc_params,
                    torch.from_numpy(char_ids).to(device),
                    None if word_ids is None
                    else torch.from_numpy(word_ids).to(device),
                    torch.from_numpy(lengths).to(device), h0, c0,
                    self.char_cfg, self.lstmp_cfg)
                self._update_states(h_n, c_n)
                pooled.append(out)
        inv = np.empty(n, np.int64)
        inv[np.asarray(order)] = np.arange(n)
        return torch.cat(pooled)[torch.from_numpy(inv).to(device)]


# ---------------------------------------------------------------------------
# Conversion from a released ELMoForManyLangs model directory
# ---------------------------------------------------------------------------


def _load_arch_config(model_dir: Path) -> dict:
    """model_dir/config.json either is the architecture config or carries a
    ``config_path`` naming it (the recorded path is often stale, so its
    basename inside model_dir is tried too)."""
    top = json.loads((model_dir / "config.json").read_text())
    if "token_embedder" in top:
        return top
    cfg_path = Path(top["config_path"])
    for cand in (model_dir / cfg_path, model_dir / cfg_path.name):
        if cand.exists():
            return json.loads(cand.read_text())
    raise FileNotFoundError(
        f"architecture config {cfg_path} not found under {model_dir}")


def _state_dict(path: Path, prefix: str) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {f"{prefix}.{k}": v.detach().cpu().numpy() for k, v in sd.items()}


def convert_model_dir(model_dir) -> PretrainedElmo:
    """Released model dir -> :class:`PretrainedElmo` (CPU tensors)."""
    model_dir = Path(model_dir)
    arch = _load_arch_config(model_dir)
    te_cfg = arch["token_embedder"]
    enc_cfg = arch["encoder"]

    char_lexicon = load_lexicon(model_dir / "char.dic")
    word_lexicon = None
    if te_cfg.get("word_dim") and (model_dir / "word.dic").exists():
        word_lexicon = load_lexicon(model_dir / "word.dic")

    char_cfg = char_cnn.CharCnnConfig(
        n_chars=len(char_lexicon),
        char_dim=te_cfg["char_dim"],
        filters=tuple((int(w), int(c)) for w, c in te_cfg["filters"]),
        n_highway=te_cfg["n_highway"],
        output_dim=enc_cfg["projection_dim"],
        activation=te_cfg.get("activation", "relu"),
        word_vocab=len(word_lexicon) if word_lexicon else None,
        word_dim=te_cfg.get("word_dim", 0) if word_lexicon else 0,
        max_chars=te_cfg["max_characters_per_token"])
    lstmp_cfg = elmo.ElmoLstmpConfig(
        vocab_size=1,  # unused: token reps come from the char-CNN
        input_dim=enc_cfg["projection_dim"],
        cell_size=enc_cfg["dim"],
        proj_size=enc_cfg["projection_dim"],
        layers=enc_cfg["n_layers"],
        cell_clip=float(enc_cfg.get("cell_clip", 3.0)),
        proj_clip=float(enc_cfg.get("proj_clip", 3.0)))

    cc_params = char_cnn.from_elmoformanylangs_token_embedder(
        _state_dict(model_dir / "token_embedder.pkl", "token_embedder"),
        char_cfg)
    enc = elmo.from_elmoformanylangs(
        _state_dict(model_dir / "encoder.pkl", "encoder"), lstmp_cfg,
        word_embedding=np.zeros((1, lstmp_cfg.input_dim), np.float32))
    return PretrainedElmo(char_cfg, lstmp_cfg, cc_params,
                          {"layers": enc["layers"]}, char_lexicon,
                          word_lexicon)


# ---------------------------------------------------------------------------
# Single-artifact bundle (the JAX package's format)
# ---------------------------------------------------------------------------


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = (tree.detach().cpu().numpy()
                       if isinstance(tree, torch.Tensor) else np.asarray(tree))


def _unflatten(flat: Mapping[str, np.ndarray]):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(val, dtype=np.float32))

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_npz(path, pe: PretrainedElmo) -> None:
    """Write the bundle.  Uncompressed (``np.savez``): weights do not
    compress, and both packages' ``load_npz`` read either kind."""
    arrays: Dict[str, np.ndarray] = {}
    _flatten(pe.cc_params, "cc", arrays)
    _flatten(pe.enc_params, "enc", arrays)
    meta = {
        "char_cfg": dataclasses.asdict(pe.char_cfg),
        "lstmp_cfg": dataclasses.asdict(pe.lstmp_cfg),
        "char_lexicon": pe.char_lexicon,
        "word_lexicon": pe.word_lexicon,
    }
    np.savez(path, __meta__=np.asarray(json.dumps(meta)), **arrays)


def load_npz(path, device=None) -> PretrainedElmo:
    """Read a bundle written by either package; parameters on ``device``
    (default: the card, and an error without one, as
    :func:`..utils.device.resolve_device` decides)."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    cc = {k[3:]: v for k, v in flat.items() if k.startswith("cc/")}
    enc = {k[4:]: v for k, v in flat.items() if k.startswith("enc/")}
    ccfg = dict(meta["char_cfg"])
    ccfg["filters"] = tuple(tuple(f) for f in ccfg["filters"])
    pe = PretrainedElmo(
        char_cfg=char_cnn.CharCnnConfig(**ccfg),
        lstmp_cfg=elmo.ElmoLstmpConfig(**meta["lstmp_cfg"]),
        cc_params=_unflatten(cc),
        enc_params=_unflatten(enc),
        char_lexicon={k: int(v) for k, v in meta["char_lexicon"].items()},
        word_lexicon=None if meta["word_lexicon"] is None else
        {k: int(v) for k, v in meta["word_lexicon"].items()})
    return pe.to(device)


def default_weights_path() -> Optional[Path]:
    """The bundle ``elmo_weights="auto"`` resolves to, in the JAX package's
    order: ``ICASSP_ELMO_WEIGHTS``, then ``~/.cache/icassp2022_tpu/
    elmo_zhs.npz``.  None when neither exists."""
    env = os.environ.get("ICASSP_ELMO_WEIGHTS")
    if env and Path(env).exists():
        return Path(env)
    cached = Path.home() / ".cache" / "icassp2022_tpu" / "elmo_zhs.npz"
    if cached.exists():
        return cached
    return None
