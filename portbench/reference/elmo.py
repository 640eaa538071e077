"""Plain ELMoForManyLangs sentence embedding (``sents2elmo(output_layer=-1)``
of HIT-SCIR's ELMoForManyLangs, then the mean over the sentence's tokens,
as ``Classification/text_features_whole.py`` of the published code uses
it).

* segmentation: CJK characters become tokens, latin and digit runs stay
  whole, whitespace separates (the configuration pins this segmenter);
* every sentence is wrapped in ``<bos>`` / ``<eos>``; a token's characters
  are ``[bow, chars..., eow]`` padded with ``<pad>`` to ``max_chars``,
  with upstream's bow and eow ids swapped; a token longer than
  ``max_chars - 2`` is cut;
* the char-CNN: embeddings, one convolution per filter, the max over all
  ``max_chars`` positions, the activation, highways (ReLU), the word
  embedding after the char features, a projection;
* the biLM: per layer an LSTM with projection (gates i, f, g, o; cell and
  projection clipped) forwards, and backwards over each sentence reversed
  by its own length; residual connections from the second layer on; the
  token layer and both LSTM layers averaged;
* the mean over the sentence's tokens, ``<bos>`` and ``<eos>`` left out.

Sentences run in blocks padded to the block's longest; the padding never
reaches a real position, since every recurrence looks only backwards.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from portbench.reference import precision

BOS, EOS, OOV, PAD, BOW, EOW = ("<bos>", "<eos>", "<oov>", "<pad>",
                                "<bow>", "<eow>")


def segment(text: str) -> List[str]:
    tokens, buf = [], ""
    for ch in text.strip():
        if "一" <= ch <= "鿿":
            if buf:
                tokens.append(buf)
                buf = ""
            tokens.append(ch)
        elif ch.isspace():
            if buf:
                tokens.append(buf)
                buf = ""
        else:
            buf += ch
    if buf:
        tokens.append(buf)
    return [t for t in tokens if t.strip()]


def token_ids(tokens: Sequence[str], chars: Mapping[str, int],
              words: Mapping[str, int] | None, max_chars: int):
    """One sentence -> (char ids [T, max_chars], word ids [T] or None), T
    the wrapped length."""
    wrapped = [BOS] + [t[:max_chars - 2] for t in tokens] + [EOS]
    bow, eow = chars[EOW], chars[BOW]          # upstream's swap
    cids = np.full((len(wrapped), max_chars), chars[PAD], np.int64)
    for j, tok in enumerate(wrapped):
        cids[j, 0] = bow
        if tok in (BOS, EOS):
            cids[j, 1] = chars[tok]
            cids[j, 2] = eow
        else:
            for k, ch in enumerate(tok):
                cids[j, k + 1] = chars.get(ch, chars[OOV])
            cids[j, len(tok) + 1] = eow
    wids = None
    if words is not None:
        wids = np.asarray([words.get(t, words[OOV]) for t in wrapped],
                          np.int64)
    return cids, wids


def char_cnn(cc: Mapping, cids: torch.Tensor, wids, cfg: Mapping,
             prec: str) -> torch.Tensor:
    """[N, max_chars] ids -> [N, projection] token representations."""
    x = cc["char_emb"][cids].transpose(1, 2)              # [N, D, C]
    act = torch.relu if cfg["activation"] == "relu" else torch.tanh
    h = torch.cat([act(precision.conv1d(x, c["w"], c["b"], prec).amax(-1))
                   for c in cc["convs"]], dim=-1)
    f = h.shape[-1]
    for hw in cc["highways"]:
        proj = precision.matmul(h, hw["w"].t(), prec) + hw["b"]
        gate = torch.sigmoid(proj[:, f:])
        h = gate * h + (1.0 - gate) * torch.relu(proj[:, :f])
    if wids is not None:
        h = torch.cat([h, cc["word_emb"][wids]], dim=-1)
    return precision.matmul(h, cc["projection"]["w"].t(), prec) \
        + cc["projection"]["b"]


def lstmp(p: Mapping, x: torch.Tensor, cell_clip: float, proj_clip: float,
          prec: str) -> torch.Tensor:
    """[B, T, In] -> [B, T, P], zero initial state."""
    b, t_steps, _ = x.shape
    c_dim = p["w_x"].shape[0] // 4
    xp = precision.matmul(x, p["w_x"].t(), prec)
    h = x.new_zeros((b, p["w_p"].shape[0]))
    c = x.new_zeros((b, c_dim))
    ys = []
    for t in range(t_steps):
        g = xp[:, t] + precision.matmul(h, p["w_h"].t(), prec) + p["b"]
        i = torch.sigmoid(g[:, :c_dim])
        f = torch.sigmoid(g[:, c_dim:2 * c_dim])
        gg = torch.tanh(g[:, 2 * c_dim:3 * c_dim])
        o = torch.sigmoid(g[:, 3 * c_dim:])
        c = (f * c + i * gg).clamp(-cell_clip, cell_clip)
        h = precision.matmul(o * torch.tanh(c), p["w_p"].t(),
                             prec).clamp(-proj_clip, proj_clip)
        ys.append(h)
    return torch.stack(ys, dim=1)


def _reverse(x: torch.Tensor, lengths: Sequence[int]) -> torch.Tensor:
    out = torch.zeros_like(x)
    for r, n in enumerate(lengths):
        out[r, :n] = x[r, :n].flip(0)
    return out


def bilm(layers, e: torch.Tensor, lengths: Sequence[int], cfg: Mapping,
         prec: str) -> torch.Tensor:
    """[B, T, In] token reps -> [B, T, 2P], the average of the 3 layers."""
    clips = (cfg["cell_clip"], cfg["proj_clip"])
    f_in, b_in = e, e
    reps = [torch.cat([e, e], dim=-1)]
    for idx, layer in enumerate(layers):
        f_out = lstmp(layer["fwd"], f_in, *clips, prec)
        b_out = _reverse(lstmp(layer["bwd"], _reverse(b_in, lengths),
                               *clips, prec), lengths)
        if idx > 0:
            f_out, b_out = f_out + f_in, b_out + b_in
        reps.append(torch.cat([f_out, b_out], dim=-1))
        f_in, b_in = f_out, b_out
    return sum(reps) / len(reps)


def embed(texts: Sequence[str], weights: Mapping, lexicons: Mapping,
          cfg: Mapping, device, prec: str = "fp32",
          block: int = 64) -> np.ndarray:
    """Transcripts -> [N, 2P] float32 sentence embeddings.  ``weights``:
    {"cc": char-CNN tree, "layers": biLM layers} (host or device
    tensors); ``lexicons``: {"chars": ..., "words": ... or None}."""
    cc = _to(weights["cc"], device)
    layers = _to(weights["layers"], device)
    out = []
    for start in range(0, len(texts), block):
        ids = [token_ids(segment(t), lexicons["chars"], lexicons["words"],
                         cfg["max_chars"]) for t in texts[start:start + block]]
        lengths = [len(c) for c, _ in ids]
        t_max = max(lengths)
        cids = np.full((len(ids), t_max, cfg["max_chars"]),
                       lexicons["chars"][PAD], np.int64)
        wids = np.zeros((len(ids), t_max), np.int64)
        for r, (c, w) in enumerate(ids):
            cids[r, :len(c)] = c
            if w is not None:
                wids[r, :len(w)] = w
        flat_w = (None if lexicons["words"] is None else
                  torch.from_numpy(wids.reshape(-1)).to(device))
        e = char_cnn(cc, torch.from_numpy(cids.reshape(-1, cfg["max_chars"]))
                     .to(device), flat_w, cfg, prec).reshape(
                         len(ids), t_max, -1)
        rep = bilm(layers, e, lengths, cfg, prec)
        for r, n in enumerate(lengths):
            interior = (rep[r, 1:n - 1].mean(dim=0) if n > 2
                        else rep.new_zeros(rep.shape[-1]))
            out.append(interior.cpu().numpy())
    return np.stack(out) if out else np.zeros((0, 0), np.float32)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    return torch.as_tensor(tree).to(device)


def lexicons_from(chars: Sequence[str], words: Sequence[str] | None
                  ) -> Dict[str, Dict[str, int] | None]:
    """Lexicons as the benchmark lays them out: the specials, then the
    given characters (words) in order."""
    specials = [PAD, OOV, BOS, EOS, BOW, EOW]
    lex = {"chars": {t: i for i, t in enumerate(specials + list(chars))},
           "words": None}
    if words is not None:
        lex["words"] = {t: i for i, t in enumerate(
            [PAD, OOV, BOS, EOS] + list(words))}
    return lex
