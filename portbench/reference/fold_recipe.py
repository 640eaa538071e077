"""The audio classifier's fold recipe (``Classification/audio_gru_whole.py``
of the published code, lines 110-121, 161-245 and 258-318), plainly, for
the first epoch of each fold and the metric gate.

* the fold's train speakers in the given order; a depressed speaker's
  ``[3, D]`` block expanded into the 6 orders of its answers
  (``itertools.permutations``), labelled 1; consecutive, unshuffled
  minibatches of ``batch_size``; the last one ragged;
* the test speakers (every speaker outside the fold's train split,
  ascending); a depressed one in the orders 0, 1, 4 and 5 of its answers,
  labelled 1;
* train mode: LayerNorm -> GRU layer 0 -> dropout -> GRU layer 1 -> mean
  over time -> dropout -> Linear -> ReLU -> dropout -> Linear -> softmax;
  the loss is ``CrossEntropyLoss`` on those probabilities (the published
  double softmax), the mean over the batch's rows;
* AdamW with weight decay on every parameter but the LayerNorm's;
* after the epoch's steps, the test rows in evaluation mode, their
  confusion counts, and the gate: an epoch's parameters are kept where
  its test F1 is at least the best so far and above ``f1_floor``, and
  its train rows classified right exceed ``train_acc_frac`` of them.

The dropout masks follow the program's documented stream (the JAX
package's convention): the fold's key ``fold_in(PRNGKey(seed + 1000),
fold)`` split once a batch (``key, sub = split(key)``); ``sub`` split into
(features, head); the features key split, its second half split into (next,
mask key) for the one inter-layer mask; the head key split into the two
head masks; a mask keeps where a uniform draw is below ``1 - rate``, drawn
at the whole batch's shape (a ragged batch keeps its first rows).  They
are drawn here by :mod:`.threefry`.
"""

from __future__ import annotations

import itertools
from typing import List, Mapping, Sequence

import numpy as np
import torch

from portbench.reference import models, precision, threefry

PERMS = list(itertools.permutations(range(3)))
#: the answer orders a depressed test speaker is scored in
TEST_PERMS = (0, 1, 4, 5)
#: a row whose two probabilities lie closer than this may be classified
#: either way by float32 rounding: the counts allow one such row each
TIE = 1e-5


def _rows(targets: np.ndarray, idx: Sequence[int], perms: Sequence[int]):
    spk, order, label = [], [], []
    for i in idx:
        for p in (perms if targets[i] == 1 else (0,)):
            spk.append(i)
            order.append(PERMS[p])
            label.append(int(targets[i]))
    return np.asarray(spk), np.asarray(order), np.asarray(label)


def train_rows(targets: np.ndarray, train_idx: Sequence[int]):
    """-> (speaker [R], answer order [R, 3], label [R]) of the fold's
    augmented train split."""
    return _rows(targets, train_idx, range(len(PERMS)))


def test_rows(targets: np.ndarray, train_idx: Sequence[int]):
    """-> the same of the fold's test split."""
    test = np.setdiff1d(np.arange(len(targets)), train_idx)
    return _rows(targets, test, TEST_PERMS)


def _gather(features: torch.Tensor, spk, order) -> torch.Tensor:
    idx = torch.from_numpy(spk).to(features.device)
    perm = torch.from_numpy(order).to(features.device)
    return torch.gather(features[idx], 1, perm[:, :, None].expand(
        -1, -1, features.shape[-1]))


def _split2(key):
    ks = threefry.split(key, 2)
    return ks[0], ks[1]


def _mask(key, shape, rate: float, batch: int) -> np.ndarray:
    """The keep mask of a ``shape`` tensor whose first axis holds the
    valid rows of a batch of ``batch``."""
    full = threefry.uniform(key, (batch,) + tuple(shape[1:]), 0.0, 1.0)
    return full[:shape[0]] < np.float32(1.0 - rate)


def _dropout(x: torch.Tensor, keep_mask: np.ndarray, rate: float):
    m = torch.from_numpy(keep_mask).to(x.device)
    return torch.where(m, x / (1.0 - rate), torch.zeros_like(x))


def forward_train(sd: Mapping, x: torch.Tensor, key, m: Mapping,
                  prec: str, batch: int) -> torch.Tensor:
    """[B, T, D] -> [B, C] probabilities, with this batch's masks."""
    rate = m["dropout"]
    k_feat, k_head = _split2(key)
    _, k_rnn = _split2(k_feat)
    h = models._layer_norm(x, sd["ln.weight"], sd["ln.bias"])
    for layer in range(m["rnn_layers"]):
        w = [sd[f"lstm_net_audio.{n}_l{layer}"]
             for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        h, _ = models._gru_dir(h, *w, prec)
        if layer < m["rnn_layers"] - 1:
            k_rnn, sub = _split2(k_rnn)
            h = _dropout(h, _mask(sub, h.shape, rate, batch), rate)
    pooled = h.mean(dim=1)
    k1, k2 = _split2(k_head)
    pooled = _dropout(pooled, _mask(k1, pooled.shape, rate, batch), rate)
    z = torch.relu(models._linear(pooled, sd["fc_audio.1.weight"],
                                  sd["fc_audio.1.bias"], prec))
    z = _dropout(z, _mask(k2, z.shape, rate, batch), rate)
    out = models._linear(z, sd["fc_audio.4.weight"], sd["fc_audio.4.bias"],
                         prec)
    return torch.softmax(out, dim=-1)


def _ties(probs: torch.Tensor) -> int:
    return int(((probs[:, 1] - probs[:, 0]).abs() < TIE).sum())


def first_epoch(features: torch.Tensor, targets: np.ndarray,
                train_idx: Sequence[int], init: Mapping[str, torch.Tensor],
                recipe: Mapping, model: Mapping, seed: int, fold: int,
                prec: str = "fp32") -> dict:
    """The fold's first epoch (``fold`` counts from 1) -> ``losses`` (each
    step's, before its update), ``grad`` (each parameter's first gradient
    as AdamW holds it after one step: its first moment over ``1 - b1``),
    ``change`` (each parameter's change over the epoch), ``train_correct``
    (train rows classified right, by each step's probabilities before its
    update), ``tp``, ``tn``, ``test_pos``, ``test_rows`` (the epoch's test
    confusion), ``train_ties`` and ``test_ties`` (rows within
    :data:`TIE` of a tie); the norms as floats, by name."""
    dev = features.device
    spk, order, label = train_rows(targets, train_idx)
    params = {k: v.detach().to(dev).clone().requires_grad_(True)
              for k, v in init.items()}
    decay = [p for n, p in params.items() if not n.startswith("ln.")]
    keep = [p for n, p in params.items() if n.startswith("ln.")]
    b1 = recipe["b1"]
    opt = torch.optim.AdamW(
        [{"params": decay, "weight_decay": recipe["weight_decay"]},
         {"params": keep, "weight_decay": 0.0}],
        lr=recipe["learning_rate"], betas=(b1, recipe["b2"]),
        eps=recipe["eps"], foreach=False)
    key = threefry.fold_in(threefry.prng_key(seed + 1000), fold)
    b = recipe["batch_size"]
    out = {"losses": [], "grad": None, "train_correct": 0, "train_ties": 0}
    for i in range(-(-len(spk) // b)):
        rows = slice(i * b, (i + 1) * b)
        x = _gather(features, spk[rows], order[rows])
        y = torch.from_numpy(label[rows]).to(dev)
        key, sub = _split2(key)
        with precision.tf32(prec == "tf32"):
            probs = forward_train(params, x, sub, model, prec, b)
            logp = torch.log_softmax(probs, dim=-1)
            loss = -logp.gather(1, y[:, None]).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
        if out["grad"] is None:
            out["grad"] = {
                n: (float(torch.linalg.vector_norm(opt.state[p]["exp_avg"]))
                    / (1.0 - b1) if opt.state.get(p) else 0.0)
                for n, p in params.items()}
        probs = probs.detach()
        out["losses"].append(float(loss.detach()))
        out["train_correct"] += int((probs.argmax(-1) == y).sum())
        out["train_ties"] += _ties(probs)
    out["change"] = {n: float(torch.linalg.vector_norm(
        p.detach() - init[n].to(dev))) for n, p in params.items()}
    spk, order, label = test_rows(targets, train_idx)
    with torch.no_grad(), precision.tf32(prec == "tf32"):
        probs = models.audio_clf({n: p.detach() for n, p in params.items()},
                                 _gather(features, spk, order), model, prec)
    pred = probs.argmax(-1).cpu().numpy()
    out.update(tp=int(((pred == 1) & (label == 1)).sum()),
               tn=int(((pred == 0) & (label == 0)).sum()),
               test_pos=int(label.sum()), test_rows=len(label),
               test_ties=_ties(probs))
    return out


def gate(f1: Sequence[float], train_correct: Sequence[float],
         n_train: int, g: Mapping) -> tuple:
    """The published gate over an epoch log -> (gated epoch, its F1), or
    (-1, -1) where no epoch passes it."""
    best, at = -1.0, -1
    for e, (f, c) in enumerate(zip(f1, train_correct)):
        improve = f >= best if g.get("f1_tie_update", True) else f > best
        acc = (c > n_train * g["train_acc_frac"]
               if g.get("train_acc_strict", True)
               else c >= n_train * g["train_acc_frac"])
        if improve and acc and f > g["f1_floor"]:
            best, at = float(f), e
    return at, best


def stratified_folds(targets: np.ndarray, n_folds: int,
                     rng: np.random.Generator) -> List[np.ndarray]:
    """A stratified split: each class shuffled and cut into ``n_folds``
    parts; fold k trains on every speaker outside part k, ascending."""
    test = [np.empty(0, np.int64) for _ in range(n_folds)]
    for label in np.unique(targets):
        idx = np.where(targets == label)[0]
        rng.shuffle(idx)
        for k, chunk in enumerate(np.array_split(idx, n_folds)):
            test[k] = np.concatenate([test[k], chunk])
    return [np.setdiff1d(np.arange(len(targets)), t) for t in test]
