"""Closed-loop cohort serving of the clf fusion with a ``deepseek_v3`` text
embedder (Moonlight-16B-A3B) in place of ELMo, through
``Predictor.predict_batch``.

The timing loop, the recorder of the stored features, the sample drawn
for the check and the notes are ``closed_loop.py``'s: this driver loads
its own instance of that module and gives it this model's parts (the
set-up, the speaker pool, the work counts, the reference and the compared
numbers), so the mix runs exactly as the ELMo cohort does.

Set-up: the fusion model's weights drawn from the seed on the card (as
``closed_loop.py`` draws them), the decoder's drawn tensor by tensor from
``(seed, name)`` on the card (``harness/lm_weights.py``, 62.5 GB at the
published widths) and handed to the ``Predictor`` as explicit parameters
with the lexicon, the pool (:class:`ZipfPool`), and one pass over it.

Check, after the window and once the predictor is freed: the decoder's
weights drawn again, the sample's answers through the plain reference
(``reference/moonlight.py``), the audio and the fusion through theirs.
The router's choices of every window call are kept on the device as it
makes them (``moe.route`` wrapped for the run; no value read before the
window ends).  An answer is excused when the program's experts differ from
the reference's somewhere, and every token that differs at the first
layer where any does has a reference selection margin (last selected less
first unselected of ``s + bias``) within the workload's ``tie_margin``:
there the two sides' float32 scores may order the experts either way, and
the answer's later layers differ by the swapped expert.  An answer that
first differs at a wider margin is compared like any other, and fails.
Compared: ``wav2vlad_rel``; ``lm_rel``, the widest gap of an answer's
features over the reference's largest, over the answers not excused;
``probs_abs`` over the speakers none of whose answers is excused;
``lm_tie_share``, the excused share of the answers.
"""

from __future__ import annotations

import dataclasses
import gc
import types

import numpy as np
import torch

from icassp2022_depression_tpu_torch import config as C
from icassp2022_depression_tpu_torch.models import moe_lm
from icassp2022_depression_tpu_torch.models.fusion import FusionNet
from icassp2022_depression_tpu_torch.ops import moe, rnn_cuda
from icassp2022_depression_tpu_torch.serving.predictors import Predictor
from portbench.counts import flops as F
from portbench.counts import moe_lm as lm_counts
from portbench.harness import lm_weights, registry, weights
from portbench.harness.cell import Cell
from portbench.harness.requests import SpeakerPool, _grid
from portbench.reference import models as ref_models
from portbench.reference import moonlight as ref_lm
from portbench.reference import wav2vlad as ref_w2v


class ZipfPool(SpeakerPool):
    """:class:`SpeakerPool` whose transcripts draw each character by a Zipf
    law of the mix's ``zipf_exponent`` over the characters' ranks (rank r
    the r-th character), from the seed; lengths and marks as there."""

    def __init__(self, mix: dict, seed: int, chars=(), text: bool = True):
        super().__init__(mix, seed, chars, text=False)
        if not text:
            return
        rng = np.random.default_rng([seed, 13])
        lo, hi = mix["transcript_chars"]
        counts = self._triples(np.round(_grid(lo, hi + 1, 3 * self.size)
                                        - 0.5).astype(np.int64).clip(lo, hi),
                               rng)
        p = np.arange(1, len(self.chars) + 1, dtype=np.float64) \
            ** -float(mix["zipf_exponent"])
        ids = rng.choice(len(self.chars), int(counts.sum()), p=p / p.sum())
        pieces = np.split(ids, np.cumsum(counts)[:-1])
        sentences = ["".join(self.chars[i] for i in piece)
                     for piece in pieces]
        self.texts = [sentences[3 * i:3 * i + 3] for i in range(self.size)]


def lm_config(cfg: dict) -> C.MoeLmConfig:
    """The configuration file's published and assumed keys -> the
    program's config."""
    return C.MoeLmConfig(**{f.name: cfg[f.name]
                            for f in dataclasses.fields(C.MoeLmConfig)})


def _shapes(cfg: dict) -> dict:
    return moe_lm.param_shapes(lm_config(cfg))


def _chars(cfg: dict) -> list:
    return [chr(0x4E00 + i) for i in range(cfg["lexicon_chars"])]


def _build(cell: Cell):
    """-> (predictor, the fusion's host weights, the lexicon, the pool's
    characters)."""
    cfg, dev = cell.config, cell.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(cell.seed)
    model = FusionNet(C.FusionConfig(**cfg["fusion"]), None, device=dev)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    drawn = weights.draw(weights.state_specs(shapes), gen, dev)
    model.load_state_dict(drawn)
    ref = {"model": weights.to_host(drawn)}
    del drawn
    chars = _chars(cfg)
    lexicon = lm_weights.lexicon(chars, cell.seed, cfg["bos_id"])
    params = {"weights": lm_weights.draw(_shapes(cfg), cell.seed, dev),
              "lexicon": lexicon}
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    predictor = Predictor(model, cfg["task"], frontend_cfg=C.FrontendConfig(
        **cfg["frontend"]), device=dev, elmo_params=params,
        elmo_cfg=lm_config(cfg), segmenter=cfg["segmenter"])
    return predictor, ref, lexicon, chars


def _tokens(pool, s: int, lexicon, cfg) -> list:
    return [len(ref_lm.token_ids(t, lexicon, cfg))
            for t in pool.speaker(s)[1]]


def _work(cell: Cell, pool, speakers, text: bool) -> dict:
    """Useful operations of the traced calls (wav2vlad, the decoder from
    the answers' real tokens, the fusion) and the grouped-expert launches'
    least time."""
    cfg, k = cell.config, cell.traffic["speakers_per_call"]
    lexicon = lm_weights.lexicon(_chars(cfg), cell.seed, cfg["bos_id"])
    total, bound = 0.0, 0.0
    calls = [speakers[i:i + k] for i in range(0, len(speakers), k)]
    for call in calls:
        total += sum(F.wav2vlad(len(w), cfg["frontend"]) for s in call
                     for w in pool.speaker(s)[0])
        tokens = [n for s in call for n in _tokens(pool, s, lexicon, cfg)]
        flops, experts_s = lm_counts.lm_call(tokens, cfg)
        total += flops + F.fuse_clf(len(call), cfg["fusion"])
        bound += experts_s
    return {"requests": len(calls), "speakers": len(speakers),
            "flops": total, "bound_s": {"moe_experts": bound}}


def _reference(cell: Cell, ref, lexicon, pool, sample, prec: str):
    """The sample's audio features, text features and probabilities by
    the plain references, with each answer's routing."""
    cfg, dev = cell.config, cell.device
    waves, texts = [], []
    for s in sample:
        w, t = pool.speaker(s)
        waves += w
        texts += t
    audio = ref_w2v.wav2vlad(waves, [0, 1, 2] * len(sample),
                             cfg["frontend"], dev, prec)
    audio = audio.reshape(len(sample), 3, -1)
    lm = lm_weights.draw(_shapes(cfg), cell.seed, dev)
    try:
        tfeat, routing = ref_lm.embed(texts, lm, lexicon, cfg, prec)
    finally:
        del lm
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
    tfeat = tfeat.reshape(len(sample), 3, -1)
    sd = {k: v.to(dev) for k, v in ref["model"].items()}
    probs = ref_models.fuse_clf(sd, torch.from_numpy(audio).to(dev),
                                torch.from_numpy(tfeat).to(dev),
                                cfg["fusion"], prec)
    return audio, tfeat, probs.cpu().numpy(), routing


def program_routing(routes, cell: Cell, pool, lexicon, sample) -> list:
    """The experts the window's calls chose for the sample's answers, as
    the reference gives its own: per answer, per expert layer, [T, k]
    sorted.  ``routes[c]``: window call c's router outputs in the order
    the program made them (per chunk of answers, its expert layers)."""
    cfg, k = cell.config, cell.traffic["speakers_per_call"]
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    first = -(-pool.size // k) * k               # the window's first speaker
    out = []
    for s in sample:
        c, j = divmod(s - first, k)
        lengths = [len(ref_lm.token_ids(t, lexicon, cfg))
                   for q in range(first + c * k, first + (c + 1) * k)
                   for t in pool.speaker(q)[1]]
        for q in range(3 * j, 3 * j + 3):
            chunk = q // moe_lm.CHUNK
            at = sum(lengths[chunk * moe_lm.CHUNK:q])
            out.append([idx[at:at + lengths[q]].sort(dim=-1).values
                        .cpu().numpy() for idx in
                        routes[c][chunk * layers:(chunk + 1) * layers]])
    return out


def excused(chosen: list, routing: list, tie_margin: float) -> bool:
    """Whether an answer's routing differs from the reference's first at
    tokens whose reference margin is within ``tie_margin``."""
    for experts, (ref_experts, margins) in zip(chosen, routing):
        differ = (experts != ref_experts).any(axis=1)
        if differ.any():
            return bool((margins[differ] <= tie_margin).all())
    return False


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


def compared(got, want, chosen: list, tie_margin: float) -> dict:
    """The check's numbers: ``got`` (audio rows, text rows, probabilities)
    of the timed path and ``chosen`` its experts for each answer; ``want``
    the reference's, with its routing."""
    audio, text, probs, routing = want
    ex = np.array([excused(c, r, tie_margin) for c, r in
                   zip(chosen, routing)]).reshape(len(text), 3)
    lm_rel = [_rel(g[j], w[j]) for g, w, e in zip(got[1], text, ex)
              for j in range(3) if not e[j]]
    probs_gap = np.abs(got[2] - probs)[~ex.any(axis=1)]
    return {"wav2vlad_rel": max(_rel(g, w) for g, w in zip(got[0], audio)),
            "lm_rel": max(lm_rel, default=0.0),
            "probs_abs": float(probs_gap.max()) if probs_gap.size else 0.0,
            "lm_tie_share": float(ex.mean())}


def _counts_with_experts() -> dict:
    return {**rnn_cuda.launch_counts(), "moe_experts": moe.LAUNCHES}


def run(cell: Cell):
    """``closed_loop.py``'s run with this model's parts, the router's
    choices recorded over the window."""
    loop = registry.driver("closed_loop")
    tie_margin = float(cell.workload["tie_margin"])
    seen = {}

    class RouteRecorder(loop._Recorder):
        """The stored features of each window call, and its router's
        expert ids."""

        def __init__(self, cache):
            super().__init__(cache)
            self.routes, self.now = [], None
            seen["recorder"] = self

        def begin(self):
            super().begin()
            self.now = []

        def end(self):
            super().end()
            self.routes.append(self.now)
            self.now = None

    def reference(cell, ref, lexicon, pool, sample, prec):
        if "chosen" not in seen:
            seen["chosen"] = program_routing(
                seen["recorder"].routes, cell, pool, lexicon, sample)
        return _reference(cell, ref, lexicon, pool, sample, prec)

    def numbers(got, want, text):
        # the control's "got" is the reference in TF32, with its routing
        chosen = [[e for e, _ in r] for r in got[3]] if len(got) > 3 \
            else seen["chosen"]
        return compared(got, want, chosen, tie_margin)

    route = moe.route

    def recording_route(*args, **kw):
        idx, weights_ = route(*args, **kw)
        recorder = seen.get("recorder")
        if recorder is not None and recorder.now is not None:
            recorder.now.append(idx)
        return idx, weights_

    loop._Recorder = RouteRecorder
    loop._build = _build
    loop._work = _work
    loop._reference = reference
    loop._numbers = numbers
    loop.requests = types.SimpleNamespace(SpeakerPool=ZipfPool)
    loop.rnn_cuda = types.SimpleNamespace(launch_counts=_counts_with_experts)
    moe.route = recording_route
    try:
        return loop.run(cell)
    finally:
        moe.route = route
