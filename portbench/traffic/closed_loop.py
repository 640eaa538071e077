"""Closed-loop serving through ``Predictor.predict_batch``: one client sends
a call of ``speakers_per_call`` distinct speakers (3 raw answers each,
and 3 transcripts for a text model), waits for the answers, and sends the
next.  Speakers come from :class:`..harness.requests.SpeakerPool`.

Set-up: the model's and the ELMo bundle's weights drawn from the seed on
the card, the bundle written with the port's ``save_npz`` into ``TMPDIR``
and read by the ``Predictor`` (then deleted), the speaker pool, and one
pass over the pool, which warms every shape the window sends.

Window (``--trace 0``): calls until ``--seconds`` have passed; each call
timed on the host clock (the predictor returns host results, so the time
covers the device work).  ``family`` ``interactive`` reports the median
and 95th percentile of every call's latency, ``cohort`` the speakers
scored over the window's whole time.  ``--trace 1``: ``trace_calls``
calls under the profiler instead, with spans around the calls into each
layer.  A mix with ``collector_paused`` pauses Python's garbage collector
over either window.

Check: a sample drawn from the seed of the speakers the window scored, the
largest among them, through the plain reference (wav2vlad, ELMo, the
model) in float32 on the card once the predictor is freed: the widest
relative gap of the audio and text features the timed path produced (read
as the predictor stored them) and the widest gap of the served
probabilities.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time
import traceback

import numpy as np
import torch

from icassp2022_depression_tpu_torch import config as C
from icassp2022_depression_tpu_torch.frontend import audio, text
from icassp2022_depression_tpu_torch.models import (
    char_cnn,
    elmo,
    elmo_pretrained,
)
from icassp2022_depression_tpu_torch.models.audio_net import AudioNet
from icassp2022_depression_tpu_torch.models.fusion import FusionNet
from icassp2022_depression_tpu_torch.ops import rnn_cuda
from icassp2022_depression_tpu_torch.serving import predictors
from icassp2022_depression_tpu_torch.serving.predictors import Predictor
from icassp2022_depression_tpu_torch.utils.device import probe_link
from portbench.counts import flops as F
from portbench.counts.peaks import bound_s
from portbench.harness import card, requests, weights
from portbench.harness import trace as tr
from portbench.harness.cell import Cell, Compared, Context, Run, run_dir
from portbench.reference import elmo as ref_elmo
from portbench.reference import models as ref_models
from portbench.reference import wav2vlad as ref_w2v


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _lexicon_chars(cc: dict) -> list:
    """The char lexicon beyond its 6 specials: CJK code points from
    U+4E00 up (the order is assumed; the configuration lists it)."""
    return [chr(0x4E00 + i) for i in range(cc["n_chars"] - 6)]


class _Recorder:
    """Keeps the features the predictor stores for each speaker, in the
    order it stores them (all audio rows of a call, then all text rows),
    as it produced them: the tensors themselves, read after the window."""

    def __init__(self, cache):
        self.calls, self._now = [], None
        put = cache.put

        def recording_put(key, value):
            if self._now is not None:
                self._now.append(value)
            put(key, value)

        cache.put = recording_put

    def begin(self) -> None:
        self._now = []

    def end(self) -> None:
        self.calls.append(self._now)
        self._now = None


def _build(cell: Cell):
    """-> (predictor, reference weights, lexicons, pool chars)."""
    cfg, dev = cell.config, cell.device
    task = cfg["task"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(cell.seed)
    if task == "fuse_clf":
        model = FusionNet(C.FusionConfig(**cfg["fusion"]), None, device=dev)
    else:
        model = AudioNet(C.RNNConfig(**cfg["model"]), None, device=dev)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    drawn = weights.draw(weights.state_specs(shapes), gen, dev)
    model.load_state_dict(drawn)
    ref = {"model": weights.to_host(drawn)}
    del drawn
    lexicons, chars, bundle = None, [], None
    if task == "fuse_clf":
        cc, lm = cfg["char_cnn"], cfg["bilm"]
        chars = _lexicon_chars(cc)
        words = chars[:cfg["word_vocab"] - 4]
        lexicons = ref_elmo.lexicons_from(chars, words)
        flat = weights.draw(weights.elmo_specs(cc, lm, cc["n_chars"],
                                               len(lexicons["words"])),
                            gen, dev)
        tree, layers = weights.elmo_trees(flat, cc, lm)
        ccfg = char_cnn.CharCnnConfig(
            n_chars=cc["n_chars"], char_dim=cc["char_dim"],
            filters=tuple(tuple(f) for f in cc["filters"]),
            n_highway=cc["n_highway"], output_dim=cc["output_dim"],
            activation=cc["activation"],
            word_vocab=len(lexicons["words"]), word_dim=cc["word_dim"],
            max_chars=cc["max_chars"])
        lcfg = elmo.ElmoLstmpConfig(
            vocab_size=1, input_dim=cc["output_dim"],
            cell_size=lm["cell_size"], proj_size=lm["proj_size"],
            layers=lm["layers"], cell_clip=lm["cell_clip"],
            proj_clip=lm["proj_clip"])
        bundle = run_dir("elmo") / "bundle.npz"
        bundle.parent.mkdir(parents=True, exist_ok=True)
        elmo_pretrained.save_npz(bundle, elmo_pretrained.PretrainedElmo(
            ccfg, lcfg, tree, {"layers": layers}, lexicons["chars"],
            lexicons["words"]))
        ref["elmo"] = {"cc": weights.to_host(tree),
                       "layers": weights.to_host(layers)}
        del flat, tree, layers
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    try:
        predictor = Predictor(
            model, task, frontend_cfg=C.FrontendConfig(
                **cfg["frontend"]),
            device=dev, elmo_weights=None if bundle is None else str(bundle),
            segmenter=cfg.get("segmenter", "fallback"))
    finally:
        if bundle is not None:
            bundle.unlink(missing_ok=True)
    return predictor, ref, lexicons, chars


#: the calls into each layer, wrapped in ``portbench/*`` regions while the
#: traced window runs
LAYER_SPANS = [(predictors._FeatureCache, "key", "portbench/cache_key"),
               (audio, "extract_batch", "portbench/audio_frontend"),
               (text, "tokenize", "portbench/segment"),
               (Predictor, "_text_feature_rows", "portbench/text_frontend"),
               (elmo_pretrained, "build_batch", "portbench/build_batch"),
               (elmo_pretrained, "encode_pooled", "portbench/elmo_encode"),
               (Predictor, "predict_features",
                "portbench/model_and_readback")]


def _work(cell: Cell, pool, speakers, text: bool) -> dict:
    """Counts of the work of ``speakers`` (the traced calls' speakers):
    useful operations and the LSTMP forward's least time."""
    cfg, mix = cell.config, cell.traffic
    fe = cfg["frontend"]
    k = mix["speakers_per_call"]
    total, lstmp_bound = 0.0, 0.0
    calls = [speakers[i:i + k] for i in range(0, len(speakers), k)]
    for call in calls:
        sizes = [pool.speaker(s) for s in call]
        total += sum(F.wav2vlad(len(w), fe) for ws, _ in sizes for w in ws)
        if text:
            tokens = [len(ref_elmo.segment(t)) + 2 for _, ts in sizes
                      for t in ts]
            total += F.speakers_text(tokens, cfg["char_cnn"], cfg["bilm"])
            for start in range(0, len(tokens), 128):
                chunk = sum(tokens[start:start + 128])
                fl, nb = F.lstmp_fwd(chunk, cfg["bilm"])
                lstmp_bound += 2 * cfg["bilm"]["layers"] * bound_s(fl, nb)
            total += F.fuse_clf(len(call), cfg["fusion"])
        else:
            total += F.audio_clf(len(call), cfg["model"])
    return {"requests": len(calls), "speakers": len(speakers),
            "flops": total, "bound_s": {"lstmp_fwd": lstmp_bound}}


def _rel(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _reference(cell: Cell, ref, lexicons, pool, sample, prec: str):
    """The sample's audio features, text features and probabilities by
    the plain reference."""
    cfg, dev = cell.config, cell.device
    text = cfg["task"] == "fuse_clf"
    waves, texts = [], []
    for s in sample:
        w, t = pool.speaker(s)
        waves += w
        texts += t or []
    audio = ref_w2v.wav2vlad(waves, [0, 1, 2] * len(sample),
                             cfg["frontend"], dev, prec)
    audio = audio.reshape(len(sample), 3, -1)
    sd = {k: v.to(dev) for k, v in ref["model"].items()}
    xa = torch.from_numpy(audio).to(dev)
    if text:
        tfeat = ref_elmo.embed(texts, ref["elmo"], lexicons,
                               {**cfg["char_cnn"], **cfg["bilm"]}, dev, prec)
        tfeat = tfeat.reshape(len(sample), 3, -1)
        probs = ref_models.fuse_clf(sd, xa, torch.from_numpy(tfeat).to(dev),
                                    cfg["fusion"], prec)
    else:
        tfeat = None
        probs = ref_models.audio_clf(sd, xa, cfg["model"], prec)
    return audio, tfeat, probs.cpu().numpy()


def _numbers(got, want, text: bool) -> dict:
    out = {"wav2vlad_rel": max(_rel(g, w) for g, w in zip(got[0], want[0]))}
    if text:
        out["elmo_rel"] = max(_rel(g, w) for g, w in zip(got[1], want[1]))
    out["probs_abs"] = float(np.max(np.abs(got[2] - want[2])))
    return out


def run(cell: Cell) -> Run:
    mix, dev = cell.traffic, cell.device
    text = cell.config["task"] == "fuse_clf"
    k = int(mix["speakers_per_call"])
    predictor, ref, lexicons, chars = _build(cell)
    recorder = _Recorder(predictor.feature_cache)
    pool = requests.SpeakerPool(mix, cell.seed, chars, text)
    # warm-up: one pass over the pool, every shape of the window
    nxt = 0
    while nxt < pool.size:
        predictor.predict_batch(**pool.call(nxt, k))
        nxt += k
    _sync(dev)
    setup_s = time.perf_counter() - cell.started
    hits0, misses0 = (predictor.feature_cache.hits,
                      predictor.feature_cache.misses)
    launches0 = rnn_cuda.launch_counts()

    calls, failed, latencies = [], 0, []

    def one_call():
        nonlocal nxt, failed
        kw = pool.call(nxt, k)
        first = nxt
        nxt += k
        recorder.begin()
        t0 = time.perf_counter()
        try:
            out = predictor.predict_batch(**kw)
        except Exception:              # a failed request, counted
            failed += 1
            traceback.print_exc(file=sys.stderr)
            out = None
        latencies.append(time.perf_counter() - t0)
        recorder.end()
        calls.append((first, out))

    context = None
    # "collector_paused": the collector paused over the window, so that
    # a collection lands in no request's latency; what the window leaves
    # is collected after it
    paused = bool(mix.get("collector_paused", False))
    if paused:
        gc.collect()
        gc.freeze()
        gc.disable()
    if cell.trace:
        def window():
            for _ in range(int(mix["trace_calls"])):
                one_call()

        with tr.spans_around(LAYER_SPANS):
            trace = tr.profile(window)
        served = [s for first, out in calls if out is not None
                  for s in range(first, first + k)]
        context = Context(mix["family"], cell.config, trace,
                          _work(cell, pool, served, text))
        window_s = trace.window_s
    else:
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < cell.seconds:
            one_call()
        window_s = time.perf_counter() - t_start
    if paused:
        gc.enable()
        gc.unfreeze()
        gc.collect()
    memory_peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0

    run = Run(attempted=len(calls), failed=failed,
              memory_peak_bytes=memory_peak, context=context)
    done = [c for c in calls if c[1] is not None]
    spk = sum(k for _ in done)
    if not cell.trace:
        if mix["family"] == "interactive":
            ms = [1e3 * x for x in latencies]
            run.metrics["request_p50_ms"] = (statistics.median(ms), "ms")
            run.metrics["request_p95_ms"] = (
                statistics.quantiles(ms, n=20, method="inclusive")[-1]
                if len(ms) > 1 else ms[0], "ms")
        else:
            run.metrics["speakers_per_s"] = (spk / window_s, "speakers/s")
        run.metrics["setup_s"] = (setup_s, "s")
    launches = rnn_cuda.launch_counts()
    run.notes += [
        f"portbench: cell {cell.name} seed {cell.seed} device {dev}: "
        f"{len(calls)} calls, {spk} speakers in {window_s!r} s "
        f"({'traced' if cell.trace else 'timed'}), setup {setup_s!r} s",
        f"portbench: feature cache in the window: hits "
        f"{predictor.feature_cache.hits - hits0} misses "
        f"{predictor.feature_cache.misses - misses0} (expected 0 hits)",
        "portbench: kernel launches in the window: " + ", ".join(
            f"{n} {launches[n] - launches0[n]}" for n in launches
            if launches[n] != launches0[n]),
        f"portbench: peak device memory {memory_peak} bytes"]
    if dev == "cuda":
        link = probe_link(dev)
        run.notes += [f"portbench: card {card.smi()}",
                      f"portbench: host link up {link['up_mb_s']!r} MB/s "
                      f"down {link['down_mb_s']!r} MB/s"]

    # the check: a sample of the scored speakers, the largest in it
    scored = [(i, j) for i, (first, out) in enumerate(calls)
              if out is not None for j in range(k)]
    if not scored:
        return run
    rng = np.random.default_rng([cell.seed, 7])
    n_check = min(int(mix["check_speakers"]), len(scored))
    picks = set(rng.choice(len(scored), n_check, replace=False).tolist())
    picks.add(max(range(len(scored)), key=lambda i: pool.size_of(
        calls[scored[i][0]][0] + scored[i][1])))
    picks = sorted(picks)
    got_audio, got_text, got_probs, sample = [], [], [], []
    for i in picks:
        c, j = scored[i]
        first, out = calls[c]
        rows = recorder.calls[c]
        sample.append(first + j)
        got_audio.append(rows[j].float().cpu().numpy())
        if text:
            got_text.append(rows[k + j].float().cpu().numpy())
        got_probs.append(np.asarray(out[j]["probs"], np.float32))
    got = (got_audio, got_text, np.stack(got_probs))
    del predictor, recorder, calls
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    limits = cell.workload["limits"]
    t_ref = time.perf_counter()
    want = _reference(cell, ref, lexicons, pool, sample, "fp32")
    run.notes.append(f"portbench: the reference took "
                     f"{time.perf_counter() - t_ref!r} s")
    for name, value in _numbers(got, want, text).items():
        run.compared.append(Compared(name, value, float(limits[name])))
    if cell.control:
        low = _reference(cell, ref, lexicons, pool, sample, "tf32")
        for name, value in _numbers(low, want, text).items():
            run.control.append(Compared(name, value, float(limits[name])))
    run.notes.append(f"portbench: checked {len(sample)} speakers against "
                     "the plain reference")
    return run
