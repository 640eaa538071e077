#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``icassp2022_depression_tpu_torch``)
on one NVIDIA GPU: the serving path of the audio model, and the training
paths of both tracks (audio and text branches and their fusion), at full
width.

    python3 chip_smoke.py

Phases (each raises on failure, so the exit code is nonzero):

1. setup: require CUDA, print the card's name and power limit, turn TF32
   off, build the four kernels from ``icassp2022_depression_tpu_torch/csrc``
   (GRU and LSTM, forward and backward) with ``nvcc``, one compiler process
   per source, started together, and print the build time and the
   compiler's reports;
2. kernels: each CUDA kernel against its plain PyTorch version at the
   shapes of the paths below, a ragged shape and one the JAX package would
   stream ((256, 16, H)): outputs and dxp within 1e-5, dw and db within
   1e-5 of their largest magnitude, reruns bitwise equal, the LSTM
   backward with a nonzero cell-state cotangent; timed with CUDA events;
   the forward wrappers must refuse a CUDA input that requires grad;
3. serving: a synthetic EATD corpus, a full-width ``audio_clf`` with seeded
   random weights saved as a JAX-layout npz, ``cli predict`` for one
   speaker and ``Predictor.predict_batch`` for 1, 3 and 8 speakers, the
   GRU forward kernel launched twice per forward; outputs equal (1e-5) to
   the plain recurrence's and, for ``cli predict``, to the CPU's;
4. training: a synthetic corpus of 24 + 12 speakers, its wav2vlad features
   extracted on the card and written with seeded synthetic text features
   ([N, 3, 1024], shifted by label; the ELMo frontend is not ported yet) as
   a JAX-layout npz root.  Counted, each with every kernel counter zeroed
   just before and read just after: ``cli pipeline --track clf`` at the
   full recipes (audio_clf 170, text_clf 150, fuse_clf 100 epochs, 3
   folds each), ``cli train --task audio_clf --corpus`` and ``cli
   pipeline --track reg`` (folds cut to the corpus) at 20 epochs.  Per
   stage the launches must be exact (audio: 2 GRU forwards per step and
   eval, 2 GRU backwards per step; text: 4 LSTM forwards per step and
   eval, 4 LSTM backwards per step; fusion: 4 LSTM and 2 GRU forwards per
   step and per fold, and no backward kernel at all), the metrics finite
   and every gated fold's artifacts written.  Comparisons, not counted:
   5-epoch ``audio_clf``, ``audio_reg``, ``text_clf`` and ``fuse_clf``
   folds through the kernels against the plain recurrence on the card
   with the same dropout masks, and ``audio_clf`` and ``text_clf`` folds
   with dropout 0 on the card against the CPU (per-step losses within
   1e-5, relative to the largest loss for the L1 loss on SDS scores;
   final params within 1e-5 of the largest |param|);
5. timing: warm ``predict_batch`` latency at 1 and 8 speakers; the wall
   time of each pipeline stage; an ``audio_clf`` and a ``text_clf`` train
   step split into forward, backward and optimizer.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Nothing of JAX is imported.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
KERNEL_TOL = 1e-5
SLICE_TOL = 1e-5
KERNEL_SHAPES = ((3, 1, 256), (3, 4, 256), (3, 8, 256), (3, 24, 256),
                 (7, 3, 200))
TIMED_SHAPES = ((3, 8, 256), (3, 24, 256))
BATCHES = (1, 3, 8)
#: the training shapes (audio_clf batch 8, audio_reg batch 2, eval of a
#: 24-row test split), a ragged one, and one the JAX package would stream
#: (its backward working set, ~35 MB, exceeds `_pallas_fits`' 12 MB)
BWD_SHAPES = ((3, 8, 256), (3, 2, 256), (3, 24, 256), (7, 3, 200),
              (256, 16, 256))
BWD_TIMED = ((3, 8, 256), (3, 2, 256))
#: the LSTM at the text model's H = 128: the training batches (text_clf 4,
#: text_reg and fuse_clf 2), an eval split, a ragged shape, and one the JAX
#: package would stream
LSTM_SHAPES = ((3, 4, 128), (3, 2, 128), (3, 24, 128), (7, 3, 100),
               (256, 16, 128))
LSTM_TIMED = ((3, 4, 128), (3, 2, 128))
TRAIN_TOL = 1e-5
COMPARE_EPOCHS = 5
#: epochs of the runs cut to keep the script short (cli train --corpus and
#: the reg pipeline); the clf pipeline runs the full recipes
REDUCED_EPOCHS = 20
#: per-dimension shift of the synthetic text features by label (+-)
TEXT_SHIFT = 0.1


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int, torch) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` single calls."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_phase(torch, rnn_cuda, card: str):
    worst = 0.0
    gen = torch.Generator().manual_seed(0)
    inputs = {}
    for t, b, h in KERNEL_SHAPES:
        bound = h ** -0.5
        xp = torch.randn((t, b, 3 * h), generator=gen).cuda()
        w = ((torch.rand((h, 3 * h), generator=gen) * 2 - 1) * bound).cuda()
        bias = ((torch.rand((1, 3 * h), generator=gen) * 2 - 1)
                * bound).cuda()
        ys = rnn_cuda.gru_sequence(xp, w, bias)
        ref = rnn_cuda.gru_sequence_torch(xp, w, bias)
        torch.cuda.synchronize()
        if ys.shape != (t, b, h) or not torch.isfinite(ys).all():
            fail(f"kernel output at {(t, b, h)} is malformed")
        err = (ys - ref).abs().max().item()
        print(f"kernel gru_fwd T={t} B={b} H={h}: max|cuda - plain| = "
              f"{err:.3e} (tol {KERNEL_TOL})")
        if not err <= KERNEL_TOL:
            fail(f"GRU kernel disagrees with its plain version at "
                 f"{(t, b, h)}: {err}")
        worst = max(worst, err)
        inputs[(t, b, h)] = (xp, w, bias)
    timings = {}
    for shape in TIMED_SHAPES:
        xp, w, bias = inputs[shape]
        for _ in range(5):
            rnn_cuda.gru_sequence(xp, w, bias)
            rnn_cuda.gru_sequence_torch(xp, w, bias)
        ms = event_ms(lambda: rnn_cuda.gru_sequence(xp, w, bias), 50, torch)
        plain = event_ms(
            lambda: rnn_cuda.gru_sequence_torch(xp, w, bias), 50, torch)
        timings[shape] = (ms, plain)
        print(f"timing gru_fwd T={shape[0]} B={shape[1]} H={shape[2]}: "
              f"cuda kernel {ms:.4f} ms, plain torch {plain:.4f} ms "
              f"(median of 50, CUDA events) [{card}]")
    return worst, timings


def check_results(results, n: int, what: str) -> None:
    if len(results) != n:
        fail(f"{what}: {len(results)} results for {n} speakers")
    for r in results:
        probs = r["probs"]
        if len(probs) != 2 or not all(map(_finite, probs)):
            fail(f"{what}: malformed probabilities {probs}")
        if abs(sum(probs) - 1.0) > SLICE_TOL:
            fail(f"{what}: probabilities sum to {sum(probs)}")
        if r["label"] != max(range(2), key=probs.__getitem__):
            fail(f"{what}: label {r['label']} is not argmax of {probs}")


def _finite(x: float) -> bool:
    return x == x and abs(x) != float("inf")


def compare(a, b, what: str) -> float:
    worst = 0.0
    for ra, rb in zip(a, b):
        if ra["label"] != rb["label"]:
            fail(f"{what}: labels differ {ra} vs {rb}")
        worst = max(worst, max(abs(x - y)
                               for x, y in zip(ra["probs"], rb["probs"])))
    if not worst <= SLICE_TOL:
        fail(f"{what}: probabilities differ by {worst}")
    return worst


def slice_phase(torch, card: str):
    from icassp2022_depression_tpu_torch import cli
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import eatd
    from icassp2022_depression_tpu_torch.models import porting
    from icassp2022_depression_tpu_torch.models.audio_net import AudioNet
    from icassp2022_depression_tpu_torch.ops import rnn_cuda
    from icassp2022_depression_tpu_torch.serving.predictors import Predictor
    from icassp2022_depression_tpu_torch.train import checkpoints

    cfg = C.AUDIO_CLF.model
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp) / "corpus"
        t0 = time.perf_counter()
        eatd.make_synthetic_corpus(root, n_data=8, n_validation=4,
                                   seconds=(2.0, 12.0), seed=0)
        model = AudioNet(cfg, generator=torch.Generator().manual_seed(0))
        ckpt = checkpoints.save(
            Path(tmp) / "audio_clf",
            porting.audio_net_tree_from_state_dict(model.state_dict(), cfg),
            {"task": "audio_clf", "note": "random weights, seed 0"})
        speakers = list(eatd.iter_speakers(root, read_text=False))
        positions = [eatd.corpus_position(root, s.split, s.number)
                     for s in speakers]
        print(f"slice setup: {len(speakers)} speakers, answers "
              f"{min(min(s.durations) for s in speakers):.1f}-"
              f"{max(max(s.durations) for s in speakers):.1f} s, "
              f"{time.perf_counter() - t0:.2f} s")

        # -- the main path, counted ------------------------------------
        rnn_cuda.LAUNCHES = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["predict", "--task", "audio_clf", "--ckpt",
                           str(ckpt), "--root", str(root), "--speaker",
                           "Data/1", "--device", "cuda"])
        if rc != 0:
            fail(f"cli predict returned {rc}")
        cli_out = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(f"cli predict Data/1: {json.dumps(cli_out)} "
              f"(kernel launches {rnn_cuda.LAUNCHES})")
        if rnn_cuda.LAUNCHES != 2:
            fail(f"cli predict launched the GRU kernel {rnn_cuda.LAUNCHES} "
                 "times, expected 2 (one per layer)")
        check_results([cli_out], 1, "cli predict")

        predictor = Predictor.from_checkpoint(ckpt, "audio_clf",
                                              device="cuda")
        requests = {}
        outputs = {}
        for n in BATCHES:
            sel = list(range(n))
            req = ([speakers[i].waveforms for i in sel],
                   [speakers[i].sample_rates for i in sel],
                   [3 * positions[i] for i in sel])
            before = rnn_cuda.LAUNCHES
            outputs[n] = predictor.predict_batch(req[0], req[1],
                                                 ordinal_bases=req[2])
            grew = rnn_cuda.LAUNCHES - before
            print(f"predict_batch {n} speakers: kernel launches +{grew}")
            if grew != 2:
                fail(f"predict_batch({n}) launched the kernel {grew} "
                     "times, expected 2")
            check_results(outputs[n], n, f"predict_batch({n})")
            requests[n] = req
        launches = rnn_cuda.LAUNCHES

        # -- comparison runs (not counted) -----------------------------
        plain = Predictor.from_checkpoint(
            ckpt, "audio_clf", device="cuda",
            model_cfg=C.replace(cfg, rnn_backend="torch"))
        worst = 0.0
        for n in BATCHES:
            ref = plain.predict_batch(requests[n][0], requests[n][1],
                                      ordinal_bases=requests[n][2])
            worst = max(worst, compare(outputs[n], ref,
                                       f"predict_batch({n}) vs plain GRU"))
        print(f"predict_batch vs plain-GRU forward: max|dprob| = "
              f"{worst:.3e} (tol {SLICE_TOL})")
        cpu = Predictor.from_checkpoint(ckpt, "audio_clf", device="cpu")
        ref_cpu = cpu.predict_speaker(speakers[0].waveforms,
                                      speakers[0].sample_rates,
                                      ordinal_base=3 * positions[0])
        d_cpu = compare([cli_out], [ref_cpu], "cli predict vs CPU run")
        print(f"cli predict vs the same predictor on the CPU: max|dprob| = "
              f"{d_cpu:.3e} (tol {SLICE_TOL})")
        if rnn_cuda.LAUNCHES != launches:
            fail("a comparison run launched the CUDA kernel")

        # -- warm serving latency ----------------------------------------
        uncached = Predictor.from_checkpoint(ckpt, "audio_clf",
                                             device="cuda",
                                             feature_cache_entries=0)
        latency = {}
        for n in (1, 8):
            req = requests[n]
            for _ in range(3):
                uncached.predict_batch(req[0], req[1], ordinal_bases=req[2])
            times = []
            for _ in range(10):
                t0 = time.perf_counter()
                uncached.predict_batch(req[0], req[1], ordinal_bases=req[2])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            latency[n] = statistics.median(times)
            audio_s = sum(sum(s.durations) for s in speakers[:n])
            print(f"timing predict_batch {n} speakers ({audio_s:.1f} s of "
                  f"audio, features not cached): median "
                  f"{latency[n]:.2f} ms of 10 (host clock) [{card}]")
    return launches, latency


def bwd_kernel_phase(torch, rnn_cuda, card: str):
    """The backward kernel against its plain version; returns the worst
    |d dxp| and the (kernel, plain) ms at the timed shapes."""
    worst = 0.0
    gen = torch.Generator().manual_seed(1)
    inputs = {}
    for t, b, h in BWD_SHAPES:
        bound = h ** -0.5
        xp = torch.randn((t, b, 3 * h), generator=gen).cuda()
        w = ((torch.rand((h, 3 * h), generator=gen) * 2 - 1) * bound).cuda()
        bias = ((torch.rand((1, 3 * h), generator=gen) * 2 - 1)
                * bound).cuda()
        ys = rnn_cuda.gru_sequence_torch(xp, w, bias)
        dys = torch.randn((t, b, h), generator=gen).cuda()
        got = rnn_cuda.gru_sequence_bwd(xp, w, bias, ys, dys)
        ref = rnn_cuda.gru_sequence_bwd_torch(xp, w, bias, ys, dys)
        again = rnn_cuda.gru_sequence_bwd(xp, w, bias, ys, dys)
        torch.cuda.synchronize()
        shapes = ((t, b, 3 * h), (h, 3 * h), (1, 3 * h))
        for g, want in zip(got, shapes):
            if tuple(g.shape) != want or not torch.isfinite(g).all():
                fail(f"backward kernel output at {(t, b, h)} is malformed")
        err = (got[0] - ref[0]).abs().max().item()
        rel = [((g - r).abs().max() / r.abs().max()).item()
               for g, r in zip(got[1:], ref[1:])]
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        print(f"kernel gru_bwd T={t} B={b} H={h}: max|d dxp| = {err:.3e} "
              f"(tol {KERNEL_TOL}), dw rel {rel[0]:.3e}, db rel "
              f"{rel[1]:.3e} (tol {KERNEL_TOL} of max|ref|), rerun "
              f"bitwise equal: {same}")
        if not (err <= KERNEL_TOL and max(rel) <= KERNEL_TOL and same):
            fail(f"GRU backward kernel disagrees with its plain version "
                 f"at {(t, b, h)}: dxp {err}, dw/db {rel}, rerun {same}")
        worst = max(worst, err)
        inputs[(t, b, h)] = (xp, w, bias, ys, dys)
    try:
        rnn_cuda.gru_sequence(xp.clone().requires_grad_(), w, bias)
    except ValueError:
        pass
    else:
        fail("gru_sequence returned a detached result for an input that "
             "requires grad")
    timings = {}
    for shape in BWD_TIMED:
        args = inputs[shape]
        for _ in range(5):
            rnn_cuda.gru_sequence_bwd(*args)
            rnn_cuda.gru_sequence_bwd_torch(*args)
        ms = event_ms(lambda: rnn_cuda.gru_sequence_bwd(*args), 50, torch)
        plain = event_ms(lambda: rnn_cuda.gru_sequence_bwd_torch(*args), 50,
                         torch)
        timings[shape] = (ms, plain)
        print(f"timing gru_bwd T={shape[0]} B={shape[1]} H={shape[2]}: "
              f"cuda kernel {ms:.4f} ms, plain torch {plain:.4f} ms "
              f"(median of 50, CUDA events) [{card}]")
    return worst, timings


def lstm_kernel_phase(torch, rnn_cuda, card: str):
    """Both LSTM kernels against their plain versions, the backward with a
    nonzero cell-state cotangent; returns the worst errors and the
    (kernel, plain) ms of each at the timed shapes."""
    worst = {"fwd": 0.0, "bwd": 0.0}
    gen = torch.Generator().manual_seed(2)
    inputs = {}
    for t, b, h in LSTM_SHAPES:
        bound = h ** -0.5
        xp = torch.randn((t, b, 4 * h), generator=gen).cuda()
        w = ((torch.rand((h, 4 * h), generator=gen) * 2 - 1) * bound).cuda()
        bias = ((torch.rand((1, 4 * h), generator=gen) * 2 - 1)
                * bound).cuda()
        dys = torch.randn((t, b, h), generator=gen).cuda()
        dcs = torch.randn((t, b, h), generator=gen).cuda()
        ys, cs = rnn_cuda.lstm_sequence(xp, w, bias)
        ref_ys, ref_cs = rnn_cuda.lstm_sequence_torch(xp, w, bias)
        args = (xp, w, bias, ref_ys, ref_cs, dys, dcs)
        got = rnn_cuda.lstm_sequence_bwd(*args)
        again = rnn_cuda.lstm_sequence_bwd(*args)
        ref = rnn_cuda.lstm_sequence_bwd_torch(*args)
        torch.cuda.synchronize()
        for g, want in zip((ys, cs) + got,
                           ((t, b, h), (t, b, h), (t, b, 4 * h),
                            (h, 4 * h), (1, 4 * h))):
            if tuple(g.shape) != want or not torch.isfinite(g).all():
                fail(f"LSTM kernel output at {(t, b, h)} is malformed")
        fwd = max((ys - ref_ys).abs().max().item(),
                  (cs - ref_cs).abs().max().item())
        bwd = (got[0] - ref[0]).abs().max().item()
        rel = [((g - r).abs().max() / r.abs().max()).item()
               for g, r in zip(got[1:], ref[1:])]
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        print(f"kernel lstm_fwd/lstm_bwd T={t} B={b} H={h}: max|d ys|, "
              f"|d cs| = {fwd:.3e}, max|d dxp| = {bwd:.3e} (tol "
              f"{KERNEL_TOL}), dw rel {rel[0]:.3e}, db rel {rel[1]:.3e} (tol "
              f"{KERNEL_TOL} of max|ref|), dcs nonzero, rerun bitwise equal: "
              f"{same}")
        if not (fwd <= KERNEL_TOL and bwd <= KERNEL_TOL
                and max(rel) <= KERNEL_TOL and same):
            fail(f"LSTM kernels disagree with their plain versions at "
                 f"{(t, b, h)}: fwd {fwd}, dxp {bwd}, dw/db {rel}, rerun "
                 f"{same}")
        worst["fwd"] = max(worst["fwd"], fwd)
        worst["bwd"] = max(worst["bwd"], bwd)
        inputs[(t, b, h)] = args
    try:
        rnn_cuda.lstm_sequence(xp.clone().requires_grad_(), w, bias)
    except ValueError:
        pass
    else:
        fail("lstm_sequence returned a detached result for an input that "
             "requires grad")
    timings = {}
    for shape in LSTM_TIMED:
        args = inputs[shape]
        for _ in range(5):
            rnn_cuda.lstm_sequence(*args[:3])
            rnn_cuda.lstm_sequence_torch(*args[:3])
            rnn_cuda.lstm_sequence_bwd(*args)
            rnn_cuda.lstm_sequence_bwd_torch(*args)
        timings[shape] = {
            "fwd": (event_ms(lambda: rnn_cuda.lstm_sequence(*args[:3]), 50,
                             torch),
                    event_ms(lambda: rnn_cuda.lstm_sequence_torch(*args[:3]),
                             50, torch)),
            "bwd": (event_ms(lambda: rnn_cuda.lstm_sequence_bwd(*args), 50,
                             torch),
                    event_ms(lambda: rnn_cuda.lstm_sequence_bwd_torch(*args),
                             50, torch))}
        for k, (ms, plain) in timings[shape].items():
            print(f"timing lstm_{k} T={shape[0]} B={shape[1]} H={shape[2]}: "
                  f"cuda kernel {ms:.4f} ms, plain torch {plain:.4f} ms "
                  f"(median of 50, CUDA events) [{card}]")
    return worst, timings


def _counts(rnn_cuda) -> dict:
    return {"gru_fwd": rnn_cuda.LAUNCHES, "gru_bwd": rnn_cuda.BWD_LAUNCHES,
            "lstm_fwd": rnn_cuda.LSTM_LAUNCHES,
            "lstm_bwd": rnn_cuda.LSTM_BWD_LAUNCHES}


def _set_counts(rnn_cuda, counts: dict) -> None:
    rnn_cuda.LAUNCHES, rnn_cuda.BWD_LAUNCHES = (counts["gru_fwd"],
                                                counts["gru_bwd"])
    rnn_cuda.LSTM_LAUNCHES, rnn_cuda.LSTM_BWD_LAUNCHES = (
        counts["lstm_fwd"], counts["lstm_bwd"])


ZERO = {"gru_fwd": 0, "gru_bwd": 0, "lstm_fwd": 0, "lstm_bwd": 0}


def expected_launches(task: str, steps: int, evals: int, folds: int) -> dict:
    """Two GRU layers (audio), two layers x two directions of LSTM (text):
    one forward per layer and direction per step and per eval, one backward
    per step.  The fusion trains only its head: its frozen branches run
    forward once per step and once per fold (the test split's features),
    and no backward kernel launches."""
    if task.startswith("audio"):
        return dict(ZERO, gru_fwd=2 * (steps + evals), gru_bwd=2 * steps)
    if task.startswith("text"):
        return dict(ZERO, lstm_fwd=4 * (steps + evals), lstm_bwd=4 * steps)
    return dict(ZERO, gru_fwd=2 * (steps + folds),
                lstm_fwd=4 * (steps + folds))


def _check_launches(task: str, got: dict, steps: int, evals: int,
                    folds: int) -> None:
    want = expected_launches(task, steps, evals, folds)
    print(f"{task}: {steps} optimizer steps, {evals} evals, {folds} folds; "
          f"kernel launches {got}")
    if got != want:
        fail(f"{task} launched {got}, expected {want}")


def write_npz_root(root: Path, feats, sds, clf, seed: int = 3) -> None:
    """``Features/{AudioWhole,TextWhole}`` in the JAX package's npz layout:
    the audio from the port's own extraction, the text [N, 3, 1024] drawn
    from a seeded normal with a label-dependent shift (the ELMo frontend
    is not ported yet), and an extraction_meta.json naming that."""
    import numpy as np

    audio = root / "Features" / "AudioWhole"
    text = root / "Features" / "TextWhole"
    audio.mkdir(parents=True)
    text.mkdir(parents=True)
    xa = feats.cpu().numpy()[:, :, None, :]
    rng = np.random.default_rng(seed)
    xt = (rng.standard_normal((len(clf), 3, 1024), dtype=np.float32)
          + np.float32(TEXT_SHIFT) * (2 * clf - 1)[:, None, None]
          ).astype(np.float32)
    for track, y in (("clf", clf), ("reg", sds)):
        np.savez(audio / f"whole_samples_{track}_256.npz", xa)
        np.savez(audio / f"whole_labels_{track}_256.npz", y)
        np.savez(text / f"whole_samples_{track}_avg.npz", xt)
        np.savez(text / f"whole_labels_{track}_avg.npz", y)
    (text / "extraction_meta.json").write_text(json.dumps(
        {"embedder": f"synthetic-normal-seed{seed}", "segmenter": None}))


PIPELINE_TASKS = {"clf": ("audio_clf", "text_clf", "fuse_clf"),
                  "reg": ("audio_reg", "text_reg", "fuse_reg")}


def pipeline_run(torch, root: Path, track: str, card: str,
                 fold_cfg=None) -> dict:
    """``cli pipeline --track <track>`` on the npz root, counted: every
    kernel counter is zeroed just before and read just after, and each
    stage's launches and wall time are recorded by wrapping its trainer
    (``fold_cfg``, when given, is passed to the reg trainers).  Checks the
    launches of each stage, the metrics, the summary line and every gated
    fold's artifacts; returns the launches and the stage wall times."""
    from icassp2022_depression_tpu_torch import cli
    from icassp2022_depression_tpu_torch.ops import rnn_cuda
    from icassp2022_depression_tpu_torch.train import checkpoints, trainers

    tasks = PIPELINE_TASKS[track]
    stages: dict = {}
    originals = {t: getattr(trainers, f"train_{t}") for t in tasks}

    def staged(task, fn):
        def run(*args, **kwargs):
            if fold_cfg is not None:
                kwargs["fold_cfg"] = fold_cfg
            before = _counts(rnn_cuda)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            after = _counts(rnn_cuda)
            stages[task] = (time.perf_counter() - t0,
                            {k: after[k] - before[k] for k in after})
            return out
        return run

    for t, fn in originals.items():
        setattr(trainers, f"train_{t}", staged(t, fn))
    buf = io.StringIO()
    try:
        _set_counts(rnn_cuda, ZERO)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["pipeline", "--track", track, "--root",
                           str(root), "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = _counts(rnn_cuda)
    finally:
        for t, fn in originals.items():
            setattr(trainers, f"train_{t}", fn)
    if rc != 0:
        fail(f"cli pipeline --track {track} returned {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"cli pipeline --track {track}: {json.dumps(summary)}")
    metric = "f1" if track == "clf" else "mae"
    records = [json.loads(line) for line in
               (root / "Model" / f"pipeline_{track}_metrics.jsonl")
               .read_text().splitlines()]
    model = root / "Model"
    for task in tasks:
        epochs = [r for r in records
                  if r["event"] == "epoch" and r["trainer"] == task]
        bests = [r for r in records
                 if r["event"] == "fold_best" and r["trainer"] == task]
        for r in epochs:
            bad = [k for k, v in r.items()
                   if isinstance(v, float) and not _finite(v)]
            if bad:
                fail(f"{task}: non-finite metrics logged: {r}")
        if len(bests) != 3 or summary[f"{task.split('_')[0]}_{metric}"] \
                != [round(b[metric], 4) for b in bests]:
            fail(f"{task}: {len(bests)} fold results, summary {summary}")
        _check_launches(task, stages[task][1],
                        int(sum(r["steps"] for r in epochs)), len(epochs),
                        len(bests))
        gated = [r for r in bests if r["epoch"] >= 0]
        for r in gated:
            for f in _artifacts(checkpoints, model, task, r):
                if not f.is_file():
                    fail(f"gated {task} fold {r['fold']} wrote no {f}")
            if not task.startswith("audio"):
                meta = checkpoints.load_meta(
                    next(iter(_artifacts(checkpoints, model, task, r))))
                if not meta.get("text_embedder", "").startswith("synthetic"):
                    fail(f"{task} sidecar lacks the text provenance: {meta}")
        print(f"  {task}: {len(gated)} of 3 folds gated, their artifacts "
              f"written; wall {stages[task][0]:.2f} s [{card}]")
    if total != {k: sum(st[1][k] for st in stages.values()) for k in total}:
        fail(f"launches outside the trainers: {total}, stages {stages}")
    print(f"cli pipeline --track {track}: wall {wall:.2f} s, launches "
          f"{total} [{card}]")
    return {"launches": total, "wall_s": wall,
            "stage_s": {t: st[0] for t, st in stages.items()}}


def _artifacts(checkpoints, model: Path, task: str, r: dict) -> list:
    """The files the JAX package's trainers write for a gated fold, the
    npz first."""
    branch, track = task.split("_")
    sub = {"audio": "Audio", "text": "Text", "fuse": "Fuse"}[branch]
    if track == "clf":
        f1, fold = r["f1"], r["fold"]
        name = (checkpoints.audio_clf_name(256, 256, f1, fold)
                if branch == "audio" else
                checkpoints.text_clf_name(128, f1, fold)
                if branch == "text" else checkpoints.fuse_clf_name(f1, fold))
        d = model / "ClassificationWhole" / sub
        return [d / f"{name}.npz", d / f"{name}.json",
                d / "train_idxs_{:.2f}_{}.npy".format(f1, fold)]
    mae = r["mae"]
    name = (checkpoints.audio_reg_name(256, 256, mae) if branch == "audio"
            else checkpoints.text_reg_name(128, mae) if branch == "text"
            else checkpoints.fuse_reg_name(mae))
    d = model / "Regression" / f"{sub}{r['fold']}"
    return [d / f"{name}.npz", d / f"{name}.json"]


def _fold_run(torch, tcfg, data, device):
    """One branch fold through the trainers' own pieces; returns the
    per-step losses and the final params."""
    from icassp2022_depression_tpu_torch.train import loop, optim, trainers

    model = trainers.init_model(tcfg, 0, 1, device)
    opt = optim.build(tcfg.optimizer, model)
    _, _, step_losses = loop.run_fold(
        model, opt, *loop.model_fns(model, trainers._branch_fns(tcfg)), data,
        tcfg.track, tcfg.gate, tcfg.epochs,
        trainers.dropout_generator(0, 1, device))
    return step_losses, {k: v.cpu() for k, v in model.state_dict().items()}


def _fusion_fold_run(torch, fcfg, tcfg, data, branch, device):
    """One fusion fold as ``trainers._run_fusion_folds`` runs it (branch
    init, the test split's features once, only fc_final trains)."""
    from icassp2022_depression_tpu_torch.models.fusion import FusionNet
    from icassp2022_depression_tpu_torch.train import loop, optim, trainers

    model = FusionNet(fcfg, generator=torch.Generator().manual_seed(0))
    model = model.to(device)
    model.init_from_branches(*branch, tcfg.track)
    opt = optim.build(tcfg.optimizer, model)
    model.eval()
    tf, af = model.pretrained_feature(*data.test_x)
    data = data._replace(test_x=(torch.cat([tf, af], dim=-1),))
    _, _, step_losses = loop.run_fold(
        model, opt, *trainers._fusion_fns(model, tcfg), data, tcfg.track,
        tcfg.gate, tcfg.epochs, trainers.dropout_generator(0, 1, device))
    return step_losses, {k: v.cpu() for k, v in model.state_dict().items()}


def _syncs_in(torch, fn) -> int:
    """Synchronising CUDA calls made by ``fn()``, as torch's sync debug
    mode reports them."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught)


def _compare_runs(a, b, what: str, loss_scale: float = 1.0) -> tuple:
    (la, pa), (lb, pb) = a, b
    d_loss = float(abs(la - lb).max())
    scale = max(float(v.abs().max()) for v in pb.values())
    d_param = max(float((pa[k] - pb[k]).abs().max()) for k in pb)
    print(f"{what}: {la.size} steps, max|d step loss| = {d_loss:.3e} (tol "
          f"{TRAIN_TOL * loss_scale:.3e}), max|d param| = {d_param:.3e} (tol "
          f"{TRAIN_TOL} x max|param| = {TRAIN_TOL * scale:.3e})")
    if not (d_loss <= TRAIN_TOL * loss_scale
            and d_param <= TRAIN_TOL * scale):
        fail(f"{what} differ: loss {d_loss}, params {d_param}")
    return d_loss, d_param


def _plain(tcfg, C):
    return C.replace(tcfg, model=C.replace(tcfg.model, rnn_backend="torch"))


def _no_kernel(rnn_cuda, fn):
    """``fn()``, failing if it launched any kernel."""
    before = _counts(rnn_cuda)
    out = fn()
    if _counts(rnn_cuda) != before:
        fail("the plain recurrence launched a kernel")
    return out


def step_split(torch, tcfg, data, card: str, what: str,
               steps: int = 60) -> dict:
    """Median ms of a train step's forward (+ loss), backward and optimizer
    step, CUDA events between the phases, after 10 warm steps."""
    from icassp2022_depression_tpu_torch.train import optim, trainers

    model = trainers.init_model(tcfg, 0, 1, "cuda").train()
    opt = optim.build(tcfg.optimizer, model)
    loss_fn = trainers._branch_fns(tcfg)
    gen = trainers.dropout_generator(0, 1, "cuda")
    n_steps = -(-data.n_train // data.train_y.shape[1])
    marks = []
    for i in range(steps + 10):
        j = i % n_steps
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model(data.train_x[0][j], gen), data.train_y[j],
                       data.train_mask[j])
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        if i >= 10:
            marks.append(ev)
    torch.cuda.synchronize()
    split = {name: statistics.median(m[k].elapsed_time(m[k + 1])
                                     for m in marks)
             for k, name in enumerate(("forward", "backward", "optimizer"))}
    split["step"] = statistics.median(m[0].elapsed_time(m[3])
                                      for m in marks)
    print(f"timing {what} train step (batch {data.train_y.shape[1]}): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
          + f" (median of {steps}, CUDA events between phases) [{card}]")
    return split


def train_phase(torch, card: str):
    """The training paths, counted (the clf pipeline at the full recipes,
    ``cli train --corpus`` and the reg pipeline at reduced epochs), then
    the comparisons and timings.  Returns the counted launches."""
    from icassp2022_depression_tpu_torch import cli
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import eatd, folds
    from icassp2022_depression_tpu_torch.frontend import audio as afe
    from icassp2022_depression_tpu_torch.ops import rnn_cuda
    from icassp2022_depression_tpu_torch.train import trainers

    launches = dict(ZERO)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        corpus = Path(tmp) / "corpus"
        eatd.make_synthetic_corpus(corpus, n_data=24, n_validation=12,
                                   seconds=(2.0, 12.0), seed=1)
        t0 = time.perf_counter()
        feats, sds, clf = afe.extract_eatd_device(corpus, device="cuda")
        torch.cuda.synchronize()
        extract_s = time.perf_counter() - t0
        root = Path(tmp) / "npz"
        write_npz_root(root, feats, sds, clf)
        print(f"extract_eatd_device: {feats.shape[0]} speakers "
              f"({int(clf.sum())} depressed), {extract_s:.2f} s; npz root "
              f"written (text features synthetic, shift {TEXT_SHIFT}) "
              f"[{card}]")

        # -- main path: cli pipeline --track clf at the full recipes ------
        clf_run = pipeline_run(torch, root, "clf", card)
        for k, v in clf_run["launches"].items():
            launches[k] += v

        # -- cli train --task audio_clf --corpus, reduced epochs -----------
        full = {n: getattr(C, n) for n in
                ("AUDIO_CLF", "AUDIO_REG", "TEXT_REG", "FUSE_REG_TRAINER")}
        try:
            C.AUDIO_CLF = C.replace(full["AUDIO_CLF"],
                                    epochs=REDUCED_EPOCHS + 1)
            _set_counts(rnn_cuda, ZERO)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["train", "--task", "audio_clf", "--root",
                               str(corpus), "--corpus", str(corpus),
                               "--device", "cuda"])
            torch.cuda.synchronize()
            corpus_wall = time.perf_counter() - t0
            got = _counts(rnn_cuda)
            if rc != 0:
                fail(f"cli train returned {rc}")
            records = [json.loads(line) for line in
                       (corpus / "Model" / "audio_clf_metrics.jsonl")
                       .read_text().splitlines()]
            epochs = [r for r in records if r["event"] == "epoch"]
            if len(epochs) != 3 * REDUCED_EPOCHS or not all(
                    _finite(r["loss"]) for r in epochs):
                fail(f"cli train audio_clf logged {len(epochs)} epochs")
            _check_launches("audio_clf (cli train --corpus)", got,
                            int(sum(r["steps"] for r in epochs)),
                            len(epochs), 3)
            for k, v in got.items():
                launches[k] += v
            print(f"cli train audio_clf --corpus, 3 folds x "
                  f"{REDUCED_EPOCHS} epochs: wall {corpus_wall:.2f} s "
                  f"(extraction + folds) [{card}]")

            # -- cli pipeline --track reg, reduced epochs ----------------
            for n in ("AUDIO_REG", "TEXT_REG", "FUSE_REG_TRAINER"):
                setattr(C, n, C.replace(full[n], epochs=REDUCED_EPOCHS + 1))
            cut = C.FoldConfig.sds_threshold
            n_dep, n_non = int((sds >= cut).sum()), int((sds < cut).sum())
            fold_cfg = C.FoldConfig(reg_test_dep=n_dep // 3,
                                    reg_test_non=n_non // 3)
            reg_run = pipeline_run(torch, root, "reg", card, fold_cfg)
            for k, v in reg_run["launches"].items():
                launches[k] += v
        finally:
            for n, v in full.items():
                setattr(C, n, v)

        # -- comparisons, not counted --------------------------------------
        counted = _counts(rnn_cuda)
        train_idx = folds.generate_clf_folds(clf, 3, seed=0)
        data = trainers._clf_fold_datas([feats], clf, train_idx, 8)[0]
        base = C.replace(C.AUDIO_CLF, epochs=COMPARE_EPOCHS + 1)
        # the fold loop never waits for the card: a fold's host syncs (set
        # up and the one readback) do not grow with its epochs
        runs, syncs = {}, {}
        for n in (1, COMPARE_EPOCHS):
            cfg = C.replace(base, epochs=n + 1)
            syncs[n] = _syncs_in(torch, lambda: runs.__setitem__(
                n, _fold_run(torch, cfg, data, "cuda")))
        print(f"host syncs of an audio_clf fold: {syncs[1]} at 1 epoch, "
              f"{syncs[COMPARE_EPOCHS]} at {COMPARE_EPOCHS} epochs "
              "(torch.cuda sync debug mode)")
        if syncs[1] != syncs[COMPARE_EPOCHS]:
            fail("the fold loop synchronises with the card inside its "
                 "epochs")
        cmp = {}
        cmp["audio_clf"] = _compare_runs(
            runs[COMPARE_EPOCHS], _no_kernel(rnn_cuda, lambda: _fold_run(
                torch, _plain(base, C), data, "cuda")),
            f"{COMPARE_EPOCHS}-epoch audio_clf fold, dropout 0.5, kernels vs "
            "plain recurrence on the card")
        no_drop = C.replace(base, model=C.replace(base.model, dropout=0.0))
        cpu_data = trainers._clf_fold_datas([feats.cpu()], clf, train_idx,
                                            8)[0]
        cmp["audio_clf_cpu"] = _compare_runs(
            _fold_run(torch, no_drop, data, "cuda"),
            _fold_run(torch, no_drop, cpu_data, "cpu"),
            f"{COMPARE_EPOCHS}-epoch audio_clf fold, dropout 0, card vs CPU")
        dep, non = folds.generate_reg_shuffles(sds, seed=0)
        reg_data = trainers._reg_fold_datas(
            [feats], sds, dep, non, C.AUDIO_REG.batch_size, fold_cfg)[0]
        reg_base = C.replace(C.AUDIO_REG, epochs=COMPARE_EPOCHS + 1)
        reg_plain_run = _no_kernel(rnn_cuda, lambda: _fold_run(
            torch, _plain(reg_base, C), reg_data, "cuda"))
        cmp["audio_reg"] = _compare_runs(
            _fold_run(torch, reg_base, reg_data, "cuda"), reg_plain_run,
            f"{COMPARE_EPOCHS}-epoch audio_reg fold, dropout 0.5, kernels vs "
            "plain recurrence on the card",
            loss_scale=max(1.0, float(abs(reg_plain_run[0]).max())))
        # the text branch: batch 4, BiLSTM x 2 layers, attention, xavier
        import numpy as np

        xt = torch.as_tensor(np.load(root / "Features" / "TextWhole" /
                                     "whole_samples_clf_avg.npz")["arr_0"],
                             device="cuda")
        text_data = trainers._clf_fold_datas([xt], clf, train_idx, 4)[0]
        text_base = C.replace(C.TEXT_CLF, epochs=COMPARE_EPOCHS + 1)
        cmp["text_clf"] = _compare_runs(
            _fold_run(torch, text_base, text_data, "cuda"),
            _no_kernel(rnn_cuda, lambda: _fold_run(
                torch, _plain(text_base, C), text_data, "cuda")),
            f"{COMPARE_EPOCHS}-epoch text_clf fold, dropout 0.5, kernels vs "
            "plain recurrence on the card")
        text_nd = C.replace(text_base, model=C.replace(text_base.model,
                                                       dropout=0.0))
        cmp["text_clf_cpu"] = _compare_runs(
            _fold_run(torch, text_nd, text_data, "cuda"),
            _fold_run(torch, text_nd, trainers._clf_fold_datas(
                [xt.cpu()], clf, train_idx, 4)[0], "cpu"),
            f"{COMPARE_EPOCHS}-epoch text_clf fold, dropout 0, card vs CPU")
        # the fusion: frozen branches (random, seeded), only fc_final trains
        fuse_data = trainers._clf_fold_datas([feats, xt], clf, train_idx,
                                             2)[0]
        branch = (trainers.init_model(C.TEXT_CLF, 0, 1, "cuda").state_dict(),
                  trainers.init_model(C.AUDIO_CLF, 0, 1,
                                      "cuda").state_dict())
        fuse_t = C.replace(C.FUSE_CLF_TRAINER, epochs=COMPARE_EPOCHS + 1)
        cmp["fuse_clf"] = _compare_runs(
            _fusion_fold_run(torch, C.FUSE_CLF, fuse_t, fuse_data, branch,
                             "cuda"),
            _no_kernel(rnn_cuda, lambda: _fusion_fold_run(
                torch, C.replace(C.FUSE_CLF, rnn_backend="torch"), fuse_t,
                fuse_data, branch, "cuda")),
            f"{COMPARE_EPOCHS}-epoch fuse_clf fold, dropout 0.3, kernels vs "
            "plain recurrence on the card")
        split = {"audio_clf": step_split(torch, C.AUDIO_CLF, data, card,
                                         "audio_clf"),
                 "text_clf": step_split(torch, C.TEXT_CLF, text_data, card,
                                        "text_clf")}
        _set_counts(rnn_cuda, counted)
    return launches, {"clf": clf_run, "reg": reg_run, "extract_s": extract_s,
                      "corpus_wall_s": corpus_wall, "split": split,
                      "cmp": cmp}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import icassp2022_depression_tpu_torch as pkg

    if Path(pkg.__file__).resolve().parent.parent != HERE:
        fail(f"imported the port from {pkg.__file__}, not from {HERE}")
    from icassp2022_depression_tpu_torch import _build
    from icassp2022_depression_tpu_torch.ops import rnn_cuda

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    names = ("gru_fwd", "gru_bwd", "lstm_fwd", "lstm_bwd")
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per source
        libs = list(pool.map(_build.build, names))
    print(f"built {', '.join(so.name for so in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in names:
        print(_build.build_log(name).strip())

    err, kernel_times = kernel_phase(torch, rnn_cuda, card)
    bwd_err, bwd_times = bwd_kernel_phase(torch, rnn_cuda, card)
    lstm_err, lstm_times = lstm_kernel_phase(torch, rnn_cuda, card)
    serve_launches, _ = slice_phase(torch, card)
    launches, train = train_phase(torch, card)
    launches["gru_fwd"] += serve_launches
    if "jax" in sys.modules:
        fail("jax was imported")
    for task, wall in {**train["clf"]["stage_s"],
                       **train["reg"]["stage_s"]}.items():
        print(f"timing pipeline stage {task}: {wall:.2f} s wall [{card}]")
    print(f"timing whole script: {time.perf_counter() - t_start:.1f} s "
          f"[{card}]")

    ms, plain_ms = kernel_times[(3, 8, 256)]
    bwd_ms, bwd_plain_ms = bwd_times[(3, 8, 256)]
    lstm_fwd_ms, lstm_fwd_plain = lstm_times[(3, 4, 128)]["fwd"]
    lstm_bwd_ms, lstm_bwd_plain = lstm_times[(3, 4, 128)]["bwd"]
    src = "icassp2022_depression_tpu_torch/csrc"
    pallas = "icassp2022_depression_tpu/ops/rnn_pallas.py"
    print(json.dumps({"kernels": [
        {"name": "gru_fwd", "route": "cuda", "source": f"{src}/gru_fwd.cu",
         "replaces": f"{pallas}:149",
         "launches": launches["gru_fwd"], "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms},
        {"name": "gru_bwd", "route": "cuda", "source": f"{src}/gru_bwd.cu",
         "replaces": f"{pallas}:38 (+:174)",
         "launches": launches["gru_bwd"], "max_abs_err": bwd_err,
         "ms": bwd_ms, "plain_ms": bwd_plain_ms},
        {"name": "lstm_fwd", "route": "cuda", "source": f"{src}/lstm_fwd.cu",
         "replaces": f"{pallas}:346",
         "launches": launches["lstm_fwd"], "max_abs_err": lstm_err["fwd"],
         "ms": lstm_fwd_ms, "plain_ms": lstm_fwd_plain},
        {"name": "lstm_bwd", "route": "cuda", "source": f"{src}/lstm_bwd.cu",
         "replaces": f"{pallas}:868 (+:377)",
         "launches": launches["lstm_bwd"], "max_abs_err": lstm_err["bwd"],
         "ms": lstm_bwd_ms, "plain_ms": lstm_bwd_plain}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
