#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``icassp2022_depression_tpu_torch``)
on one NVIDIA GPU: serving of the audio, text and fusion models, the text
frontend (the ELMo char-CNN and LSTMP biLM at the zhs geometry), the
training paths of both tracks, and checking and migration (``cli
extract-audio``, ``check``, ``export-pt``, reference ``.pt`` checkpoints),
at full width.

    python3 chip_smoke.py               # everything, ends with the ok line
    python3 chip_smoke.py --only lstmp  # the LSTMP kernels alone, no ok line
    python3 chip_smoke.py --only lstm   # the LSTM kernels alone, no ok line
    python3 chip_smoke.py --only gru    # the GRU kernels alone, no ok line

``--only lstmp`` builds the two LSTMP sources, runs phase 2's LSTMP checks
and timings (the backward in turns with its plain loop and cuDNN), the
LSTMP profiles (one forward and one backward call at (16, 8) and (128,
24)) and the LSTMP yardsticks, prints their lines and stops: the quick
loop for work on those kernels.  ``--only lstm`` does the same for the
two LSTM sources: phase 2's LSTM checks and timings at the text model's
H = 128 and at the stand-in encoder's H = 512
(both routes of the forward and of the backward), the profiles of the
forward and of the backward at (256, 16, 128), and the cuDNN yardsticks.
``--only gru`` does the same for the two GRU sources: both forward routes'
and both backward routes' checks and timings, the forward's profiles at
(3, 8, 256), (3, 100, 256) and (3, 200, 256) (each route alone, and one
round of the timing turns), the
backward's at (3, 8, 256) and (256, 16, 256), and the cuDNN yardsticks.

Phases (each raises on failure, so the exit code is nonzero):

1. setup: require CUDA, print the card's name and power limit, turn TF32
   off, build the six kernels from ``icassp2022_depression_tpu_torch/csrc``
   (GRU, LSTM and LSTMP, forward and backward) with ``nvcc``, one compiler
   process per source, started together, and print the build time and the
   compiler's reports;
2. kernels: each CUDA kernel against its plain PyTorch version at the
   shapes of the paths below, a ragged shape and one the JAX package would
   stream ((256, 16, H)): outputs and dxp within 1e-5, dw and db within
   1e-5 of their largest magnitude, reruns bitwise equal, the LSTM
   backward with a nonzero cell-state cotangent; the LSTMP kernels at
   (T, B, C, P) = (32, 128, 4096, 512), (16, 8, 4096, 512),
   (48, 104, 4096, 512) and (7, 3, 384, 128) with both +-3 clips engaged
   and at (128, 24, 4096, 512) with the weights at ``init_lstmp``'s bounds
   (eight served speakers' long transcripts), the backward (the gate
   recompute, then one step launch and one fixed-order reduction a step)
   fed the plain forward's residuals, every output within 1e-5 of its
   largest magnitude, and the backward, its plain loop and cuDNN timed in
   turns at the timed shapes;
   beside each, a reading of how far the plain float32 loop and
   the kernel are from the plain loop in float64, and the same reading at
   a recurrent gain of 3/sqrt(P), where float32 itself parts from float64
   (not checked); the GRU forward and the LSTM forward through both of
   their routes (one launch, or one launch a step) at every GRU shape (an
   H = 254 that only the one-launch route takes among them; the routes,
   plain loop and cuDNN ``nn.GRU`` in turns at the timed shapes), at every
   LSTM shape and at the stand-in
   text encoder's H = 512 ((T, B) = (16, 8), (128, 24), (16, 112),
   (128, 488)), and the GRU and LSTM backwards through both of theirs
   (two launches, or one a step between a gate recompute and a weight
   product) at every GRU and LSTM shape, within 1e-5, reruns bitwise
   equal, the backward's routes, plain loop and cuDNN timed in turns at
   each timed shape with its bound; timed with CUDA
   events, beside the nearest PyTorch call (cuDNN ``nn.GRU`` /
   ``nn.LSTM`` / ``nn.LSTM(proj_size=512)``, both directions, and
   ``nn.LSTM(512, 512)`` at every stand-in shape); the forward wrappers
   must refuse a CUDA input that requires grad; one GRU forward call at
   (3, 8, 256), (3, 100, 256) and (3, 200, 256) through each route (and
   tile in question) and one round of its timing turns, one
   LSTMP forward and one backward call at (16, 8) and at
   (128, 24), one LSTM forward call at the stand-in's
   (16, 8) and (128, 488), one GRU backward call at (3, 8, 256) and
   (256, 16, 256) and one LSTM backward call at (256, 16, 128), under
   ``torch.profiler``, device time split by
   kernel name and the gaps between launches; the LSTMP forward and the
   stand-in's LSTM forward beside the plain loop, cuDNN and the bound at
   each timed shape;
3. audio serving: a synthetic EATD corpus, a full-width ``audio_clf`` with
   seeded random weights saved as a JAX-layout npz, ``cli predict`` for
   one speaker and ``Predictor.predict_batch`` for 1, 3 and 8 speakers,
   the GRU forward kernel launched twice per forward; outputs equal (1e-5)
   to the plain recurrence's and, for ``cli predict``, to the CPU's;
4. a seeded converted-ELMo bundle at the zhs geometry (6784 chars, char-CNN
   to 512, biLM C = 4096, P = 512, 2 layers), drawn on the card with the
   port's threefry and written with the port's ``save_npz``;
5. text and training: a synthetic corpus of 24 + 12 speakers; counted,
   each with every kernel counter zeroed just before and read just after:
   ``cli extract-text`` with the bundle (``--segmenter fallback``; exactly
   4 LSTMP forward launches per sentence batch), whose npz features feed
   ``cli pipeline --track clf`` at the full recipes (audio_clf 170,
   text_clf 150, fuse_clf 100 epochs, 3 folds each), ``cli train --task
   audio_clf --corpus`` and ``cli pipeline --track reg --corpus`` (both
   modalities extracted on the card; folds cut to the corpus) at 20
   epochs with the gates open, so that every fold saves and every text
   and fusion sidecar is checked to name the bundle.  Per stage the
   launches must be exact (audio: 2 GRU forwards
   per step and eval, 2 GRU backwards per step; text: 4 LSTM forwards per
   step and eval, 4 LSTM backwards per step; fusion: 4 LSTM and 2 GRU
   forwards per step and per fold, and no backward kernel at all), the
   metrics finite and every gated fold's artifacts written, naming the
   bundle.  Not counted: the extracted features of 3 speakers against the
   same bundle on the CPU (1e-5 of the largest magnitude); 5-epoch
   ``audio_clf``, ``audio_reg``, ``text_clf`` and ``fuse_clf`` folds
   through the kernels against the plain recurrence on the card with the
   same dropout masks, and ``audio_clf`` and ``text_clf`` folds with
   dropout 0 on the card against the CPU (per-step losses within 1e-5,
   relative to the largest loss for the L1 loss on SDS scores; final
   params within 1e-5 of the largest |param|);
6. checking and migration on phase 5's corpus and checkpoints: counted,
   ``cli extract-audio`` (no kernel; its clf features bitwise
   ``extract_eatd_device``'s, 3 speakers the CPU's within 1e-5, and an
   incremental rerun marks every speaker cached and writes the same npz
   files), ``cli check --corpus`` on the gated checkpoints of ``cli train
   --task audio_clf --corpus`` and of the reg pipeline (``audio_reg``,
   ``text_reg``, ``fuse_reg``), each fold's metrics its trainer's recorded
   ones (F1, precision and recall within 1e-6, MAE within 1e-5 of the
   largest target) with exact launches (2 ``gru_fwd`` a fold for audio, 4
   ``lstm_fwd`` for text, both for the fusion, 4 ``lstmp_fwd`` a batch of
   128 answers, no backward); not counted, the same checks on the CPU
   (the same metrics, predictions within 1e-5 of max(1, their largest
   magnitude)); counted, ``cli export-pt`` of fold 1's ``audio_clf`` and
   ``fuse_reg`` checkpoints, whole-module pickles of reference-layout
   modules defined in this script in torch's zipfile and legacy formats,
   and ``cli check`` and ``cli predict`` on each, equal to the npz's
   (1e-5); at EATD's size (a synthetic corpus of 83 + 79 speakers), the
   wall time of ``cli extract-audio`` and of ``cli check --task fuse_clf
   --corpus`` with the seeded bundle and seeded full-width checkpoints,
   and, not counted, the device time of each fold's forward at its test
   split's rows (``torch.profiler``);
7. text serving: full-width seeded ``fuse_clf`` and ``text_clf``
   checkpoints whose sidecars name the bundle (``ICASSP_ELMO_WEIGHTS``
   points at it): counted ``cli predict`` for one speaker (equal to the
   CPU's within 1e-5) and ``Predictor.predict_batch`` (``fuse_clf``) at 1
   and 8 speakers with transcripts of 20-120 CJK characters from a seeded
   vocabulary, exact launches per request, no LSTMP backward on any main
   path; not counted: the 8 speakers' results and text features against
   the same predictor on the CPU (1e-5); then ``text_clf`` and
   ``fuse_clf`` through the seeded stand-in encoder (``elmo_weights=None``,
   the path without a bundle) at 1 and 8 speakers, counted: 8
   ``lstm_fwd`` per request (the stand-in's 4 and the text model's 4);
   not counted: the 8 speakers' ``text_clf`` results and text features
   against the CPU (1e-5);
8. timing: warm ``predict_batch`` latency (audio at 1 and 8 speakers,
   fusion at 1 and 8, and the stand-in's ``text_clf`` and ``fuse_clf`` at
   1 and 8); the wall time of extraction and of each pipeline
   stage; an ``audio_clf`` and a ``text_clf`` train step split into
   forward, backward and optimizer; each kernel's bound (the larger of its
   float32 operations over 67 TFLOP/s and its bytes over 3.35 TB/s).

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

import torch

HERE = Path(__file__).resolve().parent
KERNEL_TOL = 1e-5
SLICE_TOL = 1e-5
#: the GRU forward at the audio model's H = 256: serving (1, 3 and 8
#: speakers' rows; 22 and more speakers give 66 and more rows), training
#: (batches 8 and 2), an eval split, one the JAX package would stream, a
#: ragged shape, and an H only the "sequence" route takes
KERNEL_SHAPES = ((3, 1, 256), (3, 4, 256), (3, 8, 256), (3, 24, 256),
                 (3, 100, 256), (3, 200, 256), (3, 2, 256), (256, 16, 256),
                 (7, 3, 200), (3, 4, 254))
TIMED_SHAPES = ((3, 8, 256), (3, 24, 256), (3, 100, 256), (3, 200, 256))
#: the GRU forward calls profiled (the audio_clf training shape, and two
#: batches above 64 rows, where two step tiles are in question)
GRU_FWD_PROFILED = ((3, 8, 256), (3, 100, 256), (3, 200, 256))
BATCHES = (1, 3, 8)
#: the training shapes (audio_clf batch 8, audio_reg batch 2, eval of a
#: 24-row test split), a ragged one, and one the JAX package would stream
#: (its backward working set, ~35 MB, exceeds `_pallas_fits`' 12 MB)
BWD_SHAPES = ((3, 8, 256), (3, 2, 256), (3, 24, 256), (7, 3, 200),
              (256, 16, 256))
BWD_TIMED = ((3, 8, 256), (3, 2, 256), (256, 16, 256))
#: the LSTM at the text model's H = 128: the training batches (text_clf 4,
#: text_reg and fuse_clf 2), an eval split, a ragged shape, and one the JAX
#: package would stream
LSTM_SHAPES = ((3, 4, 128), (3, 2, 128), (3, 24, 128), (7, 3, 100),
               (256, 16, 128))
LSTM_TIMED = ((3, 4, 128), (3, 2, 128), (256, 16, 128))
#: the LSTMP cell (T, B, C, P, weights) at the zhs geometry.  "clips":
#: weights scaled so that both +-3 clips engage, at the extraction batch,
#: one served speaker, a ragged large batch, and a small ragged shape;
#: "init": the bounds ``init_lstmp`` draws from (the seeded bundle's), at
#: the rows and steps of eight served speakers' long transcripts (24
#: sentences of up to 122 tokens)
LSTMP_SHAPES = ((32, 128, 4096, 512, "clips"), (16, 8, 4096, 512, "clips"),
                (48, 104, 4096, 512, "clips"), (7, 3, 384, 128, "clips"),
                (128, 24, 4096, 512, "init"))
LSTMP_TIMED = ((32, 128, 4096, 512), (16, 8, 4096, 512),
               (128, 24, 4096, 512))
#: the served shapes whose LSTMP forward is profiled: one call's device
#: time split by kernel name, and the gaps between its launches
LSTMP_PROFILED = ((16, 8, 4096, 512), (128, 24, 4096, 512))
#: a reading, not a check: the "clips" weights with a recurrent gain of
#: 3/sqrt(P), where the float32 recurrence itself parts from float64
LSTMP_GAIN3 = (32, 128, 4096, 512, "gain3")
#: the stand-in text encoder's LSTM (H = 512), the text path of every run
#: without an ELMo bundle: one served speaker, eight served speakers' long
#: transcripts, the extraction batch of this script's corpus, and EATD's
#: 486 answers in one 512-sentence chunk
STANDIN_LSTM_SHAPES = ((16, 8, 512), (128, 24, 512), (16, 112, 512),
                       (128, 488, 512))
#: the stand-in shapes whose LSTM forward is profiled
STANDIN_PROFILED = ((16, 8, 512), (128, 488, 512))
#: the backward calls profiled: the GRU at the audio_clf training shape and
#: at one the JAX package would stream, the LSTM at the streamed shape
GRU_BWD_PROFILED = ((3, 8, 256), (256, 16, 256))
LSTM_BWD_PROFILED = ((256, 16, 128),)
#: the data sheet's peaks of one H100 SXM at 700 W (fp32 without tensor
#: cores, HBM3), for each kernel's bound
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
TRAIN_TOL = 1e-5
COMPARE_EPOCHS = 5
#: epochs of the runs cut to keep the script short (cli train --corpus and
#: the reg pipeline); the clf pipeline runs the full recipes
REDUCED_EPOCHS = 20


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


def cudnn_gru_fwd(torch, t: int, b: int, h: int):
    """A call of cuDNN's ``nn.GRU(h, h)`` forward at (T, B, H), input
    projection included (a yardstick used nowhere in the port)."""
    mod = torch.nn.GRU(h, h).cuda()
    x = torch.randn((t, b, h), device="cuda")

    def fn():
        with torch.no_grad():
            mod(x)
    return fn


def kernel_phase(torch, rnn_cuda, card: str):
    """The GRU forward kernel through each route of its plan against its
    plain version at every ``KERNEL_SHAPES`` entry (within KERNEL_TOL, a
    rerun bitwise equal); then, at each ``TIMED_SHAPES`` entry, the calls
    of :func:`_gru_turn_fns` timed in turns.  Returns
    the worst error and the (kernel through the plan's route, plain) ms at
    the timed shapes."""
    worst = 0.0
    gen = torch.Generator().manual_seed(0)
    inputs = {}
    for t, b, h in KERNEL_SHAPES:
        bound = h ** -0.5
        xp = torch.randn((t, b, 3 * h), generator=gen).cuda()
        w = ((torch.rand((h, 3 * h), generator=gen) * 2 - 1) * bound).cuda()
        bias = ((torch.rand((1, 3 * h), generator=gen) * 2 - 1)
                * bound).cuda()
        ref = rnn_cuda.gru_sequence_torch(xp, w, bias)
        errs = {}
        for route, fn in _route_fns(rnn_cuda, (xp, w, bias), (t, b, h),
                                    "gru").items():
            ys, again = fn(), fn()
            torch.cuda.synchronize()
            if ys.shape != (t, b, h) or not torch.isfinite(ys).all():
                fail(f"gru_fwd ({route}) output at {(t, b, h)} is malformed")
            err = (ys - ref).abs().max().item()
            same = torch.equal(ys, again)
            if not (err <= KERNEL_TOL and same):
                fail(f"GRU kernel ({route} route) disagrees with its plain "
                     f"version at {(t, b, h)}: {err}, rerun bitwise equal "
                     f"{same}")
            errs[route] = (err, same)
        print(f"kernel gru_fwd T={t} B={b} H={h}: max|cuda - plain| "
              + ", ".join(f"{r} {e:.3e} (rerun bitwise equal {sm})"
                          for r, (e, sm) in errs.items())
              + f" (tol {KERNEL_TOL}; the plan "
              f"{rnn_cuda.gru_fwd_plan(b, h)})")
        worst = max([worst] + [e for e, _ in errs.values()])
        inputs[(t, b, h)] = (xp, w, bias)
    timings = {}
    for shape in TIMED_SHAPES:
        fns = _gru_turn_fns(torch, rnn_cuda, inputs[shape], shape)
        ms = turns_ms(torch, fns, 50)
        route = rnn_cuda.gru_fwd_plan(*shape[1:])["route"]
        b_ms, by = rnn_bounds("gru", *shape)["fwd"]
        timings[shape] = (ms[route], ms["plain"])
        print(f"timing gru_fwd T={shape[0]} B={shape[1]} H={shape[2]}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + f"; the plan takes {route}; bound {b_ms:.6f} ms ({by}), "
              f"{b_ms / ms[route]:.4f} of it; cuDNN "
              f"{ms['cudnn'] / ms[route]:.2f}x the kernel's time (median of "
              f"50 in turns, CUDA events) [{card}]")
    return worst, timings


def _gru_turn_fns(torch, rnn_cuda, args, shape) -> dict:
    """{name: call} of the GRU forward's timing turns at ``shape``: each
    route, above 64 rows also the step route through the other step tile
    in question there ((4, 32), or the LSTM forward's 32-cell tile), the
    plain loop and cuDNN's ``nn.GRU``."""
    t, b, h = shape
    fns = _route_fns(rnn_cuda, args, shape, "gru")
    if b > 64 and h % 4 == 0:
        plan = rnn_cuda.gru_fwd_plan(b, h)
        for cells, rows in ((4, 32), (32, 16 if b <= 128 else 64)):
            if (cells, rows) != (plan["cells"], plan["rows"]):
                tile = dict(plan, cells=cells, rows=rows,
                            slabs=-(-h // cells), row_tiles=-(-b // rows))
                fns[f"step {cells}x{rows}"] = (
                    lambda tile=tile: rnn_cuda.gru_sequence(*args, plan=tile))
    fns["plain"] = lambda: rnn_cuda.gru_sequence_torch(*args)
    fns["cudnn"] = cudnn_gru_fwd(torch, *shape)
    return fns


def gru_profile_phase(torch, rnn_cuda, card: str) -> dict:
    """At each ``GRU_FWD_PROFILED`` shape, one ``gru_sequence`` call through
    each route (above 64 rows also through the other step tile), and one
    round of :func:`kernel_phase`'s timing turns, split by
    :func:`profile_split`: each route's and tile's device time, and
    whether a route's time in the turns is the device's or the host's."""
    gen = torch.Generator().manual_seed(13)
    out = {}
    for t, b, h in GRU_FWD_PROFILED:
        xp = torch.randn((t, b, 3 * h), generator=gen).cuda()
        w = ((torch.rand((h, 3 * h), generator=gen) * 2 - 1)
             * h ** -0.5).cuda()
        bias = torch.zeros((1, 3 * h)).cuda()
        fns = _gru_turn_fns(torch, rnn_cuda, (xp, w, bias), (t, b, h))
        for name in [k for k in fns if k not in ("plain", "cudnn")]:
            out[(name, t, b, h)] = profile_split(
                torch, fns[name], f"gru_fwd ({name}) T={t} B={b} H={h}", t,
                card)
        out[("turns", t, b, h)] = profile_split(
            torch, lambda: [fn() for fn in fns.values()],
            f"gru_fwd turns ({', '.join(fns)}) T={t} B={b} H={h}", t, card)
    return out


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
    """The GRU backward kernel through both routes against its plain
    version at every ``BWD_SHAPES`` entry; then, at each ``BWD_TIMED``
    shape, both routes, the plain loop and cuDNN timed in turns.  Returns
    the worst |d dxp| and the (kernel through the plan's route, plain) ms
    at the timed shapes."""
    worst = 0.0
    gen = torch.Generator().manual_seed(1)
    inputs = {}
    for t, b, h in BWD_SHAPES:
        args = _bwd_inputs(torch, rnn_cuda, gen, "gru", t, b, h)
        ref = rnn_cuda.gru_sequence_bwd_torch(*args)
        routes = bwd_routes(torch, rnn_cuda, "gru", args, ref, (t, b, h))
        print(f"kernel gru_bwd T={t} B={b} H={h}: " + ", ".join(
            f"{r} max|d dxp| {e:.3e}, dw/db rel {rel:.3e}, rerun bitwise "
            f"equal {same}" for r, (e, rel, same) in routes.items())
              + f" (tol {KERNEL_TOL}; dw, db of max|ref|)")
        worst = max([worst] + [e for e, _, _ in routes.values()])
        inputs[(t, b, h)] = args
    xp, w, bias = inputs[BWD_SHAPES[-1]][:3]
    try:
        rnn_cuda.gru_sequence(xp.clone().requires_grad_(), w, bias)
    except ValueError:
        pass
    else:
        fail("gru_sequence returned a detached result for an input that "
             "requires grad")
    timings = {shape: bwd_turns(torch, rnn_cuda, "gru", inputs[shape], shape,
                                card) for shape in BWD_TIMED}
    return worst, timings


def bwd_routes(torch, rnn_cuda, cell: str, args, ref, shape) -> dict:
    """The GRU or LSTM backward through each route of its plan (the step
    route only where H is a multiple of 4) against the plain ``ref``:
    {route: (max|d dxp|, max of dw, db's error relative to their largest
    magnitude, rerun bitwise equal)}, failing past KERNEL_TOL or on a rerun
    that differs."""
    t, b, h = shape
    g = (3 if cell == "gru" else 4) * h
    plan_fn, bwd, _ = _bwd_fns(rnn_cuda, cell)
    out = {}
    for route in ("sequence", "step")[:2 if h % 4 == 0 else 1]:
        plan = plan_fn(b, h, route, steps=t)
        got = bwd(*args, plan=plan)
        again = bwd(*args, plan=plan)
        torch.cuda.synchronize()
        for x, want in zip(got, ((t, b, g), (h, g), (1, g))):
            if tuple(x.shape) != want or not torch.isfinite(x).all():
                fail(f"{cell}_bwd ({route}) output at {shape} is malformed")
        err = (got[0] - ref[0]).abs().max().item()
        rel = max(((x - r).abs().max() / r.abs().max()).item()
                  for x, r in zip(got[1:], ref[1:]))
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        if not (err <= KERNEL_TOL and rel <= KERNEL_TOL and same):
            fail(f"{cell} backward kernel ({route} route) disagrees with its "
                 f"plain version at {shape}: dxp {err}, dw/db {rel}, rerun "
                 f"bitwise equal {same}")
        out[route] = (err, rel, same)
    return out


def _bwd_fns(rnn_cuda, cell: str) -> tuple:
    """(plan, kernel wrapper, plain backward) of the GRU or LSTM."""
    if cell == "gru":
        return (rnn_cuda.gru_bwd_plan, rnn_cuda.gru_sequence_bwd,
                rnn_cuda.gru_sequence_bwd_torch)
    return (rnn_cuda.lstm_bwd_plan, rnn_cuda.lstm_sequence_bwd,
            rnn_cuda.lstm_sequence_bwd_torch)


def cudnn_bwd(torch, cell: str, t: int, b: int, h: int):
    """A call of cuDNN's backward at (T, B, H): ``torch.autograd.grad``
    through ``nn.GRU(h, h)`` / ``nn.LSTM(h, h)`` with respect to the input
    and the weights (a yardstick used nowhere in the port)."""
    mod = (torch.nn.GRU(h, h) if cell == "gru" else torch.nn.LSTM(h, h))
    mod = mod.cuda()
    x = torch.randn((t, b, h), device="cuda", requires_grad=True)
    y, _ = mod(x)
    dy = torch.randn_like(y)
    wrt = [x, *mod.parameters()]
    return lambda: torch.autograd.grad(y, wrt, dy, retain_graph=True)


def bwd_turns(torch, rnn_cuda, cell: str, args, shape, card: str) -> tuple:
    """Both routes of the backward, the plain loop and cuDNN at ``shape``,
    timed in turns; prints them with the bound and returns (the plan's
    route ms, plain ms)."""
    t, b, h = shape
    plan_fn, bwd, plain = _bwd_fns(rnn_cuda, cell)
    fns = {route: (lambda plan=plan_fn(b, h, route, steps=t):
                   bwd(*args, plan=plan))
           for route in ("sequence", "step")[:2 if h % 4 == 0 else 1]}
    fns["plain"] = lambda: plain(*args)
    fns["cudnn"] = cudnn_bwd(torch, cell, t, b, h)
    reps = 50 if t * b <= 512 else 20
    ms = turns_ms(torch, fns, reps)
    route = plan_fn(b, h, steps=t)["route"]
    b_ms, by = rnn_bounds(cell, t, b, h)["bwd"]
    print(f"timing {cell}_bwd T={t} B={b} H={h}: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in ms.items())
          + f"; the plan takes {route}; bound {b_ms:.6f} ms ({by}), "
          f"{b_ms / ms[route]:.4f} of it; cuDNN {ms['cudnn'] / ms[route]:.2f}x "
          f"the kernel's time (median of {reps} in turns, CUDA events) "
          f"[{card}]")
    return ms[route], ms["plain"]


def lstm_routes(torch, rnn_cuda, args, ref, shape) -> dict:
    """The LSTM forward through each route of ``lstm_fwd_plan`` (the step
    route only where H is a multiple of 4) against the plain ``ref``:
    {route: (max|d (ys, cs)|, rerun bitwise equal)}, failing past
    KERNEL_TOL or on a rerun that differs."""
    t, b, h = shape
    out = {}
    for route in ("sequence", "step")[:2 if h % 4 == 0 else 1]:
        plan = rnn_cuda.lstm_fwd_plan(b, h, route)
        got = rnn_cuda.lstm_sequence(*args, plan=plan)
        again = rnn_cuda.lstm_sequence(*args, plan=plan)
        torch.cuda.synchronize()
        for g in got:
            if tuple(g.shape) != shape or not torch.isfinite(g).all():
                fail(f"LSTM kernel ({route}) output at {shape} is malformed")
        err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        if not (err <= KERNEL_TOL and same):
            fail(f"LSTM kernel ({route} route) disagrees with its plain "
                 f"version at {shape}: {err}, rerun bitwise equal {same}")
        out[route] = (err, same)
    return out


def turns_ms(torch, fns: dict, reps: int) -> dict:
    """Median ms of each ``fns`` entry over ``reps`` single calls, the
    entries' calls taken in turns (one warm call each first), so that a
    slow spell of the host falls on all of them alike."""
    times = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    for _ in range(reps):
        for name, fn in fns.items():
            times[name].append(event_ms(fn, 1, torch))
    return {name: statistics.median(v) for name, v in times.items()}


def _route_fns(rnn_cuda, args, shape, cell: str = "lstm") -> dict:
    """{route: call} of the LSTM (or GRU) forward through each route at
    ``shape`` (the step route only where H is a multiple of 4)."""
    t, b, h = shape
    plan_fn, fwd = ((rnn_cuda.gru_fwd_plan, rnn_cuda.gru_sequence)
                    if cell == "gru"
                    else (rnn_cuda.lstm_fwd_plan, rnn_cuda.lstm_sequence))
    return {route: (lambda plan=plan_fn(b, h, route): fwd(*args, plan=plan))
            for route in ("sequence", "step")[:2 if h % 4 == 0 else 1]}


def lstm_kernel_phase(torch, rnn_cuda, card: str):
    """Both LSTM kernels against their plain versions, each through both of
    its routes, the backward with a nonzero cell-state cotangent (the
    forward's routes timed in turns at every shape, the backward's routes,
    the plain loop and cuDNN at the timed shapes); returns the worst errors
    and the (kernel through the plan's route, plain) ms of each at the
    timed shapes."""
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
        torch.cuda.synchronize()
        for g in (ys, cs):
            if tuple(g.shape) != (t, b, h) or not torch.isfinite(g).all():
                fail(f"LSTM kernel output at {(t, b, h)} is malformed")
        fwd = max((ys - ref_ys).abs().max().item(),
                  (cs - ref_cs).abs().max().item())
        routes = lstm_routes(torch, rnn_cuda, args[:3], (ref_ys, ref_cs),
                             (t, b, h))
        fwd = max([fwd] + [e for e, _ in routes.values()])
        by_route_bwd = bwd_routes(torch, rnn_cuda, "lstm", args,
                                 rnn_cuda.lstm_sequence_bwd_torch(*args),
                                 (t, b, h))
        bwd = max(e for e, _, _ in by_route_bwd.values())
        print(f"kernel lstm_fwd/lstm_bwd T={t} B={b} H={h}: max|d ys|, "
              f"|d cs| = {fwd:.3e} (routes "
              + ", ".join(f"{r} {e:.3e}, rerun bitwise equal {sm}"
                          for r, (e, sm) in routes.items())
              + "); backward routes " + ", ".join(
                  f"{r} max|d dxp| {e:.3e}, dw/db rel {rel:.3e}, rerun "
                  f"bitwise equal {same}"
                  for r, (e, rel, same) in by_route_bwd.items())
              + f" (tol {KERNEL_TOL}; dw, db of max|ref|), dcs nonzero")
        if not fwd <= KERNEL_TOL:
            fail(f"LSTM forward kernel disagrees with its plain version at "
                 f"{(t, b, h)}: {fwd}")
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
        fwd = (event_ms(lambda: rnn_cuda.lstm_sequence(*args[:3]), 50, torch),
               event_ms(lambda: rnn_cuda.lstm_sequence_torch(*args[:3]), 50,
                        torch))
        print(f"timing lstm_fwd T={shape[0]} B={shape[1]} H={shape[2]}: "
              f"cuda kernel {fwd[0]:.4f} ms, plain torch {fwd[1]:.4f} ms "
              f"(median of 50, CUDA events) [{card}]")
        timings[shape] = {"fwd": fwd, "bwd": bwd_turns(
            torch, rnn_cuda, "lstm", args, shape, card)}
    for shape in LSTM_SHAPES:
        by_route = turns_ms(
            torch, _route_fns(rnn_cuda, inputs[shape][:3], shape), 50)
        print(f"timing lstm_fwd routes T={shape[0]} B={shape[1]} "
              f"H={shape[2]}: " + ", ".join(
                  f"{r} {ms:.4f} ms" for r, ms in by_route.items())
              + f" (the plan takes "
              f"{rnn_cuda.lstm_fwd_plan(shape[1], shape[2])['route']}; "
              f"median of 50 in turns, CUDA events) [{card}]")
    return worst, timings


def _lstmp_inputs(torch, gen, t, b, c, p, weights):
    """(xp4, w_h_t3, b3, w_p_t) for one LSTMP check.  "clips" and "gain3":
    xp4 normal with std 2, the input and forget gates opened by a bias of
    +2 so the cell grows, and a large W_p (6/sqrt(C)): both clips engage;
    the recurrent gain is 0.5/sqrt(P) ("clips") or 3/sqrt(P) ("gain3").
    "init": W_h, W_p uniform within 1/sqrt(P), 1/sqrt(C) and b = 0, as
    ``init_lstmp`` draws them, and xp4 standard normal."""
    gain = {"clips": 0.5, "gain3": 3.0, "init": 1.0}[weights]
    xp4 = torch.randn((t, b, 4, c), generator=gen)
    w_h = (torch.rand((p, 4, c), generator=gen) * 2 - 1) * gain / p ** 0.5
    if weights == "init":
        b3 = torch.zeros((1, 4, c))
        w_p = (torch.rand((c, p), generator=gen) * 2 - 1) / c ** 0.5
    else:
        xp4 = xp4 * 2
        b3 = torch.rand((1, 4, c), generator=gen) - 0.5
        b3[:, :2] += 2.0
        w_p = (torch.rand((c, p), generator=gen) * 2 - 1) * 6 / c ** 0.5
    return tuple(a.cuda() for a in (xp4, w_h, b3, w_p))


def cudnn_lstmp_bwd(torch, t: int, b: int, c: int, p: int):
    """A call of cuDNN's ``nn.LSTM(p, c, proj_size=p)`` backward at (T, B):
    ``torch.autograd.grad`` to the input and all weights (no clips; a
    yardstick used nowhere in the port)."""
    mod = torch.nn.LSTM(p, c, proj_size=p).cuda()
    x = torch.randn((t, b, p), device="cuda", requires_grad=True)
    y, _ = mod(x)
    dy = torch.randn_like(y)
    wrt = [x, *mod.parameters()]
    return lambda: torch.autograd.grad(y, wrt, dy, retain_graph=True)


def _rel(got, ref) -> float:
    """max over the outputs of max|got - ref| / max|ref|."""
    return max(((g - r).abs().max() / r.abs().max()).item()
               for g, r in zip(got, ref))


def _f64_reading(torch, rnn_cuda, fwd_in, got, ref) -> tuple:
    """(plain float32, kernel) distances from the plain recurrence run in
    float64 on the same inputs, relative to its largest magnitudes."""
    exact = rnn_cuda.lstmp_sequence_torch(*(a.double() for a in fwd_in))
    exact = tuple(e.float() for e in exact)
    return _rel(ref, exact), _rel(got, exact)


def lstmp_kernel_phase(torch, rnn_cuda, card: str):
    """Both LSTMP kernels against their plain versions at the zhs geometry
    (``LSTMP_SHAPES``); the backward against the plain backward fed the
    same forward residuals (a value within rounding of a clip may fall on
    either side in the two forwards).  Outputs within KERNEL_TOL of their
    largest magnitude, reruns bitwise equal; at the "clips" shapes both
    clips must engage.  Beside each check, a reading: how far the plain
    float32 loop and the kernel are from the plain loop in float64, and
    the same at ``LSTMP_GAIN3``.  Returns the worst absolute errors, the
    (kernel, plain) ms at the timed shapes and the float64 readings."""
    worst = {"fwd": 0.0, "bwd": 0.0}
    worst_abs = {"fwd": 0.0, "bwd": 0.0}
    gen = torch.Generator().manual_seed(4)
    timings, readings = {}, {}
    for t, b, c, p, weights in LSTMP_SHAPES:
        shape = (t, b, c, p)
        fwd_in = _lstmp_inputs(torch, gen, t, b, c, p, weights)
        xp4, w_h, b3, w_p = fwd_in
        dys = torch.randn((t, b, p), generator=gen).cuda()
        dcpre = torch.randn((t, b, c), generator=gen).cuda()
        got = rnn_cuda.lstmp_sequence(*fwd_in)
        again = rnn_cuda.lstmp_sequence(*fwd_in)
        ref = rnn_cuda.lstmp_sequence_torch(*fwd_in)
        bwd_in = fwd_in + ref[:3] + (dys, dcpre)
        bref = rnn_cuda.lstmp_sequence_bwd_torch(*bwd_in)
        bgot = rnn_cuda.lstmp_sequence_bwd(*bwd_in)
        bagain = rnn_cuda.lstmp_sequence_bwd(*bwd_in)
        torch.cuda.synchronize()
        for g, want in zip(got + bgot, ((t, b, p), (t, b, p), (t, b, c),
                                        (t, b, c), (t, b, 4, c), (t, b, p))):
            if tuple(g.shape) != want or not torch.isfinite(g).all():
                fail(f"LSTMP kernel output at {shape} is malformed")
        clipped = (ref[2].abs().max().item() > 3.0,
                   ref[1].abs().max().item() > 3.0)
        if weights == "clips" and not all(clipped):
            fail(f"LSTMP clips not engaged at {shape}: {clipped}")
        fwd, bwd = _rel(got, ref), _rel(bgot, bref)
        same = all(torch.equal(a, c_) for a, c_ in
                   zip(got + bgot, again + bagain))
        readings[shape] = _f64_reading(torch, rnn_cuda, fwd_in, got, ref)
        print(f"kernel lstmp_fwd/lstmp_bwd T={t} B={b} C={c} P={p} "
              f"({weights} weights): max|d (ys, hpre, cpre, hf)| = "
              f"{fwd:.3e}, max|d (dgates, dhpre)| = {bwd:.3e} (tol "
              f"{KERNEL_TOL} of max|ref|), cell / projection clip engaged "
              f"{clipped}, dcpre nonzero, rerun bitwise equal: {same}; "
              f"reading: plain float32 / kernel vs plain float64 "
              f"{readings[shape][0]:.3e} / {readings[shape][1]:.3e}")
        if not (fwd <= KERNEL_TOL and bwd <= KERNEL_TOL and same):
            fail(f"LSTMP kernels disagree with their plain versions at "
                 f"{shape}: fwd {fwd}, bwd {bwd}, rerun {same}")
        worst["fwd"] = max(worst["fwd"], fwd)
        worst["bwd"] = max(worst["bwd"], bwd)
        for k, gs, rs in (("fwd", got, ref), ("bwd", bgot, bref)):
            worst_abs[k] = max([worst_abs[k]] + [(g - r).abs().max().item()
                                                 for g, r in zip(gs, rs)])
        if shape in LSTMP_TIMED:
            rnn_cuda.lstmp_sequence(*fwd_in)
            rnn_cuda.lstmp_sequence_torch(*fwd_in)
            timings[shape] = {"fwd": (
                event_ms(lambda: rnn_cuda.lstmp_sequence(*fwd_in), 5, torch),
                event_ms(lambda: rnn_cuda.lstmp_sequence_torch(*fwd_in), 5,
                         torch))}
            ms, pms = timings[shape]["fwd"]
            print(f"timing lstmp_fwd T={t} B={b} C={c} P={p}: cuda kernel "
                  f"{ms:.4f} ms, plain torch {pms:.4f} ms (median of 5, "
                  f"CUDA events) [{card}]")
            turns = turns_ms(torch, {
                "kernel": lambda: rnn_cuda.lstmp_sequence_bwd(*bwd_in),
                "plain": lambda: rnn_cuda.lstmp_sequence_bwd_torch(*bwd_in),
                "cudnn": cudnn_lstmp_bwd(torch, t, b, c, p)}, 5)
            timings[shape]["bwd"] = (turns["kernel"], turns["plain"])
            timings[shape]["bwd_turns"] = turns
            print(f"timing lstmp_bwd T={t} B={b} C={c} P={p}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in turns.items())
                  + f" (median of 5 in turns, CUDA events; cuDNN "
                  f"nn.LSTM({p}, {c}, proj_size={p}) backward, no clips) "
                  f"[{card}]")
    try:
        rnn_cuda.lstmp_sequence(xp4.clone().requires_grad_(), w_h, b3, w_p)
    except ValueError:
        pass
    else:
        fail("lstmp_sequence returned a detached result for an input that "
             "requires grad")
    *shape, weights = LSTMP_GAIN3
    fwd_in = _lstmp_inputs(torch, gen, *shape, weights)
    got = rnn_cuda.lstmp_sequence(*fwd_in)
    ref = rnn_cuda.lstmp_sequence_torch(*fwd_in)
    r32, rk = _f64_reading(torch, rnn_cuda, fwd_in, got, ref)
    readings[tuple(shape) + (weights,)] = (r32, rk)
    print(f"reading lstmp_fwd T={shape[0]} B={shape[1]} C={shape[2]} "
          f"P={shape[3]} (gain3 weights, not checked): kernel vs plain "
          f"float32 {_rel(got, ref):.3e}; plain float32 / kernel vs plain "
          f"float64 {r32:.3e} / {rk:.3e} (of max|ref|)")
    print(f"lstmp kernels: worst max|d| relative {worst}, absolute "
          f"{worst_abs}")
    return worst_abs, timings, readings


def _kernel_short_name(name: str) -> str:
    """``void (anonymous namespace)::kernel<T>(args)`` -> ``kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0].split("::")[-1].strip()
    return name.split(" ")[-1]


def profile_split(torch, fn, label: str, steps: int, card: str):
    """``fn()`` once under ``torch.profiler`` after a warm call: the device
    time of each kernel name (launches that overlap, as programmatic
    dependent launches do, count in full for each), and the gaps, the span
    from the first kernel's start to the last one's end less the time some
    kernel ran.  Returns {"span_us", "busy_us", "gap_us", "kernels": {name:
    (us, count)}}, or None when the profiler saw no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # a short call's trace now and then comes empty
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if kernels:
            break
    else:
        print(f"profile {label}: the profiler recorded no device events in "
              f"3 tries, split not measured [{card}]")
        return None
    start = min(e.time_range.start for e in kernels)
    end = max(e.time_range.end for e in kernels)
    by_name: dict = {}
    for e in kernels:
        name = _kernel_short_name(e.name)
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + e.time_range.elapsed_us(), n + 1)
    busy, reach = 0.0, start    # the union of the kernels' intervals
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        busy += max(0.0, e.time_range.end - max(reach, e.time_range.start))
        reach = max(reach, e.time_range.end)
    split = {"span_us": end - start, "busy_us": busy,
             "gap_us": end - start - busy, "kernels": by_name}
    print(f"profile {label}: span {split['span_us']:.1f} us "
          f"({split['span_us'] / steps:.2f} us a step), some kernel "
          f"running {busy:.1f} us, gaps {split['gap_us']:.1f} us "
          f"({split['gap_us'] / max(split['span_us'], 1e-9):.3f} of the "
          f"span); " + ", ".join(
              f"{k} {us:.1f} us in {n} launches ({us / n:.2f} us each)"
              for k, (us, n) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][0]))
          + f" (torch.profiler) [{card}]")
    return split


def lstmp_profile_phase(torch, rnn_cuda, card: str) -> dict:
    """One ``lstmp_sequence`` call and one ``lstmp_sequence_bwd`` call (the
    plan's route, fed the forward's residuals) at each ``LSTMP_PROFILED``
    shape (``init_lstmp``-scale weights) split by :func:`profile_split`."""
    gen = torch.Generator().manual_seed(8)
    out = {}
    for shape in LSTMP_PROFILED:
        fwd_in = _lstmp_inputs(torch, gen, *shape, "init")
        t, b, c, p = shape
        out[("fwd",) + shape] = profile_split(
            torch, lambda: rnn_cuda.lstmp_sequence(*fwd_in),
            f"lstmp_fwd T={t} B={b} C={c} P={p}", t, card)
        bwd_in = (fwd_in + rnn_cuda.lstmp_sequence(*fwd_in)[:3]
                  + (torch.randn((t, b, p), generator=gen).cuda(),
                     torch.randn((t, b, c), generator=gen).cuda()))
        out[("bwd",) + shape] = profile_split(
            torch, lambda: rnn_cuda.lstmp_sequence_bwd(*bwd_in),
            f"lstmp_bwd T={t} B={b} C={c} P={p}", t, card)
    return out


def _standin_inputs(torch, gen, t, b, h):
    """(xp, w_hh_t, b_hh) at the stand-in's scale: xp standard normal, the
    weights uniform within 1/sqrt(H), as ``elmo.init`` draws them."""
    xp = torch.randn((t, b, 4 * h), generator=gen)
    w = (torch.rand((h, 4 * h), generator=gen) * 2 - 1) * h ** -0.5
    bias = (torch.rand((1, 4 * h), generator=gen) * 2 - 1) * h ** -0.5
    return tuple(a.cuda() for a in (xp, w, bias))


def lstm_profile_phase(torch, rnn_cuda, card: str) -> dict:
    """One ``lstm_sequence`` call at each ``STANDIN_PROFILED`` shape split
    by :func:`profile_split`."""
    gen = torch.Generator().manual_seed(9)
    out = {}
    for t, b, h in STANDIN_PROFILED:
        args = _standin_inputs(torch, gen, t, b, h)
        out[(t, b, h)] = profile_split(
            torch, lambda: rnn_cuda.lstm_sequence(*args),
            f"lstm_fwd T={t} B={b} H={h} (the stand-in encoder)", t, card)
    return out


def _bwd_inputs(torch, rnn_cuda, gen, cell: str, t: int, b: int,
                h: int) -> tuple:
    """The backward's arguments at (T, B, H): xp standard normal, the
    weights uniform within 1/sqrt(H), the plain forward's states, and
    standard normal cotangents (``dcs`` too for the LSTM)."""
    g = (3 if cell == "gru" else 4) * h
    xp = torch.randn((t, b, g), generator=gen).cuda()
    w = ((torch.rand((h, g), generator=gen) * 2 - 1) * h ** -0.5).cuda()
    bias = ((torch.rand((1, g), generator=gen) * 2 - 1) * h ** -0.5).cuda()
    dys = torch.randn((t, b, h), generator=gen).cuda()
    if cell == "gru":
        return xp, w, bias, rnn_cuda.gru_sequence_torch(xp, w, bias), dys
    dcs = torch.randn((t, b, h), generator=gen).cuda()
    ys, cs = rnn_cuda.lstm_sequence_torch(xp, w, bias)
    return xp, w, bias, ys, cs, dys, dcs


def bwd_profile_phase(torch, rnn_cuda, card: str, cells=("gru", "lstm")):
    """One backward call at each ``GRU_BWD_PROFILED`` /
    ``LSTM_BWD_PROFILED`` shape split by :func:`profile_split`."""
    gen = torch.Generator().manual_seed(10)
    out = {}
    for cell in cells:
        fn = _bwd_fns(rnn_cuda, cell)[1]
        for t, b, h in (GRU_BWD_PROFILED if cell == "gru"
                        else LSTM_BWD_PROFILED):
            args = _bwd_inputs(torch, rnn_cuda, gen, cell, t, b, h)
            out[(cell, t, b, h)] = profile_split(
                torch, lambda: fn(*args), f"{cell}_bwd T={t} B={b} H={h}",
                t, card)
    return out


def standin_lstm_phase(torch, rnn_cuda, card: str) -> tuple:
    """The LSTM forward kernel at the stand-in text encoder's H = 512
    (``STANDIN_LSTM_SHAPES``) against its plain version through both
    routes: within KERNEL_TOL, a rerun bitwise equal.  Then both routes,
    the plain loop and cuDNN's ``nn.LSTM(512, 512)`` (a yardstick used
    nowhere, input projection included) timed in turns.  Returns the
    (kernel, plain) ms per shape (the kernel through the route the plan
    takes), cuDNN's ms and the worst error."""
    gen = torch.Generator().manual_seed(5)
    timings, cudnn, worst = {}, {}, 0.0
    for t, b, h in STANDIN_LSTM_SHAPES:
        shape = (t, b, h)
        args = _standin_inputs(torch, gen, t, b, h)
        ref = rnn_cuda.lstm_sequence_torch(*args)
        routes = lstm_routes(torch, rnn_cuda, args, ref, shape)
        worst = max([worst] + [e for e, _ in routes.values()])
        lstm = torch.nn.LSTM(h, h).cuda()
        x = torch.randn((t, b, h), generator=gen).cuda()

        def library():
            with torch.no_grad():
                lstm(x)

        reps = 20 if t * b <= 4096 else 5
        ms = turns_ms(torch, {
            **_route_fns(rnn_cuda, args, shape),
            "plain": lambda: rnn_cuda.lstm_sequence_torch(*args),
            "cudnn": library}, reps)
        plan = rnn_cuda.lstm_fwd_plan(b, h)
        timings[shape] = (ms[plan["route"]], ms["plain"])
        cudnn[shape] = ms["cudnn"]
        print(f"kernel lstm_fwd T={t} B={b} H={h} (the stand-in encoder): "
              f"max|d (ys, cs)| " + ", ".join(
                  f"{r} {e:.3e} (rerun bitwise equal {sm})"
                  for r, (e, sm) in routes.items())
              + f" (tol {KERNEL_TOL}); the plan {plan}; routes " + ", ".join(
                  f"{r} {ms[r]:.4f} ms" for r in routes)
              + f", plain torch {ms['plain']:.4f} ms, cuDNN "
              f"{ms['cudnn']:.4f} ms (median of {reps} in turns, CUDA "
              f"events) [{card}]")
    return timings, cudnn, worst


def standin_summary(card: str, standin_times: dict, cudnn: dict) -> None:
    """The LSTM forward at each stand-in shape beside the plain loop,
    cuDNN's ``nn.LSTM(512, 512)`` and its bound."""
    for shape in STANDIN_LSTM_SHAPES:
        ms, plain = standin_times[shape]
        b_ms, by = rnn_bounds("lstm", *shape)["fwd"]
        print(f"lstm_fwd at the stand-in's (T, B, H) = {shape}: kernel "
              f"{ms:.4f} ms, plain loop {plain:.4f} ms, cuDNN "
              f"{cudnn[shape]:.4f} ms, bound {b_ms:.6f} ms ({by}); "
              f"{plain / ms:.2f}x the plain loop's speed, "
              f"{cudnn[shape] / ms:.2f}x cuDNN's, {b_ms / ms:.4f} of the "
              f"bound [{card}]")


def library_phase(torch, card: str, only=("",)) -> dict:
    """The nearest PyTorch call to each kernel, timed as a yardstick and
    used nowhere in the port: cuDNN's ``nn.GRU`` / ``nn.LSTM`` (they also
    do the input projection the kernels take ready-made) and
    ``nn.LSTM(proj_size=...)`` for the LSTMP cell (no +-3 clips).  The
    backwards are ``torch.autograd.grad`` of the forward's output with
    respect to the input and the weights.  ``only``: the names that start
    with it (a prefix, or a tuple of prefixes)."""
    (t1, b1, c1, p1), (t2, b2, c2, p2), (t3, b3, c3, p3) = LSTMP_TIMED
    shapes = {"gru_fwd": ("gru",) + BWD_TIMED[0] + (None,),
              "gru_bwd": ("gru",) + BWD_TIMED[0] + (None,),
              "gru_bwd_streamed": ("gru",) + BWD_TIMED[-1] + (None,),
              "lstm_fwd": ("lstm",) + LSTM_TIMED[0] + (None,),
              "lstm_bwd": ("lstm",) + LSTM_TIMED[0] + (None,),
              "lstm_bwd_streamed": ("lstm",) + LSTM_TIMED[-1] + (None,),
              "lstmp_fwd": ("lstm", t1, b1, c1, p1),
              "lstmp_bwd": ("lstm", t1, b1, c1, p1),
              "lstmp_fwd_b8": ("lstm", t2, b2, c2, p2),
              "lstmp_bwd_b8": ("lstm", t2, b2, c2, p2),
              "lstmp_fwd_t128": ("lstm", t3, b3, c3, p3),
              "lstmp_bwd_t128": ("lstm", t3, b3, c3, p3)}
    out = {}
    for name, (cell, t, b, h, proj) in shapes.items():
        if not name.startswith(only):
            continue
        d = proj or h
        kw = {"proj_size": proj} if proj else {}
        mod = (torch.nn.GRU(d, h) if cell == "gru"
               else torch.nn.LSTM(d, h, **kw)).cuda()
        x = torch.randn((t, b, d), device="cuda", requires_grad=True)
        if "bwd" in name:
            y, _ = mod(x)
            dy = torch.randn_like(y)
            wrt = [x, *mod.parameters()]

            def fn():
                torch.autograd.grad(y, wrt, dy, retain_graph=True)
        else:
            def fn():
                with torch.no_grad():
                    mod(x)
        fn()
        out[name] = event_ms(fn, 10, torch)
        print(f"timing library {name}: torch.nn.{cell.upper()}"
              f"({d}, {h}{f', proj_size={proj}' if proj else ''}) "
              f"{'backward' if 'bwd' in name else 'forward'} at T={t} B={b}: "
              f"{out[name]:.4f} ms (median of 10, CUDA events; cuDNN, "
              f"input projection included"
              f"{', no clips' if proj else ''}) [{card}]")
    return out


def lstmp_summary(card: str, lstmp_times: dict, library: dict) -> None:
    """The LSTMP forward at each timed shape beside the plain loop, cuDNN's
    ``nn.LSTM(proj_size=P)`` (no clips) and its bound."""
    lib = dict(zip(LSTMP_TIMED, ("lstmp_fwd", "lstmp_fwd_b8",
                                 "lstmp_fwd_t128")))
    for shape in LSTMP_TIMED:
        ms, plain = lstmp_times[shape]["fwd"]
        b_ms, by = lstmp_bounds(*shape)["fwd"]
        cudnn = library[lib[shape]]
        print(f"lstmp_fwd at (T, B, C, P) = {shape}: kernel {ms:.4f} ms, "
              f"plain loop {plain:.4f} ms, cuDNN {cudnn:.4f} ms, bound "
              f"{b_ms:.4f} ms ({by}); {plain / ms:.2f}x the plain loop's "
              f"speed, {cudnn / ms:.2f}x cuDNN's, {b_ms / ms:.4f} of the "
              f"bound [{card}]")
        turns = lstmp_times[shape]["bwd_turns"]
        ms = turns["kernel"]
        b_ms, by = lstmp_bounds(*shape)["bwd"]
        t, _, c, p = shape
        stream_ms = t * 5 * c * p * 4 / PEAK_HBM_BYTES * 1e3
        print(f"lstmp_bwd at (T, B, C, P) = {shape}: kernel {ms:.4f} ms, "
              f"plain {turns['plain']:.4f} ms, cuDNN {turns['cudnn']:.4f} ms"
              f" (in turns); bound {b_ms:.4f} ms ({by}, the weights "
              f"counted once), {b_ms / ms:.4f} of it; the step walk's "
              f"weight stream (5CP floats a step from HBM) {stream_ms:.4f} "
              f"ms; {turns['plain'] / ms:.2f}x the plain loop's speed, "
              f"{turns['cudnn'] / ms:.2f}x cuDNN's [{card}]")


def bound(flops: float, nbytes: float):
    """(least ms, "operations" or "bytes"): the larger of the operations
    over the fp32 peak and the bytes over the memory rate."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rnn_bounds(cell: str, t: int, b: int, h: int) -> dict:
    """The GRU's or LSTM's forward and backward bounds at (T, B, H): the
    recurrent products' flops (the backward recomputes the gates, carries
    the state and reduces dW), each input read once and each output
    written once, in float32."""
    g = (3 if cell == "gru" else 4) * h
    states = 1 if cell == "gru" else 2          # ys (+ cs)
    return {
        "fwd": bound(2 * t * b * h * g,
                     4 * (t * b * g + h * g + g + states * t * b * h)),
        "bwd": bound(3 * 2 * t * b * h * g,
                     4 * (2 * t * b * g + 2 * h * g + 2 * g
                          + 2 * states * t * b * h))}


def lstmp_bounds(t: int, b: int, c: int, p: int) -> dict:
    """The LSTMP kernels' bounds at (T, B, C, P): forward 2 T B (4CP + CP)
    flops over xp4, the weights, ys, hpre, cpre and hf; backward (the
    kernel's part) 2 T B (9 C P) flops over xp4, the weights, ys, hpre,
    dys, dhpre, cpre, dcpre and dgates."""
    weights = 4 * c * p + 4 * c + c * p
    return {
        "fwd": bound(2 * t * b * 5 * c * p,
                     4 * (t * b * 4 * c + weights + 2 * t * b * p
                          + 2 * t * b * c)),
        "bwd": bound(2 * t * b * 9 * c * p,
                     4 * (2 * t * b * 4 * c + weights + 4 * t * b * p
                          + 2 * t * b * c))}


def print_bounds(card: str, timings: dict) -> None:
    """A bound line for every timed shape: ``timings`` maps (name, shape)
    to the kernel's ms."""
    for (name, shape), ms in timings.items():
        cell, direction = name.split("_")
        b_ms, by = (lstmp_bounds(*shape) if cell == "lstmp"
                    else rnn_bounds(cell, *shape))[direction]
        print(f"bound {name} at {shape}: {b_ms:.6f} ms ({by}) against "
              f"{ms:.4f} ms measured, {b_ms / ms:.4f} of the bound "
              f"[{card}]")


def kernel_bounds() -> dict:
    """Each kernel's bound at the shape its JSON entry is timed at."""
    gru, lstm = (rnn_bounds("gru", *TIMED_SHAPES[0]),
                 rnn_bounds("lstm", *LSTM_TIMED[0]))
    lstmp = lstmp_bounds(*LSTMP_TIMED[0])
    return {"gru_fwd": gru["fwd"], "gru_bwd": rnn_bounds(
                "gru", *BWD_TIMED[0])["bwd"],
            "lstm_fwd": lstm["fwd"], "lstm_bwd": lstm["bwd"],
            "lstmp_fwd": lstmp["fwd"], "lstmp_bwd": lstmp["bwd"]}


COUNTERS = {"gru_fwd": "LAUNCHES", "gru_bwd": "BWD_LAUNCHES",
            "lstm_fwd": "LSTM_LAUNCHES", "lstm_bwd": "LSTM_BWD_LAUNCHES",
            "lstmp_fwd": "LSTMP_LAUNCHES", "lstmp_bwd": "LSTMP_BWD_LAUNCHES"}


def _counts(rnn_cuda) -> dict:
    return {k: getattr(rnn_cuda, v) for k, v in COUNTERS.items()}


def _set_counts(rnn_cuda, counts: dict) -> None:
    for k, v in COUNTERS.items():
        setattr(rnn_cuda, v, counts[k])


ZERO = {k: 0 for k in COUNTERS}


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


def write_audio_npz(root: Path, feats, sds, clf) -> None:
    """``Features/AudioWhole`` in the JAX package's npz layout, from the
    port's own extraction."""
    import numpy as np

    audio = root / "Features" / "AudioWhole"
    audio.mkdir(parents=True)
    xa = feats.cpu().numpy()[:, :, None, :]
    for track, y in (("clf", clf), ("reg", sds)):
        np.savez(audio / f"whole_samples_{track}_256.npz", xa)
        np.savez(audio / f"whole_labels_{track}_256.npz", y)


def seeded_bundle(torch, path: Path, corpus_chars: str, seed: int = 11):
    """A converted-ELMo bundle at the zhs geometry (6784 chars, char-CNN
    filters (1,32)...(7,1024), 2 highways, 512 out; biLM C = 4096,
    P = 512, 2 layers, +-3 clips) with weights drawn from ``seed`` by the
    port's threefry on the card, written by the port's ``save_npz``.  The
    char lexicon is the specials, ``corpus_chars`` and then CJK code points
    from U+4E00 up to the vocabulary size.  Returns (path, the lexicon's
    characters)."""
    from icassp2022_depression_tpu_torch.models import char_cnn, elmo
    from icassp2022_depression_tpu_torch.models import elmo_pretrained as ep
    from icassp2022_depression_tpu_torch.ops import prng

    ccfg = char_cnn.CharCnnConfig()
    lcfg = elmo.ElmoLstmpConfig(vocab_size=1)
    chars = list(dict.fromkeys(corpus_chars))
    code = 0x4E00
    while len(chars) < ccfg.n_chars - 6:
        if chr(code) not in chars:
            chars.append(chr(code))
        code += 1
    lexicon = {tok: i for i, tok in enumerate(
        [ep.PAD, ep.OOV, ep.BOS, ep.EOS, ep.BOW, ep.EOW] + chars)}
    enc = elmo.init_lstmp_encoder(prng.prng_key(seed + 1, "cuda"), lcfg)
    pe = ep.PretrainedElmo(ccfg, lcfg,
                           char_cnn.init(prng.prng_key(seed, "cuda"), ccfg),
                           {"layers": enc["layers"]}, lexicon, None)
    ep.save_npz(path, pe)
    return path, chars


def bundle_id(path: Path) -> str:
    return f"elmo_bundle:{path.name}:{path.stat().st_size}"


PIPELINE_TASKS = {"clf": ("audio_clf", "text_clf", "fuse_clf"),
                  "reg": ("audio_reg", "text_reg", "fuse_reg")}


def pipeline_run(torch, root: Path, track: str, card: str, embedder: str,
                 fold_cfg=None, extra_argv=(), outside=None,
                 all_gated: bool = False) -> dict:
    """``cli pipeline --track <track> [extra_argv]`` on ``root``, counted:
    every kernel counter is zeroed just before and read just after, and
    each stage's launches and wall time are recorded by wrapping its
    trainer (``fold_cfg``, when given, is passed to the reg trainers).
    Checks the launches of each stage and, outside the trainers,
    ``outside`` (the text extraction of a ``--corpus`` run), the metrics,
    the summary line, every gated fold's artifacts and that the text and
    fusion sidecars name ``embedder`` (with ``all_gated``, every fold must
    have gated); returns the launches and the stage wall times."""
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
                           str(root), "--device", "cuda", *extra_argv])
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
        if all_gated and len(gated) != len(bests):
            fail(f"{task}: {len(gated)} of {len(bests)} folds gated with "
                 "the gates open")
        for r in gated:
            for f in _artifacts(checkpoints, model, task, r):
                if not f.is_file():
                    fail(f"gated {task} fold {r['fold']} wrote no {f}")
            if not task.startswith("audio"):
                meta = checkpoints.load_meta(
                    next(iter(_artifacts(checkpoints, model, task, r))))
                if meta.get("text_embedder") != embedder:
                    fail(f"{task} sidecar names another embedder: {meta}")
        named = ("" if task.startswith("audio") or not gated
                 else f", their sidecars name {embedder}")
        print(f"  {task}: {len(gated)} of 3 folds gated, their artifacts "
              f"written{named}; wall {stages[task][0]:.2f} s [{card}]")
    outside = dict(ZERO, **(outside or {}))
    if total != {k: outside[k] + sum(st[1][k] for st in stages.values())
                 for k in total}:
        fail(f"launches outside the trainers: {total}, stages {stages}, "
             f"expected {outside} outside")
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


def extract_text_run(torch, card: str, corpus: Path, out: Path,
                     bundle: Path) -> dict:
    """``cli extract-text`` of ``corpus`` with the seeded bundle on the
    card, counted: exactly 2 layers x 2 directions of ``lstmp_fwd`` per
    sentence batch of 128 and nothing else.  Checks the npz files and the
    provenance sidecar, then holds the card's pooled features of the first
    speakers against the same bundle on the CPU (not counted).  Returns
    the launches, the wall time and the card-vs-CPU difference."""
    import numpy as np

    from icassp2022_depression_tpu_torch import cli
    from icassp2022_depression_tpu_torch.data import eatd
    from icassp2022_depression_tpu_torch.frontend import text as tfe
    from icassp2022_depression_tpu_torch.models import elmo_pretrained as ep
    from icassp2022_depression_tpu_torch.ops import rnn_cuda

    texts = [sp.texts for sp in eatd.iter_speakers(corpus, read_text=True)]
    n_batches = -(-3 * len(texts) // 128)
    buf = io.StringIO()
    _set_counts(rnn_cuda, ZERO)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["extract-text", "--root", str(corpus), "--out",
                       str(out), "--elmo-weights", str(bundle),
                       "--segmenter", "fallback", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _counts(rnn_cuda)
    if rc != 0:
        fail(f"cli extract-text returned {rc}")
    want = dict(ZERO, lstmp_fwd=4 * n_batches)
    print(f"cli extract-text: {buf.getvalue().strip()}; {3 * len(texts)} "
          f"answers in {n_batches} batch(es), kernel launches {got}; wall "
          f"{wall:.2f} s [{card}]")
    if got != want:
        fail(f"cli extract-text launched {got}, expected {want}")
    feats = np.load(out / "whole_samples_clf_avg.npz")["arr_0"]
    if feats.shape != (len(texts), 3, 1024) or not np.isfinite(feats).all():
        fail(f"extract-text features malformed: {feats.shape}")
    labels = np.load(out / "whole_labels_clf_avg.npz")["arr_0"]
    means = [feats[labels == k].reshape(-1, feats.shape[-1]).mean(0)
             for k in (0, 1)]
    print(f"extract-text class separation: |mean(depressed) - "
          f"mean(not)| / |mean(not)| = "
          f"{np.linalg.norm(means[1] - means[0]) / np.linalg.norm(means[0]):.4e}"
          f", max per-dimension gap {np.abs(means[1] - means[0]).max():.4e}")
    meta = json.loads((out / "extraction_meta.json").read_text())
    if meta["embedder"] != bundle_id(bundle) or \
            meta["segmenter"] != "fallback":
        fail(f"extraction_meta.json: {meta}")
    pe_cpu = ep.load_npz(bundle, "cpu")
    n = 3
    cpu = pe_cpu.embed_sentences([tfe.tokenize(t, "fallback")
                                  for ts in texts[:n] for t in ts]).numpy()
    card_rows = feats[:n].reshape(3 * n, -1)
    err = float(np.abs(card_rows - cpu).max() / np.abs(cpu).max())
    print(f"extract-text pooled features of {n} speakers, card vs CPU: "
          f"max|d| = {err:.3e} of max|CPU| (tol {SLICE_TOL})")
    if not err <= SLICE_TOL:
        fail(f"extract-text on the card differs from the CPU: {err}")
    return {"launches": got, "wall_s": wall, "cpu_err": err}


def train_phase(torch, card: str, corpus: Path, bundle: Path):
    """The training paths, counted (``cli extract-text`` with the seeded
    bundle, the clf pipeline at the full recipes on its features, ``cli
    train --corpus`` and ``cli pipeline --track reg --corpus`` at reduced
    epochs), then the comparisons and timings.  Returns the counted
    launches."""
    from icassp2022_depression_tpu_torch import cli
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import folds
    from icassp2022_depression_tpu_torch.frontend import audio as afe
    from icassp2022_depression_tpu_torch.ops import rnn_cuda
    from icassp2022_depression_tpu_torch.train import trainers

    launches = dict(ZERO)
    embedder = bundle_id(bundle)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        t0 = time.perf_counter()
        feats, sds, clf = afe.extract_eatd_device(corpus, device="cuda")
        torch.cuda.synchronize()
        extract_s = time.perf_counter() - t0
        root = Path(tmp) / "npz"
        write_audio_npz(root, feats, sds, clf)
        print(f"extract_eatd_device: {feats.shape[0]} speakers "
              f"({int(clf.sum())} depressed), {extract_s:.2f} s; audio npz "
              f"written [{card}]")

        # -- main path: cli extract-text, then the clf pipeline on its
        # features at the full recipes ---------------------------------
        text = extract_text_run(torch, card, corpus,
                                root / "Features" / "TextWhole", bundle)
        for k, v in text["launches"].items():
            launches[k] += v
        clf_run = pipeline_run(torch, root, "clf", card, embedder)
        for k, v in clf_run["launches"].items():
            launches[k] += v

        # -- cli train --task audio_clf --corpus, reduced epochs, gates
        # open: every fold saves, for phase 6's cli check ------------------
        full = {n: getattr(C, n) for n in
                ("AUDIO_CLF", "AUDIO_REG", "TEXT_REG", "FUSE_REG_TRAINER")}
        try:
            C.AUDIO_CLF = C.replace(
                full["AUDIO_CLF"], epochs=REDUCED_EPOCHS + 1,
                gate=C.replace(full["AUDIO_CLF"].gate, f1_floor=-1.0,
                               train_acc_frac=0.0, train_acc_strict=False))
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
            gated = [r for r in records
                     if r["event"] == "fold_best" and r["epoch"] >= 0]
            if len(gated) != 3:
                fail(f"cli train audio_clf --corpus: {len(gated)} of 3 "
                     "folds gated with the gates open")
            for k, v in got.items():
                launches[k] += v
            print(f"cli train audio_clf --corpus, 3 folds x "
                  f"{REDUCED_EPOCHS} epochs: wall {corpus_wall:.2f} s "
                  f"(extraction + folds) [{card}]")

            # -- cli pipeline --track reg, reduced epochs, gates open:
            # every fold saves, so the sidecars of the text and fusion
            # checkpoints trained on the --corpus extraction are checked
            for n in ("AUDIO_REG", "TEXT_REG", "FUSE_REG_TRAINER"):
                setattr(C, n, C.replace(
                    full[n], epochs=REDUCED_EPOCHS + 1,
                    gate=C.replace(full[n].gate, mae_ceiling=1e9,
                                   train_mae_ceiling=1e9)))
            cut = C.FoldConfig.sds_threshold
            n_dep, n_non = int((sds >= cut).sum()), int((sds < cut).sum())
            fold_cfg = C.FoldConfig(reg_test_dep=n_dep // 3,
                                    reg_test_non=n_non // 3)
            # beside the corpus, so that phase 6 checks its checkpoints
            reg_run = pipeline_run(
                torch, corpus.parent / "reg", "reg", card, embedder, fold_cfg,
                ["--corpus", str(corpus), "--elmo-weights", str(bundle),
                 "--segmenter", "fallback"],
                {"lstmp_fwd": text["launches"]["lstmp_fwd"]},
                all_gated=True)
            for k, v in reg_run["launches"].items():
                launches[k] += v
            reg_run.update(root=corpus.parent / "reg", fold_cfg=fold_cfg)
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
                      "text": text, "corpus_wall_s": corpus_wall,
                      "split": split, "cmp": cmp}


def _transcripts(rng, chars, n: int) -> list:
    """n speakers' 3 answers of 20-120 CJK characters each."""
    return [["".join(rng.choice(chars, int(rng.integers(20, 121))))
             for _ in range(3)] for _ in range(n)]


def text_serving_phase(torch, card: str, bundle: Path, chars) -> tuple:
    """Serving ``fuse_clf`` and ``text_clf`` through the text frontend on
    the card, with full-width seeded checkpoints whose sidecars name the
    bundle (found through ``ICASSP_ELMO_WEIGHTS``, as a user sets it).
    Counted: ``cli predict`` of one speaker per task, then
    ``Predictor.predict_batch`` (``fuse_clf``) at 1 and 8 speakers with
    seeded transcripts, each with exact launches (4 ``lstmp_fwd`` per
    sentence batch, the fusion's 4 LSTM and 2 GRU forwards, no backward).
    Not counted: the same ``cli predict`` and the 8 speakers'
    ``predict_batch`` and text features on the CPU, which must agree, and
    the warm latencies.  Returns the launches and the latencies."""
    import os

    import numpy as np

    from icassp2022_depression_tpu_torch import cli
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import eatd
    from icassp2022_depression_tpu_torch.models import porting
    from icassp2022_depression_tpu_torch.models.fusion import FusionNet
    from icassp2022_depression_tpu_torch.models.text_net import TextNet
    from icassp2022_depression_tpu_torch.ops import rnn_cuda
    from icassp2022_depression_tpu_torch.serving.predictors import Predictor
    from icassp2022_depression_tpu_torch.train import checkpoints

    launches = dict(ZERO)
    per_request = {"fuse_clf": dict(ZERO, lstmp_fwd=4, lstm_fwd=4,
                                    gru_fwd=2),
                   "text_clf": dict(ZERO, lstmp_fwd=4, lstm_fwd=4)}
    before_env = os.environ.get("ICASSP_ELMO_WEIGHTS")
    os.environ["ICASSP_ELMO_WEIGHTS"] = str(bundle)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_text_") as tmp:
            root = Path(tmp) / "corpus"
            eatd.make_synthetic_corpus(root, n_data=6, n_validation=2,
                                       seconds=(2.0, 12.0), seed=4)
            meta = {"text_embedder": bundle_id(bundle),
                    "text_segmenter": "fallback", "note": "seeded weights"}
            gen = torch.Generator().manual_seed(6)
            ckpts = {
                "fuse_clf": checkpoints.save(
                    Path(tmp) / "fuse_clf", porting.fusion_tree_from_state_dict(
                        FusionNet(C.FUSE_CLF, gen).state_dict(), C.FUSE_CLF),
                    dict(meta, task="fuse_clf")),
                "text_clf": checkpoints.save(
                    Path(tmp) / "text_clf", porting.text_net_tree_from_state_dict(
                        TextNet(C.TEXT_CLF.model, gen).state_dict(),
                        C.TEXT_CLF.model), dict(meta, task="text_clf"))}
            sp = eatd.load_speaker(root, "Data", 1)
            for task, ckpt in ckpts.items():
                buf = io.StringIO()
                _set_counts(rnn_cuda, ZERO)
                with contextlib.redirect_stdout(buf), \
                        contextlib.redirect_stderr(io.StringIO()):
                    rc = cli.main(["predict", "--task", task, "--ckpt",
                                   str(ckpt), "--root", str(root),
                                   "--speaker", "Data/1", "--device",
                                   "cuda"])
                torch.cuda.synchronize()
                got = _counts(rnn_cuda)
                if rc != 0:
                    fail(f"cli predict --task {task} returned {rc}")
                out = json.loads(buf.getvalue().strip().splitlines()[-1])
                print(f"cli predict --task {task} Data/1: {json.dumps(out)} "
                      f"(kernel launches {got})")
                if got != per_request[task]:
                    fail(f"cli predict --task {task} launched {got}, "
                         f"expected {per_request[task]}")
                check_results([out], 1, f"cli predict {task}")
                for k, v in got.items():
                    launches[k] += v
                with contextlib.redirect_stderr(io.StringIO()):
                    cpu = Predictor.from_checkpoint(ckpt, task, device="cpu")
                kw = {"texts": sp.texts}
                if task == "fuse_clf":
                    kw.update(waveforms=sp.waveforms,
                              sample_rates=sp.sample_rates,
                              ordinal_base=3 * eatd.corpus_position(
                                  root, "Data", 1))
                d = compare([out], [cpu.predict_speaker(**kw)],
                            f"cli predict {task} vs CPU")
                print(f"cli predict --task {task} vs the same predictor on "
                      f"the CPU: max|dprob| = {d:.3e} (tol {SLICE_TOL})")

            # -- Predictor.predict_batch, fuse_clf, 1 and 8 speakers --------
            speakers = list(eatd.iter_speakers(root, read_text=False))
            rng = np.random.default_rng(7)
            with contextlib.redirect_stderr(io.StringIO()):
                predictor = Predictor.from_checkpoint(
                    ckpts["fuse_clf"], "fuse_clf", device="cuda",
                    feature_cache_entries=0)
            latency, served = {}, {}
            for n in (1, 8):
                req = ([s.waveforms for s in speakers[:n]],
                       [s.sample_rates for s in speakers[:n]],
                       _transcripts(rng, chars, n))
                _set_counts(rnn_cuda, ZERO)
                res = predictor.predict_batch(*req)
                torch.cuda.synchronize()
                got = _counts(rnn_cuda)
                print(f"predict_batch fuse_clf {n} speakers: kernel launches "
                      f"{got}")
                if got != per_request["fuse_clf"]:
                    fail(f"predict_batch({n}) fuse_clf launched {got}")
                check_results(res, n, f"predict_batch fuse_clf ({n})")
                served[n] = (req, res)
                for k, v in got.items():
                    launches[k] += v
                counted = _counts(rnn_cuda)
                times = []
                for _ in range(6):
                    t0 = time.perf_counter()
                    predictor.predict_batch(*req)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                latency[n] = statistics.median(times[1:])
                _set_counts(rnn_cuda, counted)
                n_chars = sum(len(t) for ts in req[2] for t in ts)
                print(f"timing predict_batch fuse_clf {n} speakers "
                      f"({n_chars} transcript characters, features not "
                      f"cached): median {latency[n]:.2f} ms of 5 warm "
                      f"(host clock) [{card}]")

            # -- the 8 speakers' long transcripts (T up to 128) on the
            # CPU, not counted: results and text features equal ----------
            counted = _counts(rnn_cuda)
            req, res = served[8]
            with contextlib.redirect_stderr(io.StringIO()):
                cpu = Predictor.from_checkpoint(
                    ckpts["fuse_clf"], "fuse_clf", device="cpu",
                    feature_cache_entries=0)
            d = compare(res, cpu.predict_batch(*req),
                        "predict_batch fuse_clf (8) vs CPU")
            want = cpu.text_features(req[2])
            err = float(np.abs(predictor.text_features(req[2]) - want).max()
                        / np.abs(want).max())
            _set_counts(rnn_cuda, counted)
            print(f"predict_batch fuse_clf 8 speakers vs the same predictor "
                  f"on the CPU: max|dprob| = {d:.3e} (tol {SLICE_TOL}); "
                  f"text features max|d| = {err:.3e} of max|CPU| (tol "
                  f"{SLICE_TOL})")
            if not err <= SLICE_TOL:
                fail(f"served text features on the card differ from the "
                     f"CPU's: {err}")
    finally:
        if before_env is None:
            os.environ.pop("ICASSP_ELMO_WEIGHTS", None)
        else:
            os.environ["ICASSP_ELMO_WEIGHTS"] = before_env
    return launches, latency


def standin_serving_phase(torch, card: str) -> tuple:
    """Serving ``text_clf`` and ``fuse_clf`` through the seeded stand-in
    text encoder (``elmo_weights=None``: the path of every machine without
    an ELMo bundle), full-width seeded checkpoints.  Counted:
    ``Predictor.predict_batch`` at 1 and 8 speakers with seeded
    transcripts, each with exact launches (the stand-in's 2 layers x 2
    directions of ``lstm_fwd`` and the text model's 4, the fusion's 2 GRU
    forwards, no backward).  Not counted: the warm latencies, and the 8
    speakers' ``text_clf`` results and text features against the same
    predictor on the CPU.  Returns the launches and the latencies."""
    import numpy as np

    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import eatd
    from icassp2022_depression_tpu_torch.models import porting
    from icassp2022_depression_tpu_torch.models.fusion import FusionNet
    from icassp2022_depression_tpu_torch.models.text_net import TextNet
    from icassp2022_depression_tpu_torch.ops import rnn_cuda
    from icassp2022_depression_tpu_torch.serving.predictors import Predictor
    from icassp2022_depression_tpu_torch.train import checkpoints

    launches = dict(ZERO)
    per_request = {"fuse_clf": dict(ZERO, lstm_fwd=8, gru_fwd=2),
                   "text_clf": dict(ZERO, lstm_fwd=8)}
    latency = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_standin_") as tmp:
        root = Path(tmp) / "corpus"
        eatd.make_synthetic_corpus(root, n_data=8, n_validation=2,
                                   seconds=(2.0, 12.0), seed=4)
        speakers = list(eatd.iter_speakers(root, read_text=True))
        chars = sorted({ch for sp in speakers for t in sp.texts for ch in t
                        if not ch.isspace()})
        meta = {"text_embedder": "prng:seed=0", "text_segmenter": "fallback",
                "note": "seeded weights"}
        gen = torch.Generator().manual_seed(6)
        trees = {"fuse_clf": porting.fusion_tree_from_state_dict(
                     FusionNet(C.FUSE_CLF, gen).state_dict(), C.FUSE_CLF),
                 "text_clf": porting.text_net_tree_from_state_dict(
                     TextNet(C.TEXT_CLF.model, gen).state_dict(),
                     C.TEXT_CLF.model)}
        rng = np.random.default_rng(8)
        texts = _transcripts(rng, chars, 8)
        for task, tree in trees.items():
            ckpt = checkpoints.save(Path(tmp) / task, tree,
                                    dict(meta, task=task))
            with contextlib.redirect_stderr(io.StringIO()):
                predictor = Predictor.from_checkpoint(
                    ckpt, task, device="cuda", feature_cache_entries=0,
                    elmo_weights=None)
            if predictor.embedder_id != "prng:seed=0":
                fail(f"{task} served with {predictor.embedder_id}, not the "
                     f"stand-in")
            for n in (1, 8):
                req = (None, None, texts[:n])
                if task == "fuse_clf":
                    req = ([sp.waveforms for sp in speakers[:n]],
                           [sp.sample_rates for sp in speakers[:n]],
                           texts[:n])
                _set_counts(rnn_cuda, ZERO)
                res = predictor.predict_batch(*req)
                torch.cuda.synchronize()
                got = _counts(rnn_cuda)
                print(f"predict_batch {task} {n} speakers (stand-in "
                      f"encoder): kernel launches {got}")
                if got != per_request[task]:
                    fail(f"predict_batch({n}) {task} with the stand-in "
                         f"launched {got}, expected {per_request[task]}")
                check_results(res, n, f"predict_batch {task} stand-in ({n})")
                for k, v in got.items():
                    launches[k] += v
                counted = _counts(rnn_cuda)
                times = []
                for _ in range(6):
                    t0 = time.perf_counter()
                    predictor.predict_batch(*req)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                latency[(task, n)] = statistics.median(times[1:])
                _set_counts(rnn_cuda, counted)
                n_chars = sum(len(t) for ts in texts[:n] for t in ts)
                print(f"timing predict_batch {task} {n} speakers (stand-in "
                      f"encoder, {n_chars} transcript characters, features "
                      f"not cached): median {latency[(task, n)]:.2f} ms of 5 "
                      f"warm (host clock) [{card}]")
            if task == "text_clf":
                counted = _counts(rnn_cuda)
                with contextlib.redirect_stderr(io.StringIO()):
                    cpu = Predictor.from_checkpoint(
                        ckpt, task, device="cpu", feature_cache_entries=0,
                        elmo_weights=None)
                d = compare(res, cpu.predict_batch(*req),
                            "predict_batch text_clf stand-in (8) vs CPU")
                want = cpu.text_features(texts)
                err = float(np.abs(predictor.text_features(texts) - want)
                            .max() / np.abs(want).max())
                _set_counts(rnn_cuda, counted)
                print(f"predict_batch text_clf 8 speakers (stand-in encoder) "
                      f"vs the same predictor on the CPU: max|dprob| = "
                      f"{d:.3e} (tol {SLICE_TOL}); text features max|d| = "
                      f"{err:.3e} of max|CPU| (tol {SLICE_TOL})")
                if not err <= SLICE_TOL:
                    fail(f"stand-in text features on the card differ from "
                         f"the CPU's: {err}")
    return launches, latency


class RefAudioBiLSTM(torch.nn.Module):
    """The reference's audio classifier as it pickles
    (``Classification/audio_gru_whole.py:24-108`` names, full width).  It
    is defined only here, so ``torch.save`` of it pickles a class that no
    other code defines, as a reference user's checkpoint does."""

    def __init__(self, d: int = 256, h: int = 256):
        super().__init__()
        nn = torch.nn
        self.attention_layer = nn.Sequential(nn.Linear(h, h),
                                             nn.ReLU(inplace=True))
        self.lstm_net_audio = nn.GRU(d, h, num_layers=2, batch_first=True)
        self.ln = nn.LayerNorm(d)
        self.fc_audio = nn.Sequential(
            nn.Dropout(0.5), nn.Linear(h, h), nn.ReLU(), nn.Dropout(0.5),
            nn.Linear(h, 2), nn.Softmax(dim=1))


class RefFusionReg(torch.nn.Module):
    """The reference's regression fusion as it pickles
    (``Regression/fuse_net.py:325-351`` names: no ``ln``, one output)."""

    def __init__(self, ae: int = 256, te: int = 1024, ah: int = 256,
                 th: int = 128):
        super().__init__()
        nn = torch.nn
        self.attention_layer = nn.Sequential(nn.Linear(th, th),
                                             nn.ReLU(inplace=True))
        self.lstm_net = nn.LSTM(te, th, num_layers=2, bidirectional=True)
        self.fc_out = nn.Sequential(nn.Dropout(0.5), nn.Linear(th, th),
                                    nn.ReLU(), nn.Dropout(0.5))
        self.lstm_net_audio = nn.GRU(ae, ah, num_layers=2, batch_first=True)
        self.fc_audio = nn.Sequential(nn.Dropout(0.5), nn.Linear(ah, ah),
                                      nn.ReLU(), nn.Dropout(0.5))
        self.modal_attn = nn.Linear(th + ah, th + ah, bias=False)
        self.fc_final = nn.Sequential(nn.Linear(th + ah, 1, bias=False),
                                      nn.ReLU())


#: kernel launches of one check fold's forward, by branch
CHECK_FOLD = {"audio": dict(ZERO, gru_fwd=2), "text": dict(ZERO, lstm_fwd=4),
              "fuse": dict(ZERO, lstm_fwd=4, gru_fwd=2)}


def check_launches(task: str, n_answers: int = 0) -> dict:
    """A three-fold ``cli check``'s launches: each fold's forward, plus,
    for the text and fusion tasks with ``--corpus``, the text extraction
    of ``n_answers`` answers (4 ``lstmp_fwd`` a batch of 128)."""
    branch = task.split("_")[0]
    want = {k: 3 * v for k, v in CHECK_FOLD[branch].items()}
    if branch != "audio" and n_answers:
        want["lstmp_fwd"] = 4 * -(-n_answers // 128)
    return want


def _fold_ckpt(directory: Path, pattern: str) -> Path:
    found = sorted(directory.glob(pattern))
    if len(found) != 1:
        fail(f"expected one checkpoint {directory}/{pattern}, found {found}")
    return found[0]


def _nan_as_zero(x: float) -> float:
    """The trainers' gate counts a 0/0 precision (no positive prediction)
    as 0 on the device, the host's metrics as nan."""
    return 0.0 if x != x else x


def _rows_diff(rows, base) -> float:
    """The largest difference between two ``cli check`` outputs' numbers
    (each fold's line and the mean's)."""
    def numbers(row):
        return [_nan_as_zero(float(v)) for v in row.get("mean", row).values()]
    return max(abs(a - b) for ra, rb in zip(rows, base)
               for a, b in zip(numbers(ra), numbers(rb)))


def _output(pred: dict) -> list:
    return pred["probs"] if "probs" in pred else [pred["sds_score"]]


@contextlib.contextmanager
def _reg_fold_cfg(checking, fold_cfg):
    """The regression checks on ``fold_cfg`` (the reg pipeline's folds,
    cut to the corpus), as :func:`pipeline_run` hands it to the
    trainers."""
    names = ("check_audio_reg", "check_text_reg", "check_fuse_reg")
    originals = {n: getattr(checking, n) for n in names}

    def with_cfg(fn):
        def run(*args, **kwargs):
            return fn(*args, **dict(kwargs, fold_cfg=fold_cfg))
        return run

    for n, fn in originals.items():
        setattr(checking, n, with_cfg(fn))
    try:
        yield
    finally:
        for n, fn in originals.items():
            setattr(checking, n, fn)


class _Counted:
    """``cli.main`` calls with every kernel counter zeroed just before and
    read just after; each call's launches must be exactly the expected
    ones, and they add up in ``launches``."""

    def __init__(self, torch, rnn_cuda):
        self.torch, self.rnn_cuda = torch, rnn_cuda
        self.launches = dict(ZERO)

    def __call__(self, argv, want: dict, what: str):
        """Returns the call's stdout lines and wall time."""
        from icassp2022_depression_tpu_torch import cli

        argv = [str(a) for a in argv]
        if argv[0] != "export-pt":      # the one that runs no model
            argv += ["--device", "cuda"]
        buf = io.StringIO()
        _set_counts(self.rnn_cuda, ZERO)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        self.torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _counts(self.rnn_cuda)
        if rc != 0:
            fail(f"{what} returned {rc}")
        if got != want:
            fail(f"{what} launched {got}, expected {want}")
        for k, v in got.items():
            self.launches[k] += v
        return buf.getvalue().strip().splitlines(), wall


def check_phase(torch, card: str, corpus: Path, bundle: Path,
                train: dict) -> dict:
    """Phase 6, checking and migration on the card: ``cli extract-audio``;
    ``cli check --corpus`` on phase 5's checkpoints against the metrics
    their trainers recorded, and the same checks on the CPU; the ``.pt``
    round trip; the wall times at EATD's size.  Every CLI call is counted
    with exact launches.  Returns the launches and the timings."""
    import os

    from icassp2022_depression_tpu_torch.eval import checking
    from icassp2022_depression_tpu_torch.ops import rnn_cuda

    counted = _Counted(torch, rnn_cuda)
    before_env = os.environ.get("ICASSP_ELMO_WEIGHTS")
    # cli predict of a fusion .pt finds the bundle as a user's does
    os.environ["ICASSP_ELMO_WEIGHTS"] = str(bundle)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_check_") as tmp, \
                _reg_fold_cfg(checking, train["reg"]["fold_cfg"]):
            work = Path(tmp)
            xa, sds, clf = extract_audio_checks(counted, card, corpus, work)
            ckpts = check_corpus_checks(counted, card, corpus, bundle, train,
                                        work, sds)
            check_card_vs_cpu(torch, rnn_cuda, corpus, bundle, work, ckpts,
                              xa, sds, clf)
            pt_round_trip(torch, counted, corpus, work, ckpts)
            timing = eatd_size_timing(torch, rnn_cuda, counted, card, bundle,
                                      work)
    finally:
        if before_env is None:
            os.environ.pop("ICASSP_ELMO_WEIGHTS", None)
        else:
            os.environ["ICASSP_ELMO_WEIGHTS"] = before_env
    return dict(timing, launches=counted.launches)


def extract_audio_checks(counted, card: str, corpus: Path, work: Path):
    """``cli extract-audio`` (no kernel of the port): its clf features are
    ``extract_eatd_device``'s bitwise, 3 speakers the CPU's within
    SLICE_TOL; an incremental rerun, twice, marks every speaker 'ok' then
    'cached' and writes the CLI's npz files byte for byte.  Returns the
    host features and the targets."""
    import numpy as np

    from icassp2022_depression_tpu_torch.data import eatd
    from icassp2022_depression_tpu_torch.frontend import audio as afe

    audio_dir = work / "features" / "Features" / "AudioWhole"
    lines, wall = counted(["extract-audio", "--root", corpus, "--out",
                           audio_dir], ZERO, "cli extract-audio")
    print(f"cli extract-audio: {lines[-1]}; wall {wall:.2f} s [{card}]")
    xa = np.load(audio_dir / "whole_samples_clf_256.npz")["arr_0"][:, :, 0]
    fused, sds, clf = afe.extract_eatd_device(corpus, device="cuda")
    if not np.array_equal(xa, fused.cpu().numpy()):
        fail("extract-audio's clf features differ from extract_eatd_device's")
    speakers = eatd.load_speakers(corpus)[:3]
    cpu = afe.extract_batch([w for sp in speakers for w in sp.waveforms],
                            [r for sp in speakers for r in sp.sample_rates],
                            ordinals=range(9), device="cpu").numpy()
    err = float(np.abs(xa[:3].reshape(9, -1) - cpu).max())
    print(f"extract-audio: clf features bitwise equal to "
          f"extract_eatd_device's; 3 speakers card vs CPU max|d| = "
          f"{err:.3e} (tol {SLICE_TOL})")
    if not err <= SLICE_TOL:
        fail(f"extract-audio on the card differs from the CPU: {err}")
    npz = [f"whole_{k}_{t}_256.npz" for k in ("samples", "labels")
           for t in ("reg", "clf")]
    inc = work / "incremental"
    for want in ("ok", "cached"):
        _, _, _, manifest = afe.extract_eatd(corpus, out_dir=inc,
                                             incremental=True, device="cuda")
        status = {m["status"] for m in manifest}
        same = all((inc / f).read_bytes() == (audio_dir / f).read_bytes()
                   for f in npz)
        if status != {want} or not same:
            fail(f"incremental extract_eatd: statuses {status} (want "
                 f"{want}), npz files equal to the CLI's: {same}")
    m_cli = json.loads((audio_dir / "manifest.json").read_text())
    m_inc = json.loads((inc / "manifest.json").read_text())
    if (m_inc["min_len_s"], m_inc["max_len_s"]) != \
            (m_cli["min_len_s"], m_cli["max_len_s"]):
        fail(f"incremental manifest durations {m_inc} vs {m_cli}")
    print(f"extract_eatd incremental=True twice: {len(manifest)} speakers "
          f"'ok' then 'cached', npz files byte-identical to the CLI's, "
          f"answer lengths {m_cli['min_len_s']:.2f}-"
          f"{m_cli['max_len_s']:.2f} s kept")
    return xa, sds, clf


def check_corpus_checks(counted, card: str, corpus: Path, bundle: Path,
                        train: dict, work: Path, sds) -> dict:
    """``cli check --corpus`` on the gated checkpoints of phase 5's ``cli
    train --task audio_clf --corpus`` and ``cli pipeline --track reg
    --corpus`` (the gates open, so each fold saved one): each fold's
    metrics must be the ones its trainer recorded in the sidecar (F1,
    precision and recall within 1e-6; MAE within SLICE_TOL of the largest
    target).  Returns the checkpoints by task."""
    import numpy as np

    from icassp2022_depression_tpu_torch.train import checkpoints

    ckpts = {"audio_clf": [_fold_ckpt(
        corpus / "Model" / "ClassificationWhole" / "Audio",
        f"BiLSTM_gru_vlad256_256_*_{f}.npz") for f in (1, 2, 3)]}
    reg_dir = train["reg"]["root"] / "Model" / "Regression"
    for task, sub in (("audio_reg", "Audio"), ("text_reg", "Text"),
                      ("fuse_reg", "Fuse")):
        ckpts[task] = [_fold_ckpt(reg_dir / f"{sub}{f}", "*.npz")
                       for f in (1, 2, 3)]
    scale = float(np.abs(sds).max())
    for task, paths in ckpts.items():
        lines, wall = counted(
            ["check", "--task", task, "--root", work, "--ckpts", *paths,
             "--corpus", corpus, "--elmo-weights", bundle, "--segmenter",
             "fallback"], check_launches(task, 3 * len(sds)),
            f"cli check --task {task} --corpus")
        rows = [json.loads(line) for line in lines]
        print(f"cli check --task {task} --corpus: {json.dumps(rows)}; wall "
              f"{wall:.2f} s [{card}]")
        worst = 0.0
        for row, path in zip(rows[:-1], paths):
            meta = checkpoints.load_meta(path)
            if task.endswith("clf"):
                d = max(abs(_nan_as_zero(row[k]) - meta[k])
                        for k in ("f1", "precision", "recall"))
                tol = 1e-6
            else:
                d, tol = abs(row["mae"] - meta["mae"]), SLICE_TOL * scale
            worst = max(worst, d)
            if not d <= tol:
                fail(f"check {task} fold {row['fold']}: {row} against the "
                     f"trainer's {meta} (tol {tol})")
        print(f"  {task}: every fold's metrics are its trainer's, max|d| = "
              f"{worst:.3e}")
    return ckpts


def check_card_vs_cpu(torch, rnn_cuda, corpus: Path, bundle: Path,
                      work: Path, ckpts: dict, xa, sds, clf) -> None:
    """Not counted: each task's check on the card and on the CPU on the
    same host features: the same metrics (clf exactly, MAE within
    SLICE_TOL of the largest target), predictions within SLICE_TOL of
    max(1, their largest magnitude).  Writes the text features for the
    ``.pt`` round trip."""
    import numpy as np

    from icassp2022_depression_tpu_torch.data import folds
    from icassp2022_depression_tpu_torch.eval import checking
    from icassp2022_depression_tpu_torch.frontend import text as tfe

    before = _counts(rnn_cuda)
    xt, _, _ = tfe.extract_eatd(
        corpus, out_dir=work / "features" / "Features" / "TextWhole",
        elmo_weights=str(bundle), segmenter="fallback", device="cuda")
    tf_idx = folds.generate_clf_folds(clf, 3, seed=0)
    dep, non = folds.generate_reg_shuffles(sds, seed=0)
    runs = {
        "audio_clf": lambda dev: checking.check_audio_clf(
            xa, clf, tf_idx, ckpts["audio_clf"], device=dev),
        "audio_reg": lambda dev: checking.check_audio_reg(
            xa, sds, dep, non, ckpts["audio_reg"], device=dev),
        "text_reg": lambda dev: checking.check_text_reg(
            xt, sds, dep, non, ckpts["text_reg"], device=dev),
        "fuse_reg": lambda dev: checking.check_fuse_reg(
            xa, xt, sds, dep, non, ckpts["fuse_reg"], device=dev)}
    scale = float(np.abs(sds).max())
    for task, run in runs.items():
        clf_task = task.endswith("clf")
        keys = (("precision", "recall", "f1", "accuracy") if clf_task
                else ("mae", "rmse"))
        d_pred = d_metric = 0.0
        for a, b in zip(run("cuda")[0], run("cpu")[0]):
            ref = max(1.0, float(np.abs(b["predictions"]).max()))
            d = float(np.abs(a["predictions"] - b["predictions"]).max()) / ref
            dm = max(abs(_nan_as_zero(a[k]) - _nan_as_zero(b[k]))
                     for k in keys)
            d_pred, d_metric = max(d_pred, d), max(d_metric, dm)
            if not (d <= SLICE_TOL
                    and dm <= (0.0 if clf_task else SLICE_TOL * scale)):
                fail(f"check {task} fold {a['fold']}, card vs CPU: "
                     f"predictions {d} of max(1, max|CPU|), metrics "
                     f"{[a[k] for k in keys]} vs {[b[k] for k in keys]}")
        print(f"check {task}, card vs CPU: predictions max|d| = "
              f"{d_pred:.3e} of max(1, max|CPU|) (tol {SLICE_TOL}), metrics "
              f"max|d| = {d_metric:.3e}")
    _set_counts(rnn_cuda, before)


def pt_round_trip(torch, counted, corpus: Path, work: Path,
                  ckpts: dict) -> None:
    """Counted: ``cli export-pt`` of fold 1's ``audio_clf`` and
    ``fuse_reg`` checkpoints, then whole-module pickles of the
    reference-layout modules above loaded with the export, in torch's
    zipfile and legacy formats; ``cli check`` (fold 1 from each file, on
    the npz features) and ``cli predict`` (one speaker) must give the
    npz's metrics and outputs within SLICE_TOL."""
    pt = work / "pt"
    pt.mkdir()
    refs = {"audio_clf": RefAudioBiLSTM(), "fuse_reg": RefFusionReg()}
    predict_launches = {"audio_clf": CHECK_FOLD["audio"],
                        "fuse_reg": dict(CHECK_FOLD["fuse"], lstmp_fwd=4)}
    for task, ref in refs.items():
        exported = pt / f"{task}_export.pt"
        lines, _ = counted(["export-pt", "--task", task, "--ckpt",
                            ckpts[task][0], "--out", exported], ZERO,
                           f"cli export-pt --task {task}")
        print(f"cli export-pt --task {task}: {lines[-1]}")
        ref.load_state_dict(torch.load(exported, weights_only=True),
                            strict=True)
        torch.save(ref, pt / f"{task}_module.pt")
        torch.save(ref, pt / f"{task}_module_legacy.pt",
                   _use_new_zipfile_serialization=False)
        base = None
        for first in (ckpts[task][0], exported, pt / f"{task}_module.pt",
                      pt / f"{task}_module_legacy.pt"):
            lines, _ = counted(
                ["check", "--task", task, "--root", work / "features",
                 "--ckpts", first, *ckpts[task][1:]], check_launches(task),
                f"cli check with {first.name}")
            rows = [json.loads(line) for line in lines]
            out, _ = counted(
                ["predict", "--task", task, "--ckpt", first, "--root",
                 corpus, "--speaker", "Data/1", "--segmenter", "fallback"],
                predict_launches[task], f"cli predict {first.name}")
            pred = _output(json.loads(out[-1]))
            if base is None:
                base = (rows, pred)
                continue
            d_rows = _rows_diff(rows, base[0])
            d_pred = max(abs(a - b) for a, b in zip(pred, base[1]))
            print(f"{first.name}: cli check and cli predict against the "
                  f"npz's: metrics max|d| = {d_rows:.3e}, outputs max|d| = "
                  f"{d_pred:.3e} (tol {SLICE_TOL})")
            if not (d_rows <= SLICE_TOL and d_pred <= SLICE_TOL):
                fail(f"{first.name} differs from the npz checkpoint: {rows} "
                     f"{pred} vs {base}")


def eatd_size_timing(torch, rnn_cuda, counted, card: str, bundle: Path,
                     work: Path) -> dict:
    """At EATD's size (a synthetic corpus of 83 + 79 speakers, the JAX
    ``warmup`` defaults): the wall time of ``cli extract-audio`` and of
    ``cli check --task fuse_clf --corpus`` with the seeded bundle and
    seeded full-width checkpoints, both counted; then, not counted, the
    device time of each fold's forward at its test split's rows
    (``torch.profiler``): the three clf folds and one reg fold."""
    import numpy as np

    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import augment, eatd, folds
    from icassp2022_depression_tpu_torch.eval import checking
    from icassp2022_depression_tpu_torch.frontend import text as tfe
    from icassp2022_depression_tpu_torch.models import porting
    from icassp2022_depression_tpu_torch.models.fusion import FusionNet
    from icassp2022_depression_tpu_torch.train import checkpoints

    big = work / "eatd_size"
    t0 = time.perf_counter()
    eatd.make_synthetic_corpus(big, n_data=83, n_validation=79,
                               seconds=(2.0, 12.0), seed=5)
    make_s = time.perf_counter() - t0
    _, extract_s = counted(["extract-audio", "--root", big], ZERO,
                           "cli extract-audio (83 + 79)")
    audio = big / "Features" / "AudioWhole"
    m = json.loads((audio / "manifest.json").read_text())
    print(f"timing cli extract-audio, 83 + 79 speakers (486 answers of "
          f"{m['min_len_s']:.2f}-{m['max_len_s']:.2f} s; corpus written in "
          f"{make_s:.2f} s): {extract_s:.2f} s wall [{card}]")
    fuse_ckpts = [checkpoints.save(
        work / f"fuse_clf_{f}", porting.fusion_tree_from_state_dict(
            FusionNet(C.FUSE_CLF, torch.Generator().manual_seed(20 + f))
            .state_dict(), C.FUSE_CLF)) for f in (1, 2, 3)]
    lines, check_s = counted(
        ["check", "--task", "fuse_clf", "--root", big, "--ckpts",
         *fuse_ckpts, "--corpus", big, "--elmo-weights", bundle,
         "--segmenter", "fallback"], check_launches("fuse_clf", 486),
        "cli check --task fuse_clf --corpus (83 + 79)")
    print(f"timing cli check --task fuse_clf --corpus, 83 + 79 speakers "
          f"(both modalities extracted, seeded full-width checkpoints): "
          f"{check_s:.2f} s wall; {lines[-1]} [{card}]")

    before = _counts(rnn_cuda)
    xa = np.load(audio / "whole_samples_clf_256.npz")["arr_0"][:, :, 0]
    clf = np.load(audio / "whole_labels_clf_256.npz")["arr_0"]
    sds = np.load(audio / "whole_labels_reg_256.npz")["arr_0"]
    xt, _, _ = tfe.extract_eatd(big, elmo_weights=str(bundle),
                                segmenter="fallback", device="cuda")
    dep, non = np.where(clf == 1)[0], np.where(clf == 0)[0]
    forwards = []
    for fold, tr in enumerate(folds.generate_clf_folds(clf, 3, seed=0)):
        _, (xs, y) = augment.augment_classification_fold([xa, xt], clf, tr,
                                                         dep, non)
        forwards.append((f"fuse_clf fold {fold + 1}", xs, len(y),
                         checkpoints.load_model(fuse_ckpts[fold], "fusion",
                                                C.FUSE_CLF, "cuda")))
    rdep, rnon = folds.generate_reg_shuffles(sds, seed=0)
    _, _, te_d, te_n = folds.reg_fold_split(rdep, rnon, 0)
    te = np.concatenate([te_d, te_n])
    forwards.append(("fuse_reg fold 1", [xa[te], xt[te]], len(te),
                     checkpoints.load_model(
                         FusionNet(C.FUSE_REG,
                                   torch.Generator().manual_seed(30)),
                         "fusion", C.FUSE_REG, "cuda")))
    device_us = {}
    for label, xs, rows, model in forwards:
        split = profile_split(
            torch, lambda: checking.fold_forward(model, xs),
            f"check {label} forward ({rows} rows)", 3, card)
        device_us[label] = (rows, None if split is None
                            else split["busy_us"])
    _set_counts(rnn_cuda, before)
    print("timing check fold forwards at EATD's test-split rows, device "
          "time (torch.profiler): " + ", ".join(
              f"{k} ({r} rows) "
              + ("not measured" if us is None else f"{us:.1f} us")
              for k, (r, us) in device_us.items()) + f" [{card}]")
    return {"extract_s": extract_s, "check_s": check_s,
            "device_us": device_us}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["gru", "lstm", "lstmp"],
                    help="gru / lstm / lstmp: build the GRU / LSTM / LSTMP "
                         "kernels, run their checks, profiles and "
                         "yardsticks, and stop (no ok line)")
    args = ap.parse_args(argv)
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
    from icassp2022_depression_tpu_torch.data import eatd
    from icassp2022_depression_tpu_torch.ops import rnn_cuda

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    names = ((f"{args.only}_fwd", f"{args.only}_bwd") if args.only
             else tuple(COUNTERS))
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per source
        libs = list(pool.map(_build.build, names))
    print(f"built {', '.join(so.name for so in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in names:
        print(_build.build_log(name).strip())

    if args.only == "lstmp":
        _, lstmp_times, _ = lstmp_kernel_phase(torch, rnn_cuda, card)
        lstmp_profile_phase(torch, rnn_cuda, card)
        lstmp_summary(card, lstmp_times,
                      library_phase(torch, card, only="lstmp"))
        print(f"timing whole script: {time.perf_counter() - t_start:.1f} s "
              f"[{card}]")
        return 0
    if args.only == "gru":
        kernel_phase(torch, rnn_cuda, card)
        gru_profile_phase(torch, rnn_cuda, card)
        bwd_kernel_phase(torch, rnn_cuda, card)
        bwd_profile_phase(torch, rnn_cuda, card, ("gru",))
        library_phase(torch, card, only="gru")
        print(f"timing whole script: {time.perf_counter() - t_start:.1f} s "
              f"[{card}]")
        return 0
    if args.only == "lstm":
        lstm_kernel_phase(torch, rnn_cuda, card)
        standin_times, cudnn, _ = standin_lstm_phase(torch, rnn_cuda, card)
        lstm_profile_phase(torch, rnn_cuda, card)
        bwd_profile_phase(torch, rnn_cuda, card, ("lstm",))
        library_phase(torch, card, only=("lstm_fwd", "lstm_bwd"))
        standin_summary(card, standin_times, cudnn)
        print(f"timing whole script: {time.perf_counter() - t_start:.1f} s "
              f"[{card}]")
        return 0
    err, kernel_times = kernel_phase(torch, rnn_cuda, card)
    gru_profile_phase(torch, rnn_cuda, card)
    bwd_err, bwd_times = bwd_kernel_phase(torch, rnn_cuda, card)
    lstm_err, lstm_times = lstm_kernel_phase(torch, rnn_cuda, card)
    lstmp_err, lstmp_times, _ = lstmp_kernel_phase(torch, rnn_cuda,
                                                   card)
    lstmp_profile_phase(torch, rnn_cuda, card)
    standin_times, cudnn, standin_err = standin_lstm_phase(torch, rnn_cuda,
                                                           card)
    lstm_profile_phase(torch, rnn_cuda, card)
    bwd_profile_phase(torch, rnn_cuda, card)
    library = library_phase(torch, card)
    lstmp_summary(card, lstmp_times, library)
    standin_summary(card, standin_times, cudnn)
    serve_launches, _ = slice_phase(torch, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_text_") as tmp:
        corpus = Path(tmp) / "corpus"
        eatd.make_synthetic_corpus(corpus, n_data=24, n_validation=12,
                                   seconds=(2.0, 12.0), seed=1)
        corpus_chars = "".join(
            ch for sp in eatd.iter_speakers(corpus, read_text=True)
            for t in sp.texts for ch in t if not ch.isspace())
        t0 = time.perf_counter()
        bundle, chars = seeded_bundle(torch, Path(tmp) / "elmo_zhs_seeded.npz",
                                      corpus_chars)
        print(f"seeded zhs-geometry ELMo bundle {bundle.name}: "
              f"{bundle.stat().st_size / 2**20:.1f} MiB, drawn on the card "
              f"and written in {time.perf_counter() - t0:.2f} s [{card}]")
        launches, train = train_phase(torch, card, corpus, bundle)
        checked = check_phase(torch, card, corpus, bundle, train)
        text_launches, text_latency = text_serving_phase(torch, card, bundle,
                                                         chars)
    standin_launches, _ = standin_serving_phase(torch, card)
    launches["gru_fwd"] += serve_launches
    for k, v in text_launches.items():
        launches[k] += v + standin_launches[k] + checked["launches"][k]
    if launches["lstmp_bwd"] != 0:
        fail(f"a main path launched the LSTMP backward: {launches}")
    if "jax" in sys.modules:
        fail("jax was imported")
    for task, wall in {**train["clf"]["stage_s"],
                       **train["reg"]["stage_s"]}.items():
        print(f"timing pipeline stage {task}: {wall:.2f} s wall [{card}]")
    print(f"timing cli extract-text (108 answers, one batch of 112 rows): "
          f"{train['text']['wall_s']:.2f} s wall [{card}]")
    print(f"timing at 83 + 79 speakers: cli extract-audio "
          f"{checked['extract_s']:.2f} s, cli check --task fuse_clf --corpus "
          f"{checked['check_s']:.2f} s wall [{card}]")
    print(f"timing whole script: {time.perf_counter() - t_start:.1f} s "
          f"[{card}]")

    print_bounds(card, {
        **{("gru_fwd", k): v[0] for k, v in kernel_times.items()},
        **{("gru_bwd", k): v[0] for k, v in bwd_times.items()},
        **{(f"lstm_{d}", k): v[d][0] for k, v in lstm_times.items()
           for d in ("fwd", "bwd")},
        **{("lstm_fwd", k): v[0] for k, v in standin_times.items()},
        **{(f"lstmp_{d}", k): v[d][0] for k, v in lstmp_times.items()
           for d in ("fwd", "bwd")}})
    bounds = kernel_bounds()
    timed = {
        "gru_fwd": (kernel_times[TIMED_SHAPES[0]], err, "gru_fwd"),
        "gru_bwd": (bwd_times[BWD_TIMED[0]], bwd_err, "gru_bwd"),
        "lstm_fwd": (lstm_times[LSTM_TIMED[0]]["fwd"],
                     max(lstm_err["fwd"], standin_err), "lstm_fwd"),
        "lstm_bwd": (lstm_times[LSTM_TIMED[0]]["bwd"], lstm_err["bwd"],
                     "lstm_bwd"),
        "lstmp_fwd": (lstmp_times[LSTMP_TIMED[0]]["fwd"], lstmp_err["fwd"],
                      "lstmp_fwd"),
        "lstmp_bwd": (lstmp_times[LSTMP_TIMED[0]]["bwd"], lstmp_err["bwd"],
                      "lstmp_bwd"),
    }
    src = "icassp2022_depression_tpu_torch/csrc"
    pallas = "icassp2022_depression_tpu/ops/rnn_pallas.py"
    replaces = {"gru_fwd": f"{pallas}:149", "gru_bwd": f"{pallas}:38 (+:174)",
                "lstm_fwd": f"{pallas}:346",
                "lstm_bwd": f"{pallas}:868 (+:377)",
                "lstmp_fwd": f"{pallas}:562", "lstmp_bwd": f"{pallas}:609"}
    entries = []
    for name, ((ms, plain_ms), max_err, lib) in timed.items():
        bound_ms, bound_by = bounds[name]
        entries.append({
            "name": name, "route": "cuda", "source": f"{src}/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library[lib]})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
