#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``icassp2022_depression_tpu_torch``)
on one NVIDIA GPU: the serving path and the training path of the audio
models at full width.

    python3 chip_smoke.py

Phases (each raises on failure, so the exit code is nonzero):

1. setup: require CUDA, print the card's name and power limit, turn TF32
   off, build both GRU kernels from ``icassp2022_depression_tpu_torch/csrc``
   with ``nvcc`` (one compiler process per source, started together) and
   print the build time and the compiler's reports;
2. kernels: the CUDA GRU forward against its plain PyTorch version at the
   shapes of the serving path and one ragged shape (max |diff| <= 1e-5),
   the CUDA GRU backward against its plain version at the training shapes,
   a ragged shape and (T, B, H) = (256, 16, 256), a shape the JAX package
   would stream (max |d dxp| <= 1e-5; dw and db within 1e-5 of their
   largest magnitude), both timed with CUDA events; the forward wrapper
   must refuse a CUDA input that requires grad;
3. serving: a synthetic EATD corpus, a full-width ``audio_clf`` with seeded
   random weights saved as a JAX-layout npz, ``cli predict`` for one
   speaker and ``Predictor.predict_batch`` for 1, 3 and 8 speakers.  The
   forward kernel must launch twice (two layers) per forward; outputs must
   be finite probabilities equal (1e-5) to a comparison run whose forward
   uses the plain recurrence, and the ``cli predict`` speaker must agree
   with the same predictor run on the CPU;
4. training: a synthetic corpus of 24 + 12 speakers; ``cli train --task
   audio_clf --corpus`` with the full recipe (170 epochs, 3 folds), then
   ``train_audio_reg`` (120 epochs) on the same features.  Each run must
   launch the backward kernel exactly twice per optimizer step (two
   layers), the forward kernel twice per step and twice per epoch's eval,
   log finite metrics, and write its artifacts for every fold its gate
   passed.  Comparisons, not counted: a 5-epoch ``audio_clf`` fold and a
   5-epoch ``audio_reg`` fold with dropout through the kernels against the
   plain recurrence on the card, and the ``audio_clf`` fold with dropout 0
   against the CPU (per-step losses within 1e-5, relative to the largest
   loss for the L1 loss on SDS scores; final params within 1e-5 of the
   largest |param|);
5. timing: warm ``predict_batch`` latency at 1 and 8 speakers; the wall
   time of the 3-fold recipe; a train step split into forward, backward
   and optimizer.

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
TRAIN_TOL = 1e-5
COMPARE_EPOCHS = 5


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


def _expect_launches(rnn_cuda, steps: int, evals: int, what: str) -> None:
    """Two layers: one forward per layer per step and per eval, one
    backward per layer per step."""
    fwd, bwd = rnn_cuda.LAUNCHES, rnn_cuda.BWD_LAUNCHES
    print(f"{what}: {steps} optimizer steps, {evals} evals; kernel launches "
          f"gru_fwd {fwd}, gru_bwd {bwd}")
    if bwd != 2 * steps:
        fail(f"{what} launched the backward kernel {bwd} times, expected "
             f"{2 * steps} (two layers x {steps} steps)")
    if fwd != 2 * (steps + evals):
        fail(f"{what} launched the forward kernel {fwd} times, expected "
             f"{2 * (steps + evals)}")


def _check_logs(results, what: str) -> None:
    for r in results:
        for k, v in r["logs"].items():
            if not all(map(_finite, v.tolist())):
                fail(f"{what} fold {r['fold']}: non-finite {k}")


def _fold_run(torch, tcfg, data, device):
    """One fold through the trainers' own pieces; returns the per-step
    losses and the final params."""
    from icassp2022_depression_tpu_torch.train import loop, optim, trainers

    model = trainers.init_model(tcfg, 0, 1, device)
    opt = optim.build(tcfg.optimizer, model)
    _, _, step_losses = loop.run_fold(
        model, opt, trainers._branch_fns(tcfg), data, tcfg.track,
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


def step_split(torch, tcfg, data, card: str, steps: int = 60) -> dict:
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
    print(f"timing audio_clf train step (batch {data.train_y.shape[1]}): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
          + f" (median of {steps}, CUDA events between phases) [{card}]")
    return split


def train_phase(torch, card: str):
    """The training path, counted, then the comparisons and timings."""
    from icassp2022_depression_tpu_torch import cli
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import eatd, folds
    from icassp2022_depression_tpu_torch.frontend import audio as afe
    from icassp2022_depression_tpu_torch.ops import rnn_cuda
    from icassp2022_depression_tpu_torch.train import checkpoints, trainers

    launches = {"gru_fwd": 0, "gru_bwd": 0}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        root = Path(tmp) / "corpus"
        eatd.make_synthetic_corpus(root, n_data=24, n_validation=12,
                                   seconds=(2.0, 12.0), seed=1)

        # -- main path 1: cli train --task audio_clf --corpus, counted ----
        rnn_cuda.LAUNCHES = rnn_cuda.BWD_LAUNCHES = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["train", "--task", "audio_clf", "--root",
                           str(root), "--corpus", str(root), "--device",
                           "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"cli train returned {rc}")
        print(buf.getvalue().strip())
        records = [json.loads(line) for line in
                   (root / "Model" / "audio_clf_metrics.jsonl")
                   .read_text().splitlines()]
        epochs = [r for r in records if r["event"] == "epoch"]
        bests = [r for r in records if r["event"] == "fold_best"]
        if len(bests) != 3 or len(epochs) != 3 * (C.AUDIO_CLF.epochs - 1):
            fail(f"the metrics jsonl holds {len(epochs)} epochs and "
                 f"{len(bests)} fold results")
        for r in epochs:
            if not all(_finite(r[k]) for k in ("loss", "f1", "accuracy",
                                               "train_correct")):
                fail(f"non-finite metrics logged: {r}")
        _expect_launches(rnn_cuda, int(sum(r["steps"] for r in epochs)),
                         len(epochs), f"cli train audio_clf (3 folds x "
                                      f"{C.AUDIO_CLF.epochs - 1} epochs)")
        launches["gru_fwd"] += rnn_cuda.LAUNCHES
        launches["gru_bwd"] += rnn_cuda.BWD_LAUNCHES
        out = root / "Model" / "ClassificationWhole" / "Audio"
        gated = [r for r in bests if r["epoch"] >= 0]
        for r in gated:
            name = checkpoints.audio_clf_name(256, 256, r["f1"], r["fold"])
            for f in (f"{name}.npz", f"{name}.json",
                      "train_idxs_{:.2f}_{}.npy".format(r["f1"], r["fold"])):
                if not (out / f).is_file():
                    fail(f"gated fold {r['fold']} wrote no {f}")
        print(f"cli train audio_clf: {len(gated)} of 3 folds gated, their "
              f"npz, sidecar and train-idx files written; wall {wall:.2f} s "
              f"(extraction + 3 folds) [{card}]")

        t0 = time.perf_counter()
        feats, sds, clf = afe.extract_eatd_device(root, device="cuda")
        torch.cuda.synchronize()
        extract_s = time.perf_counter() - t0
        print(f"extract_eatd_device: {feats.shape[0]} speakers "
              f"({int(clf.sum())} depressed), {extract_s:.2f} s warm "
              f"[{card}]")

        # -- main path 2: train_audio_reg, counted ------------------------
        cut = C.FoldConfig.sds_threshold
        n_dep, n_non = int((sds >= cut).sum()), int((sds < cut).sum())
        fold_cfg = C.FoldConfig(reg_test_dep=n_dep // 3,
                                reg_test_non=n_non // 3)
        dep, non = folds.generate_reg_shuffles(sds, seed=0)
        rnn_cuda.LAUNCHES = rnn_cuda.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        reg = trainers.train_audio_reg(feats, sds, dep, non,
                                       out_dir=Path(tmp) / "Regression",
                                       fold_cfg=fold_cfg)
        torch.cuda.synchronize()
        reg_wall = time.perf_counter() - t0
        _check_logs(reg, "train_audio_reg")
        _expect_launches(
            rnn_cuda, int(sum(r["logs"]["steps"].sum() for r in reg)),
            sum(len(r["logs"]["mae"]) for r in reg),
            f"train_audio_reg (3 folds x {C.AUDIO_REG.epochs - 1} epochs, test "
            f"{fold_cfg.reg_test_dep}+{fold_cfg.reg_test_non} speakers)")
        launches["gru_fwd"] += rnn_cuda.LAUNCHES
        launches["gru_bwd"] += rnn_cuda.BWD_LAUNCHES
        for r in reg:
            best = {k: round(v, 4) for k, v in r["best"].items()
                    if k != "params"}
            print(f"train_audio_reg fold {r['fold']}: {best}")
        reg_gated = trainers._gated(reg)
        for r in reg_gated:
            name = checkpoints.audio_reg_name(256, 256, r["best"]["mae"])
            for f in (f"{name}.npz", f"{name}.json"):
                if not (Path(tmp) / "Regression" / f"Audio{r['fold']}"
                        / f).is_file():
                    fail(f"gated reg fold {r['fold']} wrote no {f}")
        print(f"train_audio_reg: {len(reg_gated)} of 3 folds gated"
              + (", their npz and sidecar written" if reg_gated else
                 " (the gated save is held by tests/test_torch_train.py)")
              + f"; wall {reg_wall:.2f} s [{card}]")

        # -- comparisons, not counted --------------------------------------
        counted = (rnn_cuda.LAUNCHES, rnn_cuda.BWD_LAUNCHES)
        train_idx = folds.generate_clf_folds(clf, 3, seed=0)
        data = trainers._clf_fold_datas([feats], clf, train_idx, 8)[0]
        base = C.replace(C.AUDIO_CLF, epochs=COMPARE_EPOCHS + 1)
        plain = C.replace(base, model=C.replace(base.model,
                                                rnn_backend="torch"))
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
        kernel_run = runs[COMPARE_EPOCHS]
        before = (rnn_cuda.LAUNCHES, rnn_cuda.BWD_LAUNCHES)
        plain_run = _fold_run(torch, plain, data, "cuda")
        if (rnn_cuda.LAUNCHES, rnn_cuda.BWD_LAUNCHES) != before:
            fail("the plain recurrence launched a kernel")
        cmp_kernel = _compare_runs(kernel_run, plain_run,
                                   f"{COMPARE_EPOCHS}-epoch audio_clf fold, "
                                   "dropout 0.5, kernels vs plain recurrence "
                                   "on the card")
        no_drop = C.replace(base, model=C.replace(base.model, dropout=0.0))
        cpu_data = trainers._clf_fold_datas([feats.cpu()], clf, train_idx,
                                            8)[0]
        cmp_cpu = _compare_runs(_fold_run(torch, no_drop, data, "cuda"),
                                _fold_run(torch, no_drop, cpu_data, "cpu"),
                                f"{COMPARE_EPOCHS}-epoch audio_clf fold, "
                                "dropout 0, card vs CPU")
        # the regression recipe: batch 2, sum pooling, ReLU head, Adam, L1
        reg_data = trainers._reg_fold_datas(
            [feats], sds, dep, non, C.AUDIO_REG.batch_size, fold_cfg)[0]
        reg_base = C.replace(C.AUDIO_REG, epochs=COMPARE_EPOCHS + 1)
        reg_plain = C.replace(reg_base, model=C.replace(
            reg_base.model, rnn_backend="torch"))
        reg_kernel_run = _fold_run(torch, reg_base, reg_data, "cuda")
        before = (rnn_cuda.LAUNCHES, rnn_cuda.BWD_LAUNCHES)
        reg_plain_run = _fold_run(torch, reg_plain, reg_data, "cuda")
        if (rnn_cuda.LAUNCHES, rnn_cuda.BWD_LAUNCHES) != before:
            fail("the plain recurrence launched a kernel")
        cmp_reg = _compare_runs(
            reg_kernel_run, reg_plain_run,
            f"{COMPARE_EPOCHS}-epoch audio_reg fold, dropout 0.5, kernels vs "
            "plain recurrence on the card",
            loss_scale=max(1.0, float(abs(reg_plain_run[0]).max())))
        split = step_split(torch, C.AUDIO_CLF, data, card)
        rnn_cuda.LAUNCHES, rnn_cuda.BWD_LAUNCHES = counted
    return launches, {"clf_wall_s": wall, "extract_s": extract_s,
                      "reg_wall_s": reg_wall, "split": split,
                      "cmp_kernel": cmp_kernel, "cmp_cpu": cmp_cpu,
                      "cmp_reg": cmp_reg}


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

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    names = ("gru_fwd", "gru_bwd")
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per source
        libs = list(pool.map(_build.build, names))
    print(f"built {', '.join(so.name for so in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in names:
        print(_build.build_log(name).strip())

    err, kernel_times = kernel_phase(torch, rnn_cuda, card)
    bwd_err, bwd_times = bwd_kernel_phase(torch, rnn_cuda, card)
    serve_launches, _ = slice_phase(torch, card)
    launches, _ = train_phase(torch, card)
    launches["gru_fwd"] += serve_launches
    if "jax" in sys.modules:
        fail("jax was imported")

    ms, plain_ms = kernel_times[(3, 8, 256)]
    bwd_ms, bwd_plain_ms = bwd_times[(3, 8, 256)]
    src = "icassp2022_depression_tpu_torch/csrc"
    print(json.dumps({"kernels": [
        {"name": "gru_fwd", "route": "cuda", "source": f"{src}/gru_fwd.cu",
         "replaces": "icassp2022_depression_tpu/ops/rnn_pallas.py:149",
         "launches": launches["gru_fwd"], "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms},
        {"name": "gru_bwd", "route": "cuda", "source": f"{src}/gru_bwd.cu",
         "replaces": "icassp2022_depression_tpu/ops/rnn_pallas.py:38 "
                     "(+:174)",
         "launches": launches["gru_bwd"], "max_abs_err": bwd_err,
         "ms": bwd_ms, "plain_ms": bwd_plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
