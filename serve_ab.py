#!/usr/bin/env python3
"""Warm ``Predictor.predict_batch`` latency of the port's serving on one
GPU, for one or more checkouts of this repository, each in a process of
its own, in the order given (e.g. parent, change, change, parent, to
compare two commits on one card):

    python3 serve_ab.py PARENT_DIR . . PARENT_DIR
    python3 serve_ab.py --task fuse_clf PARENT_DIR . . PARENT_DIR
    python3 serve_ab.py --task text_clf --standin PARENT_DIR . . PARENT_DIR
    python3 serve_ab.py --kernels PARENT_DIR . . PARENT_DIR
    python3 serve_ab.py --steps PARENT_DIR . . PARENT_DIR

Each process imports ``icassp2022_depression_tpu_torch`` from its
checkout, builds that checkout's kernels, writes a synthetic corpus of
8 + 4 speakers (seed 0, answers of 2-12 s) and a full-width checkpoint of
``--task`` (``audio_clf``, the default, ``fuse_clf`` or ``text_clf``) with
seeded random weights, and times ``predict_batch`` at 1 and 8 speakers
with features not cached: 3 warm-up calls, then the median of 20 calls on
the host clock, each ending in a device sync.  The text tasks embed with
a zhs-geometry ELMo bundle that the checkout's ``chip_smoke.seeded_bundle``
draws on the card (the same weights in every checkout), named by
``ICASSP_ELMO_WEIGHTS``, and serve 3 transcripts of 20-120 CJK characters
per speaker from a seeded vocabulary (up to 128 tokens a sentence).
With ``--standin`` they embed with the seeded stand-in encoder instead
(``elmo_weights=None``, the text path of a machine without a bundle), and
the vocabulary is the corpus's characters.
Prints the card's name and power limit, one JSON line per run, then per
checkout the median and quartiles of its runs' latencies, and the largest
difference of the 8 speakers' probabilities between the runs.

``--kernels`` times three of the checkout's recurrence kernels instead,
each with the checkout's own choice of route, on the same seeded inputs
in every checkout: the LSTM forward (``rnn_cuda.lstm_sequence``) at
``LSTM_AB_SHAPES``, the text model's and the stand-in encoder's, the GRU
forward (``gru_sequence``) at ``GRU_AB_SHAPES``, the audio model's, and
the LSTMP backward (``lstmp_sequence_bwd``, fed the plain forward's
residuals) at ``LSTMP_AB_SHAPES``, the zhs geometry's: CUDA events, the
median of 50 calls (10 above 4096 rows x steps; 5 for the LSTMP), after 3
warm-up calls.  Each run also reports the largest difference of each
output from the plain version (relative to its largest magnitude for the
LSTMP) and a digest of its bytes, and the summary says, for each kernel
and shape, whether the checkouts' outputs are bitwise equal.

``--steps`` times an ``audio_clf`` and a ``text_clf`` train step instead,
with the checkout's ``chip_smoke.step_split`` (forward, backward,
optimizer and the whole step, CUDA events between the phases, the median
of 60 steps after 10 warm ones) on the audio features of a synthetic
corpus of 24 + 12 speakers (seed 1) and seeded standard normal text
features of the text model's width, and splits one step (forward and
backward) by kernel name with the checkout's ``chip_smoke.profile_split``
(``torch.profiler``); ``bwd_us`` is the device time of the recurrence's
backward kernels in that step.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPS = 20
#: (T, B, H): the text model's training shapes and one the JAX package
#: would stream (chip_smoke.LSTM_TIMED), then the stand-in encoder's
#: (chip_smoke.STANDIN_LSTM_SHAPES)
LSTM_AB_SHAPES = ((3, 4, 128), (3, 2, 128), (256, 16, 128), (16, 8, 512),
                  (128, 24, 512), (16, 112, 512), (128, 488, 512))
#: (T, B, H): the audio model's serving, training and eval shapes
#: (chip_smoke.TIMED_SHAPES)
GRU_AB_SHAPES = ((3, 8, 256), (3, 24, 256), (3, 100, 256), (3, 200, 256))
#: (T, B, C, P): the zhs biLM's (chip_smoke.LSTMP_TIMED)
LSTMP_AB_SHAPES = ((32, 128, 4096, 512), (16, 8, 4096, 512),
                   (128, 24, 4096, 512))


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def kernel_times(checkout: Path) -> dict:
    """The checkout's LSTM forward, GRU forward and LSTMP backward at
    ``LSTM_AB_SHAPES``, ``GRU_AB_SHAPES`` and ``LSTMP_AB_SHAPES``: for each,
    ``ms_<kernel>_<shape>`` (median of CUDA-event times), ``err_...`` (the
    largest difference from the plain version) and ``digest_...``."""
    sys.path.insert(0, str(checkout))
    import torch

    import icassp2022_depression_tpu_torch as pkg
    from icassp2022_depression_tpu_torch.ops import rnn_cuda

    if Path(pkg.__file__).resolve().parent.parent != checkout.resolve():
        raise RuntimeError(f"imported {pkg.__file__}, not from {checkout}")
    out = {"checkout": str(checkout), "task": "kernels"}

    def run(key, fn, plain, reps, rel=False):
        got = fn()
        got = got if isinstance(got, tuple) else (got,)
        ref = plain()
        ref = ref if isinstance(ref, tuple) else (ref,)
        out[f"err_{key}"] = max(
            ((g - r).abs().max() / (r.abs().max() if rel else 1)).item()
            for g, r in zip(got, ref))
        out[f"digest_{key}"] = _digest(got)
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[f"ms_{key}"] = statistics.median(times)

    gen = torch.Generator().manual_seed(5)
    for gates, shapes, fwd, plain in (
            (4, LSTM_AB_SHAPES, rnn_cuda.lstm_sequence,
             rnn_cuda.lstm_sequence_torch),
            (3, GRU_AB_SHAPES, rnn_cuda.gru_sequence,
             rnn_cuda.gru_sequence_torch)):
        for t, b, h in shapes:
            xp = torch.randn((t, b, gates * h), generator=gen).cuda()
            w = ((torch.rand((h, gates * h), generator=gen) * 2 - 1)
                 * h ** -0.5).cuda()
            bias = ((torch.rand((1, gates * h), generator=gen) * 2 - 1)
                    * h ** -0.5).cuda()
            run(f"{'lstm' if gates == 4 else 'gru'}_fwd_{t}x{b}x{h}",
                lambda: fwd(xp, w, bias), lambda: plain(xp, w, bias),
                50 if t * b <= 4096 else 10)
    for t, b, c, p in LSTMP_AB_SHAPES:
        xp4 = torch.randn((t, b, 4, c), generator=gen)
        w_h = (torch.rand((p, 4, c), generator=gen) * 2 - 1) / p ** 0.5
        b3 = (torch.rand((1, 4, c), generator=gen) * 2 - 1) / p ** 0.5
        w_p = (torch.rand((c, p), generator=gen) * 2 - 1) / c ** 0.5
        fwd_in = tuple(a.cuda() for a in (xp4, w_h, b3, w_p))
        args = (fwd_in + rnn_cuda.lstmp_sequence_torch(*fwd_in)[:3]
                + (torch.randn((t, b, p), generator=gen).cuda(),
                   torch.randn((t, b, c), generator=gen).cuda()))
        run(f"lstmp_bwd_{t}x{b}x{c}x{p}",
            lambda: rnn_cuda.lstmp_sequence_bwd(*args),
            lambda: rnn_cuda.lstmp_sequence_bwd_torch(*args), 5, rel=True)
    return out


#: the recurrence backward's kernels, by the names ``profile_split`` gives
#: them, in ``csrc/gru_bwd.cu`` and ``csrc/lstm_bwd.cu``
BWD_KERNELS = ("gru_bwd_step_kernel", "lstm_bwd_step_kernel", "gates_kernel",
               "dw_kernel", "dw_finish_kernel")


def step_times(checkout: Path) -> dict:
    """The checkout's train step split and profile (``--steps``)."""
    import contextlib
    import importlib.util
    import io

    sys.path.insert(0, str(checkout))
    import torch

    import icassp2022_depression_tpu_torch as pkg
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import eatd, folds
    from icassp2022_depression_tpu_torch.frontend import audio as afe
    from icassp2022_depression_tpu_torch.train import optim, trainers

    if Path(pkg.__file__).resolve().parent.parent != checkout.resolve():
        raise RuntimeError(f"imported {pkg.__file__}, not from {checkout}")
    spec = importlib.util.spec_from_file_location(
        "checkout_chip_smoke", checkout / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="serve_ab_steps_") as tmp:
        corpus = Path(tmp) / "corpus"
        eatd.make_synthetic_corpus(corpus, n_data=24, n_validation=12,
                                   seconds=(2.0, 12.0), seed=1)
        feats, _, clf = afe.extract_eatd_device(corpus, device="cuda")
    train_idx = folds.generate_clf_folds(clf, 3, seed=0)
    xt = torch.randn((feats.shape[0], 3, 1024),
                     generator=torch.Generator().manual_seed(0)).cuda()
    out = {"checkout": str(checkout), "task": "train_steps"}
    for task, tcfg, x, batch in (("audio_clf", C.AUDIO_CLF, feats, 8),
                                 ("text_clf", C.TEXT_CLF, xt, 4)):
        data = trainers._clf_fold_datas([x], clf, train_idx, batch)[0]
        with contextlib.redirect_stdout(io.StringIO()):
            split = smoke.step_split(torch, tcfg, data, "", task)
        model = trainers.init_model(tcfg, 0, 1, "cuda").train()
        opt = optim.build(tcfg.optimizer, model)
        loss_fn = trainers._branch_fns(tcfg)
        # the checkout's dropout stream: a threefry key, or before it a
        # torch generator
        drop = (trainers.dropout_key(0, 1, "cuda")
                if hasattr(trainers, "dropout_key")
                else trainers.dropout_generator(0, 1, "cuda"))

        def fwd_bwd():
            opt.zero_grad(set_to_none=True)
            loss_fn(model(data.train_x[0][0], drop), data.train_y[0],
                    data.train_mask[0]).backward()

        prof = smoke.profile_split(torch, fwd_bwd, f"{task} forward and "
                                   f"backward ({checkout})", 1, "")
        out[task] = {**split, "busy_us": prof and prof["busy_us"],
                     "bwd_us": prof and sum(
                         us for k, (us, _) in prof["kernels"].items()
                         if k in BWD_KERNELS)}
    return out


def _seeded(torch, cls, cfg, seed: int):
    """A ``cls`` model with weights drawn from ``seed`` through the
    checkout's API: a threefry key, or before it a torch generator."""
    from icassp2022_depression_tpu_torch.ops import prng

    try:
        return cls(cfg, key=prng.prng_key(seed))
    except TypeError:
        return cls(cfg, generator=torch.Generator().manual_seed(seed))


def _checkpoint(torch, task: str, tmp: Path, chars: str, standin: bool):
    """A full-width ``task`` checkpoint with seeded weights; for the text
    tasks also the characters to draw transcripts from, and unless
    ``standin``, the seeded bundle (set as ``ICASSP_ELMO_WEIGHTS``) whose
    lexicon holds them."""
    import os

    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.models import porting
    from icassp2022_depression_tpu_torch.models.audio_net import AudioNet
    from icassp2022_depression_tpu_torch.models.fusion import FusionNet
    from icassp2022_depression_tpu_torch.models.text_net import TextNet
    from icassp2022_depression_tpu_torch.train import checkpoints

    if task == "audio_clf":
        cfg = C.AUDIO_CLF.model
        model = _seeded(torch, AudioNet, cfg, 0)
        return checkpoints.save(
            tmp / task,
            porting.audio_net_tree_from_state_dict(model.state_dict(), cfg),
            {"task": task}), None
    if standin:
        lexicon = sorted(set(chars))
        meta = {"task": task, "text_embedder": "prng:seed=0",
                "text_segmenter": "fallback"}
    else:
        import chip_smoke

        bundle, lexicon = chip_smoke.seeded_bundle(
            torch, tmp / "elmo_zhs_seeded.npz", chars)
        os.environ["ICASSP_ELMO_WEIGHTS"] = str(bundle)
        meta = {"task": task, "text_embedder": chip_smoke.bundle_id(bundle),
                "text_segmenter": "fallback"}
    if task == "fuse_clf":
        tree = porting.fusion_tree_from_state_dict(
            _seeded(torch, FusionNet, C.FUSE_CLF, 6).state_dict(), C.FUSE_CLF)
    else:
        tree = porting.text_net_tree_from_state_dict(
            _seeded(torch, TextNet, C.TEXT_CLF.model, 6).state_dict(),
            C.TEXT_CLF.model)
    return checkpoints.save(tmp / task, tree, meta), lexicon


def one(checkout: Path, task: str, standin: bool) -> dict:
    sys.path.insert(0, str(checkout))
    import contextlib
    import io

    import numpy as np
    import torch

    import icassp2022_depression_tpu_torch as pkg
    from icassp2022_depression_tpu_torch.data import eatd
    from icassp2022_depression_tpu_torch.serving.predictors import Predictor

    if Path(pkg.__file__).resolve().parent.parent != checkout.resolve():
        raise RuntimeError(f"imported {pkg.__file__}, not from {checkout}")
    out = {"checkout": str(checkout), "task": task, "standin": standin}
    with tempfile.TemporaryDirectory(prefix="serve_ab_") as tmp:
        root = Path(tmp) / "corpus"
        eatd.make_synthetic_corpus(root, n_data=8, n_validation=4,
                                   seconds=(2.0, 12.0), seed=0)
        chars = "".join(ch for sp in eatd.iter_speakers(root, read_text=True)
                        for t in sp.texts for ch in t if not ch.isspace())
        ckpt, lexicon = _checkpoint(torch, task, Path(tmp), chars, standin)
        speakers = list(eatd.iter_speakers(root, read_text=False))
        kw = {"elmo_weights": None} if standin else {}
        with contextlib.redirect_stderr(io.StringIO()):
            predictor = Predictor.from_checkpoint(ckpt, task, device="cuda",
                                                  feature_cache_entries=0,
                                                  **kw)
        rng = np.random.default_rng(7)
        for n in (1, 8):
            req = ([s.waveforms for s in speakers[:n]],
                   [s.sample_rates for s in speakers[:n]])
            if task == "text_clf":
                req = (None, None)
            if lexicon is not None:
                req += ([["".join(rng.choice(lexicon,
                                             int(rng.integers(20, 121))))
                          for _ in range(3)] for _ in range(n)],)
            for _ in range(3):
                res = predictor.predict_batch(*req)
            times = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                predictor.predict_batch(*req)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out[f"ms_{n}"] = statistics.median(times)
            out[f"min_ms_{n}"] = min(times)
        out["probs_8"] = [r["probs"] for r in res]
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(Path(argv[1]), argv[2], argv[3] == "standin")))
        return 0
    if argv[:1] == ["--one-kernels"]:
        print(json.dumps(kernel_times(Path(argv[1]))))
        return 0
    if argv[:1] == ["--one-steps"]:
        print(json.dumps(step_times(Path(argv[1]))))
        return 0
    kernels = argv[:1] == ["--kernels"]
    steps = argv[:1] == ["--steps"]
    argv = argv[1:] if kernels or steps else argv
    task = "audio_clf"
    if argv[:1] == ["--task"]:
        task, argv = argv[1], argv[2:]
    standin = argv[:1] == ["--standin"]
    argv = argv[1:] if standin else argv
    if task not in ("audio_clf", "fuse_clf", "text_clf") or (
            standin and task == "audio_clf"):
        print(f"serve_ab: unknown task {task}, or --standin without a text "
              f"task", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available() or not argv:
        print("serve_ab: needs a CUDA card and at least one checkout",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    runs = []
    for checkout in argv:
        cmd = (["--one-kernels", checkout] if kernels else
               ["--one-steps", checkout] if steps else
               ["--one", checkout, task, "standin" if standin else "bundle"])
        proc = subprocess.run([sys.executable, __file__, *cmd],
                              capture_output=True, text=True, check=True)
        lines = proc.stdout.strip().splitlines()
        if steps:   # the profile lines
            print("\n".join(lines[:-1]))
        runs.append(json.loads(lines[-1]))
        r = runs[-1]
        print(json.dumps({k: v for k, v in r.items() if k != "probs_8"}
                         | {"card": card}))
    if steps:
        for checkout in dict.fromkeys(argv):
            mine = [r for r in runs if r["checkout"] == checkout]
            print(json.dumps({"checkout": checkout, "task": "train_steps",
                              "runs": len(mine), "card": card} | {
                task: {k: statistics.median(r[task][k] for r in mine)
                       for k in mine[0][task]
                       if all(r[task][k] is not None for r in mine)}
                for task in ("audio_clf", "text_clf")}))
        return 0
    if kernels:
        for checkout in dict.fromkeys(argv):
            mine = [r for r in runs if r["checkout"] == checkout]
            print(json.dumps({"checkout": checkout, "task": "kernels",
                              "runs": len(mine), "card": card} | {
                k: statistics.median(r[k] for r in mine)
                for k in mine[0] if k.startswith(("ms_", "err_"))}))
        keys = [k for k in runs[0] if k.startswith("digest_")]
        print(json.dumps({"bitwise_equal_across_runs": {
            k[len("digest_"):]: len({r.get(k) for r in runs}) == 1
            for k in keys}}))
        return 0
    for checkout in dict.fromkeys(argv):
        mine = [r for r in runs if r["checkout"] == checkout]
        summary = {"checkout": checkout, "task": task, "standin": standin,
                   "runs": len(mine), "card": card}
        for n in (1, 8):
            ms = sorted(r[f"ms_{n}"] for r in mine)
            summary[f"median_ms_{n}"] = statistics.median(ms)
            if len(ms) > 1:
                q = statistics.quantiles(ms, n=4)
                summary[f"quartiles_ms_{n}"] = [q[0], q[2]]
        print(json.dumps(summary))
    worst = max(abs(a - b) for r in runs
                for pa, pb in zip(r["probs_8"], runs[0]["probs_8"])
                for a, b in zip(pa, pb))
    print(f"max |dprob| of the 8 speakers across checkouts: {worst:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
