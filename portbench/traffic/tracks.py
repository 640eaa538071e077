"""Whole training tracks through the public trainer,
``trainers.train_audio_clf(..., vmap_folds=True)``: all folds as one
stacked program, an epoch one CUDA graph, the gate every epoch, gated
checkpoints saved under ``TMPDIR``.

Corpus: ``speakers`` speakers of 3 answers, ``depressed`` of them
labelled 1 at places drawn from the seed, features drawn from the seed on
the card; the folds a stratified split drawn from the seed; each fold's
initial weights drawn from the seed and handed to the trainer
(``init_params_per_fold``).

Set-up: one track of ``warm_epochs`` epochs at the cell's shapes.  Window
(``--trace 0``): tracks of the recipe's epochs back to back; the next one
starts only while the time so far plus the last track's wall stays
within ``--seconds``, and at least one runs.  ``train_samples_per_s`` is
the training rows stepped (valid rows of every fold, every epoch) over
the tracks' wall.  ``--trace 1``: one track, of which ``trace_epochs``
replayed epochs (after the first ``trace_after``) run under the profiler:
the steady state of the fold loop, without the track's fixed costs
(planning, capture, checkpoints), which only the end-to-end rate sees.

Check, on the window's first track: its first epoch in every fold, by
the plain fold recipe (:mod:`..reference.fold_recipe`) from the same
initial weights, features and dropout stream: the step losses and the
logged loss sum (``loss_rel``), the first gradient's norm as the
optimizer holds it after one step (``grad_rel``, read from one eager step
of the trainer's own fold program on copies of its state, before the
first epoch), the norm of the parameters' change over the epoch
(``change_rel``), each by the worst parameter; the epoch's logged train
rows classified right and test confusion (``count_gap``); and the gated
epoch and F1 of every fold against the published gate run over the
track's logged epochs (``gate_gap``).
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from icassp2022_depression_tpu_torch import config as C
from icassp2022_depression_tpu_torch.models.audio_net import AudioNet
from icassp2022_depression_tpu_torch.ops import rnn_cuda
from icassp2022_depression_tpu_torch.train import loop, trainers
from portbench.counts import flops as F
from portbench.counts.peaks import bound_s
from portbench.harness import card, weights
from portbench.harness import trace as tr
from portbench.harness.cell import Cell, Compared, Context, Run, run_dir
from portbench.reference import fold_recipe


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def trainer_config(cfg: dict, epochs: int):
    r = cfg["recipe"]
    return C.TrainerConfig(
        model=C.RNNConfig(**cfg["model"]),
        optimizer=C.OptimizerConfig(**r["optimizer"]),
        gate=C.GateConfig(**r["gate"]), batch_size=r["batch_size"],
        epochs=epochs, loss=r["loss"], track=r["track"])


def _work(cfg: dict, n_train, n_test, epochs: int) -> dict:
    """Useful operations and the GRU kernels' least time of ``epochs``
    epochs, from the folds' valid rows."""
    m = cfg["model"]
    b, h, layers = cfg["recipe"]["batch_size"], m["hidden_dims"], \
        m["rnn_layers"]
    steps = max(-(-n // b) for n in n_train)
    fwd_row = F.audio_clf(1, m)
    flops = epochs * (3 * fwd_row * sum(n_train) + fwd_row * sum(n_test))
    gru = 0.0
    for i in range(steps):
        rows = [max(0, min(b, n - i * b)) for n in n_train]
        for launch in (F.gru_launch, F.gru_bwd_launch):
            parts = [launch(3, r, h) for r in rows if r]
            gru += layers * bound_s(sum(p[0] for p in parts),
                                    sum(p[1] for p in parts))
    parts = [F.gru_launch(3, r, h) for r in n_test]
    gru += layers * bound_s(sum(p[0] for p in parts),
                            sum(p[1] for p in parts))
    return {"steps": steps * epochs, "flops": flops,
            "bound_s": {"gru": gru * epochs}}


def _first_gradient(fold_run, b1: float) -> dict:
    """One eager step of the fold program on copies of its state ->
    {name: [F, ...] first gradient as the optimizer holds it (its first
    moment over ``1 - b1``)}; the state is then put back."""
    state = fold_run.state_tensors()
    saved = [t.detach().clone() for t in state]
    model, opt = fold_run.model, fold_run.optimizer
    model.train()
    opt.zero_grad(set_to_none=True)
    sub = fold_run._split_key()
    xs, y, mask, rows = fold_run._batch(0)
    loss, _ = fold_run.train_loss(xs, y, mask, sub, rows)
    (loss.sum() if fold_run.folded else loss).backward()
    if fold_run.folded:
        opt.step(fold_run.active[0])
    else:
        opt.step()
    grad = {n: opt.state[p]["exp_avg"] / (1.0 - b1)
            for n, p in model.named_parameters()}
    grad = {n: g.detach().clone() for n, g in grad.items()}
    opt.zero_grad(set_to_none=True)
    with torch.no_grad():
        for t, s in zip(state, saved):
            t.copy_(s)
    return grad


def _probed(replay, b1: float, seen: dict):
    """``FoldRun.run`` for one track: the first call reads the first
    gradient, runs the first epoch alone and keeps the parameters after
    it in ``seen``, then runs the rest."""
    def run(self, n):
        if seen or n <= 0:
            return replay(self, n)
        seen["grad"] = _first_gradient(self, b1)
        replay(self, 1)
        seen["params"] = {k: v.detach().clone()
                          for k, v in self.model.named_parameters()}
        replay(self, n - 1)
    return run


def run(cell: Cell) -> Run:
    cfg, mix, dev = cell.config, cell.traffic, cell.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(cell.seed)
    rng = np.random.default_rng(cell.seed)
    n, d = int(mix["speakers"]), int(cfg["model"]["embedding_size"])
    targets = np.zeros(n, np.int64)
    targets[rng.choice(n, int(mix["depressed"]), replace=False)] = 1
    folds = fold_recipe.stratified_folds(targets, int(mix["folds"]), rng)
    feats = torch.randn((n, 3, d), generator=gen, device=dev)
    shapes = {k: tuple(v.shape) for k, v in
              AudioNet(C.RNNConfig(**cfg["model"]), None).state_dict().items()}
    inits = [weights.draw(weights.state_specs(shapes), gen, dev)
             for _ in folds]
    n_train = [len(fold_recipe.train_rows(targets, f)[0]) for f in folds]
    # a depressed test speaker counts 4 orders of its answers
    n_test = [int(n - len(f) + 3 * targets[np.setdiff1d(np.arange(n), f)]
                  .sum()) for f in folds]
    out_dir = run_dir("checkpoints")
    epochs = int(cfg["recipe"]["epochs"])

    def track(n_epochs: int):
        t0 = time.perf_counter()
        res = trainers.train_audio_clf(
            feats, targets, folds, trainer_config(cfg, n_epochs),
            out_dir=out_dir, seed=cell.seed, device=dev,
            init_params_per_fold=inits, vmap_folds=True)
        _sync(dev)
        return res, time.perf_counter() - t0

    track(int(mix["warm_epochs"]))
    setup_s = time.perf_counter() - cell.started
    launches0 = rnn_cuda.launch_counts()
    tracks, context = [], None
    replay, seen = loop.FoldRun.run, {}
    probed = _probed(replay, float(cfg["recipe"]["optimizer"]["b1"]), seen)
    if cell.trace:
        traces, e = [], int(mix["trace_epochs"])

        def traced(self, n):
            """The track's epochs, ``trace_epochs`` of them under the
            profiler once ``trace_after`` have replayed: a device gap in
            there is one between the nodes of the epoch's graph."""
            skip = min(n, int(mix["trace_after"]))
            probed(self, skip)
            m = min(e, n - skip)

            def replays():
                with torch.profiler.record_function(
                        "portbench/graph_replays"):
                    replay(self, m)
                    _sync(dev)

            traces.append(tr.profile(replays))
            replay(self, n - skip - m)

        loop.FoldRun.run = traced
        try:
            tracks.append(track(epochs))
        finally:
            loop.FoldRun.run = replay
        trace = traces[0]
        context = Context(mix["family"], cfg, trace,
                          _work(cfg, n_train, n_test, e))
        window_s, run_epochs = trace.window_s, epochs
    else:
        t_start = time.perf_counter()
        while True:
            loop.FoldRun.run = probed
            try:
                tracks.append(track(epochs))
            finally:
                loop.FoldRun.run = replay
            spent = time.perf_counter() - t_start
            if spent + tracks[-1][1] > cell.seconds:
                break
        window_s, run_epochs = time.perf_counter() - t_start, epochs
    memory_peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    run = Run(attempted=len(tracks), failed=0,
              memory_peak_bytes=memory_peak, context=context)
    rows = sum(n_train) * (run_epochs - 1) * len(tracks)
    if not cell.trace:
        run.metrics["train_samples_per_s"] = (
            rows / sum(w for _, w in tracks), "samples/s")
        run.metrics["setup_s"] = (setup_s, "s")
    b = cfg["recipe"]["batch_size"]
    steps = max(-(-k // b) for k in n_train) * (run_epochs - 1)
    launches = rnn_cuda.launch_counts()
    first = tracks[0][0]
    run.notes += [
        f"portbench: cell {cell.name} seed {cell.seed} device {dev}: "
        f"{len(tracks)} track(s) of {run_epochs} epochs, {steps} stacked "
        f"steps and {rows} training rows, walls "
        f"{[w for _, w in tracks]!r} s, window {window_s!r} s, setup "
        f"{setup_s!r} s",
        f"portbench: folds' train rows {n_train}, test rows {n_test}, gated "
        f"epochs {[r['best']['epoch'] for r in first]}",
        "portbench: kernel launches in the window: " + ", ".join(
            f"{k} {launches[k] - launches0[k]}" for k in launches
            if launches[k] != launches0[k]),
        f"portbench: peak device memory {memory_peak} bytes"]
    if dev == "cuda":
        run.notes.append(f"portbench: card {card.smi()}")

    got = [_logged(r) for r in first]
    seen = {k: {n: v.cpu() for n, v in d.items()} for k, d in seen.items()}
    del tracks, first
    gc.collect()
    limits = cell.workload["limits"]
    gate_gap = sum(
        fold_recipe.gate(g["f1"], g["train_correct"], n_train[i],
                         cfg["recipe"]["gate"]) != g["gated"]
        for i, g in enumerate(got))

    def reference(prec):
        return [fold_recipe.first_epoch(
            feats, targets, f, weights.to_host(inits[i]), _recipe(cfg),
            cfg["model"], cell.seed, i + 1, prec)
            for i, f in enumerate(folds)]

    t_ref = time.perf_counter()
    want = reference("fp32")
    run.notes.append(f"portbench: the reference took "
                     f"{time.perf_counter() - t_ref!r} s")
    prog = [{"losses": g["losses"], "loss_sum": g["loss_sum"],
             "train_correct": g["train_correct"][0],
             "accuracy": g["accuracy"], "recall": g["recall"],
             "grad": {n: float(torch.linalg.vector_norm(v[i]))
                      for n, v in seen["grad"].items()},
             "change": {n: float(torch.linalg.vector_norm(
                 v[i] - inits[i][n].cpu()))
                 for n, v in seen["params"].items()}}
            for i, g in enumerate(got)]
    for name, value in _numbers(prog, want).items():
        run.compared.append(Compared(name, value, float(limits[name])))
    run.compared.append(Compared("gate_gap", float(gate_gap),
                                 float(limits["gate_gap"])))
    if cell.control:
        low = reference("tf32")
        low = [dict(w, loss_sum=sum(w["losses"])) for w in low]
        for name, value in _numbers(low, want).items():
            run.control.append(Compared(name, value, float(limits[name])))
    return run


def _logged(r: dict) -> dict:
    """A fold's first-epoch log row and its track's gate, from the
    trainer's results; the test confusion worked out from the logged
    accuracy and recall."""
    logs = r["logs"]
    return {"losses": [float(x) for x in r["step_losses"][0]],
            "loss_sum": float(logs["loss"][0]),
            "train_correct": [float(x) for x in logs["train_correct"]],
            "f1": [float(x) for x in logs["f1"]],
            "accuracy": float(logs["accuracy"][0]),
            "recall": float(logs["recall"][0]),
            "gated": (int(r["best"]["epoch"]), float(r["best"]["f1"]))}


def _confusion(logged: dict, want: dict) -> dict:
    """(tp, tn) from a logged accuracy and recall over the reference's
    test rows and positives."""
    tp = round(logged["recall"] * want["test_pos"])
    return {"tp": tp,
            "tn": round(logged["accuracy"] * want["test_rows"]) - tp}


def _numbers(prog: list, want: list) -> dict:
    """The compared numbers of the first epoch, worst over the folds:
    the relative gap of the step losses and of their sum; the gap of the
    first gradient's and of the change's norms, by the worst parameter,
    over the larger of the reference's norm of it and of the median
    parameter's, parameters whose reference gradient is under a
    thousandth of the median's left out; the count of train and test rows
    classified otherwise than by the reference, past its rows near a
    tie."""
    out = {"loss_rel": 0.0, "grad_rel": 0.0, "change_rel": 0.0,
           "count_gap": 0.0}
    for p, w in zip(prog, want):
        losses = np.asarray(w["losses"])
        rel = np.abs(np.asarray(p["losses"]) - losses) / np.abs(losses)
        rel_sum = float(abs(p["loss_sum"] - losses.sum())
                        / abs(losses.sum()))
        out["loss_rel"] = max(out["loss_rel"], float(rel.max()), rel_sum)
        median = statistics.median(w["grad"].values())
        moved = [n for n, g in w["grad"].items() if g >= 1e-3 * median]
        for key in ("grad", "change"):
            scale = statistics.median(w[key][n] for n in moved)
            gap = max(abs(p[key][n] - w[key][n]) / max(w[key][n], scale)
                      for n in moved)
            out[f"{key}_rel"] = max(out[f"{key}_rel"], gap)
        if "tp" not in p:
            p = dict(p, **_confusion(p, w))
        gap = max(abs(p["train_correct"] - w["train_correct"])
                  - w["train_ties"],
                  abs(p["tp"] - w["tp"]) - w["test_ties"],
                  abs(p["tn"] - w["tn"]) - w["test_ties"], 0)
        out["count_gap"] = max(out["count_gap"], float(gap))
    return out


def _recipe(cfg: dict) -> dict:
    r = cfg["recipe"]
    return dict(r["optimizer"], batch_size=r["batch_size"])
