#!/usr/bin/env python3
"""Times the step route of the GRU and LSTM backward kernels
(``csrc/gru_bwd.cu``, ``csrc/lstm_bwd.cu``) at each cell-slab width it
compiles, beside the plan's own tile and the "sequence" route, and the
LSTMP backward's step route (``csrc/lstmp_bwd.cu``) at each row tile it
compiles, on one GPU:

    python3 rnn_bwd_tiles.py [--only gru|lstm|lstmp]

At the audio model's (T, B, H) = (3, 8, 256) and (256, 16, 256) for the
GRU and the text model's (3, 4, 128) and (256, 16, 128) for the LSTM
(weights uniform within 1/sqrt(H), standard normal inputs and
cotangents), every variant is checked against the plain backward (dxp
within 1e-5, dw and db within 1e-5 of their largest magnitude), then the
variants' calls are taken in turns: the median and least of 30 calls each
(CUDA events, through the wrappers ``gru_sequence_bwd`` /
``lstm_sequence_bwd`` with an explicit plan).  The LSTMP backward at the
zhs geometry (C = 4096, P = 512; (T, B) = (16, 8), (128, 24), (32, 128),
weights at ``init_lstmp``'s bounds, standard normal inputs and
cotangents, fed the plain forward's residuals) through every compiled
row tile up to the batch padded to 8 rows (32-cell slabs), each within
1e-5 of the plain backward's largest magnitude, then 10 calls each in
turns.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SHAPES = {"gru": ((3, 8, 256), (256, 16, 256)),
          "lstm": ((3, 4, 128), (256, 16, 128))}
LSTMP_SHAPES = ((16, 8), (128, 24), (32, 128))
C_DIM, P_DIM = 4096, 512
TOL = 1e-5
REPS = 30
LSTMP_REPS = 10


def turns(torch, fns: dict, reps: int) -> dict:
    """{name: [ms of each call]} of ``fns``' calls taken in turns (CUDA
    events)."""
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return times


def lstmp_tiles(torch, rnn_cuda, gen, card: str) -> int:
    """The LSTMP backward's step route through each compiled row tile at
    ``LSTMP_SHAPES``; 1 on a disagreement with the plain backward."""
    c, p = C_DIM, P_DIM
    for t, b in LSTMP_SHAPES:
        xp4 = torch.randn((t, b, 4, c), generator=gen)
        w_h = (torch.rand((p, 4, c), generator=gen) * 2 - 1) / p ** 0.5
        b3 = torch.zeros((1, 4, c))
        w_p = (torch.rand((c, p), generator=gen) * 2 - 1) / c ** 0.5
        fwd_in = tuple(a.cuda() for a in (xp4, w_h, b3, w_p))
        args = (fwd_in + rnn_cuda.lstmp_sequence_torch(*fwd_in)[:3]
                + (torch.randn((t, b, p), generator=gen).cuda(),
                   torch.randn((t, b, c), generator=gen).cuda()))
        ref = rnn_cuda.lstmp_sequence_bwd_torch(*args)
        auto = rnn_cuda.lstmp_bwd_plan(b, c, p)
        plans = {f"step 32x{rows}": dict(auto, rows=rows,
                                         row_tiles=-(-b // rows))
                 for cells, rows in rnn_cuda.LSTMP_BWD_TILES
                 if rows <= 8 * -(-b // 8)}
        for name, plan in plans.items():
            got = rnn_cuda.lstmp_sequence_bwd(*args, plan=plan)
            rel = max(((x - r).abs().max() / r.abs().max()).item()
                      for x, r in zip(got, ref))
            if not rel <= TOL:
                print(f"lstmp_bwd {name} at {(t, b, c, p)} disagrees with "
                      f"the plain backward: {rel}")
                return 1
        times = turns(torch, {name: (lambda plan=plan: rnn_cuda
                                     .lstmp_sequence_bwd(*args, plan=plan))
                              for name, plan in plans.items()}, LSTMP_REPS)
        print(f"lstmp_bwd T={t} B={b} C={c} P={p} (plan: {auto['cells']} "
              f"cells x {auto['rows']} rows): " + ", ".join(
                  f"{name} {statistics.median(v):.4f} ms (least "
                  f"{min(v):.4f})" for name, v in times.items())
              + f" (median of {LSTMP_REPS} in turns, CUDA events) [{card}]")
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["gru", "lstm", "lstmp"])
    only = ap.parse_args(argv).only
    import torch

    if not torch.cuda.is_available():
        print("rnn_bwd_tiles: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from icassp2022_depression_tpu_torch.ops import rnn_cuda

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(12)
    for cell, shapes in SHAPES.items():
        if only not in (None, cell):
            continue
        gates = 3 if cell == "gru" else 4
        plan_fn = (rnn_cuda.gru_bwd_plan if cell == "gru"
                   else rnn_cuda.lstm_bwd_plan)
        bwd = (rnn_cuda.gru_sequence_bwd if cell == "gru"
               else rnn_cuda.lstm_sequence_bwd)
        plain = (rnn_cuda.gru_sequence_bwd_torch if cell == "gru"
                 else rnn_cuda.lstm_sequence_bwd_torch)
        for t, b, h in shapes:
            g = gates * h
            xp = torch.randn((t, b, g), generator=gen)
            w = (torch.rand((h, g), generator=gen) * 2 - 1) * h ** -0.5
            bias = (torch.rand((1, g), generator=gen) * 2 - 1) * h ** -0.5
            dys = torch.randn((t, b, h), generator=gen)
            args = [a.cuda() for a in (xp, w, bias)]
            if cell == "gru":
                args += [rnn_cuda.gru_sequence_torch(*args), dys.cuda()]
            else:
                dcs = torch.randn((t, b, h), generator=gen).cuda()
                args += [*rnn_cuda.lstm_sequence_torch(*args), dys.cuda(),
                         dcs]
            ref = plain(*args)
            auto = plan_fn(b, h, steps=t)
            plans = {"sequence": plan_fn(b, h, "sequence", steps=t)}
            for cells in (1, 2, 4):
                name = f"step {cells}x{auto['rows']}"
                plans[name] = dict(auto, cells=cells,
                                   slabs=-(-h // cells))
            for name, plan in plans.items():
                got = bwd(*args, plan=plan)
                err = (got[0] - ref[0]).abs().max().item()
                rel = max(((x - r).abs().max() / r.abs().max()).item()
                          for x, r in zip(got[1:], ref[1:]))
                if not (err <= TOL and rel <= TOL):
                    print(f"{cell}_bwd {name} at {(t, b, h)} disagrees with "
                          f"the plain backward: dxp {err}, dw/db {rel}")
                    return 1
            times = turns(torch, {name: (lambda plan=plan:
                                         bwd(*args, plan=plan))
                                  for name, plan in plans.items()}, REPS)
            print(f"{cell}_bwd T={t} B={b} H={h} (plan: {auto['cells']} "
                  f"cells x {auto['rows']} rows, {auto['splits']} weight "
                  f"parts): " + ", ".join(
                      f"{name} {statistics.median(v):.4f} ms (least "
                      f"{min(v):.4f})" for name, v in times.items())
                  + f" (median of {REPS} in turns, CUDA events) [{card}]")
    if only in (None, "lstmp"):
        return lstmp_tiles(torch, rnn_cuda, gen, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
