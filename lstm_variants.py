#!/usr/bin/env python3
"""Times variants of the LSTM forward kernel's step route
(``csrc/lstm_fwd.cu``) on one GPU, to find what holds its step back:

    python3 lstm_variants.py [VARIANT ...]

Each variant is a copy of the source and its headers (the step route's
body is ``csrc/rnn_fwd_step.cuh``) with a few strings replaced, built
by ``lstmp_variants.compile_variant`` into ``_checkout/lstm_variants/``
(listed in ``.gitignore``), one compiler process per variant, started
together.  Every
variant's C entry is called through ``ctypes`` with the step tile that
``ops/rnn_cuda.lstm_fwd_plan`` picks, at the stand-in encoder's (T, B, H)
= (16, 8, 512), (128, 24, 512), (16, 112, 512), (128, 488, 512) and the
text model's (256, 16, 128), weights uniform within 1/sqrt(H): the
variants' calls taken in turns, the median and least of 20 calls each
(10 at (128, 488)), CUDA events, the time a step, and the largest
difference from the plain loop.  Prints the card's name and power limit
first and the compiler's register and spill lines of each variant.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
CSRC = HERE / "icassp2022_depression_tpu_torch" / "csrc"
OUT = HERE / "_checkout" / "lstm_variants"
SHAPES = ((16, 8, 512), (128, 24, 512), (16, 112, 512), (128, 488, 512),
          (256, 16, 128))
STAGE_K = "return CS == 4 ? 64 : 32;"
STAGES = "return CS == 4 ? 8 : 4;"
UNROLL = "#pragma unroll\n    for (int q = 0; q < KG; q += 4) {"
SOLO = "constexpr size_t kSoloSmem = 120 * 1024;"

#: name -> [(text in the source, its replacement)]
VARIANTS = {
    "base": [],
    # launches serialised as plain stream order
    "nopdl": [("step.numAttrs = t > 0 ? 1 : 0;", "step.numAttrs = 0;")],
    # two blocks an SM (each asks only for the shared memory its ring
    # needs, at most 103 KB): the next step's blocks sit beside a running
    # step, and two blocks of one step may meet on one SM
    "pair": [("__launch_bounds__(kThreads, 1)",
              "__launch_bounds__(kThreads, 2)"),
             (SOLO, "constexpr size_t kSoloSmem = 103 * 1024 + 512;")],
    # 16 k a stage, 8 stages, for the 32-cell tiles
    "k16": [(STAGE_K, "return CS == 4 ? 64 : 16;"),
            (STAGES, "return CS == 4 ? 8 : 8;")],
    # half of a stage's k loop unrolled at once
    "unroll2": [(UNROLL, UNROLL.replace("unroll", "unroll 2"))],
    # the many-row tile at 32 rows: 256 blocks at B = 488, two waves
    "rows32": [("  LSTM_FWD_TILE(32, 64, 1)\n",
                "  if (cells == 32 && rows == 64)\n"
                "    return (int)rnn_fwd::run_steps<LstmCell, 32, 32, 1>("
                "lstm_fwd_step_kernel<32, 32, 1>, xp, w_hh_t, b_hh, ys, cs, "
                "T, B, H, s);\n")],
}


def build(name: str):
    from lstmp_variants import compile_variant

    return compile_variant(CSRC / "lstm_fwd.cu", name, VARIANTS[name], OUT)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("lstm_variants: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from icassp2022_depression_tpu_torch.ops import rnn_cuda

    names = argv or list(VARIANTS)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build, names)))
    fns = {}
    for name, (so, report) in built.items():
        fn = ctypes.CDLL(str(so)).lstm_seq_fwd_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
        print(f"{name}: " + "; ".join(report))

    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for t, b, h in SHAPES:
        xp = torch.randn((t, b, 4 * h), generator=gen).cuda()
        w = ((torch.rand((h, 4 * h), generator=gen) * 2 - 1)
             * h ** -0.5).cuda()
        bias = ((torch.rand((1, 4 * h), generator=gen) * 2 - 1)
                * h ** -0.5).cuda()
        ref = rnn_cuda.lstm_sequence_torch(xp, w, bias)
        plan = rnn_cuda.lstm_fwd_plan(b, h)
        outs = [torch.empty((t, b, h), device="cuda") for _ in range(2)]

        def call(name):
            err = fns[name](xp.data_ptr(), w.data_ptr(), bias.data_ptr(),
                            outs[0].data_ptr(), outs[1].data_ptr(), t, b, h,
                            plan["cells"], plan["rows"], stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")

        errs, times = {}, {name: [] for name in fns}
        for name in fns:
            call(name)
            torch.cuda.synchronize()
            errs[name] = max((o - r).abs().max().item()
                             for o, r in zip(outs, ref))
        for _ in range(10 if t * b > 4096 else 20):
            for name in fns:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call(name)
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end))
        for name, ts in times.items():
            med = statistics.median(ts)
            print(f"  {name} T={t} B={b} H={h} ({plan['cells']} x "
                  f"{plan['rows']} tile): median {med:.4f} ms, least "
                  f"{min(ts):.4f} ms ({med / t * 1e3:.2f} us a step), "
                  f"max|d| {errs[name]:.2e} (CUDA events, {len(ts)} calls "
                  f"in turns) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
