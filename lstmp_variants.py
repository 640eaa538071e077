#!/usr/bin/env python3
"""Times variants of the LSTMP forward kernel (``csrc/lstmp_fwd.cu``) on
one GPU, to find what holds its step back:

    python3 lstmp_variants.py [VARIANT ...]

Each variant is a copy of the source and its headers with a few strings
replaced (the script fails if a replacement applies nowhere), built with
the package's ``nvcc`` flags into ``_checkout/lstmp_variants/`` (listed in
``.gitignore``), one compiler process per variant, started together.  Every
variant's C entry is called through ``ctypes`` with the tile that
``ops/rnn_cuda.lstmp_fwd_plan`` picks, at (T, B) = (16, 8), (128, 24) and
(32, 128) with C = 4096, P = 512 and weights at ``init_lstmp``'s bounds:
the median and least of 20 calls (CUDA events), the time a step, and the
largest difference from the plain loop relative to its largest magnitude
(``nocompute`` skips the gate product on purpose, so it is wrong there).
Prints the card's name and power limit first and the compiler's
register and spill lines of each variant.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
CSRC = HERE / "icassp2022_depression_tpu_torch" / "csrc"
OUT = HERE / "_checkout" / "lstmp_variants"
SHAPES = ((16, 8), (128, 24), (32, 128))
C_DIM, P_DIM, REPS = 4096, 512, 20
STAGES = "return CS == 32 ? 8 : 4;"
CG = "cp.async.cg.shared.global [%0]"

#: name -> [(text in the source, its replacement)]
VARIANTS = {
    "base": [],
    # launches serialised as plain stream order
    "nopdl": [("step.numAttrs = t > 0 ? 1 : 0;", "step.numAttrs = 0;"),
              ("reduce.numAttrs = 1;", "reduce.numAttrs = 0;")],
    # ring depth (CS = 32 tiles, CS = 64 tile)
    "stages4_3": [(STAGES, "return CS == 32 ? 4 : 3;")],
    "stages12_6": [(STAGES, "return CS == 32 ? 12 : 6;")],
    "stages16_4": [(STAGES, "return CS == 32 ? 16 : 4;")],
    # L2 prefetch size and L1 caching of the copies
    "l2_128": [(CG, "cp.async.cg.shared.global.L2::128B [%0]")],
    "l2_256": [(CG, "cp.async.cg.shared.global.L2::256B [%0]")],
    "ca": [("cp.async.cg.shared.global [%0], [%1], 16",
            "cp.async.ca.shared.global [%0], [%1], 16")],
    # the whole stage unrolled at once for the 64-row tile too
    "full_unroll": [("constexpr int KU = RT >= 8 ? GK / 2 : GK;",
                     "constexpr int KU = GK;")],
    # no gate product (the copies, syncs, cell update and projection stay)
    "nocompute": [("for (int k0 = 0; k0 < GK; k0 += KU)",
                   "for (int k0 = 0; k0 < GK * (B < 0); k0 += KU)")],
}


def compile_variant(source: Path, name: str, replacements, out: Path):
    """``source`` and the headers beside it (``*.cuh``) with each (text,
    replacement) of ``replacements`` applied wherever the text occurs
    (failing if it occurs nowhere), written to ``out/<name>/`` and built
    with the package's ``nvcc`` flags into ``out/<name>/lib<name>.so``:
    (the library, the compiler's register and spill lines)."""
    from icassp2022_depression_tpu_torch import _build

    files = {f.name: f.read_text()
             for f in (source, *sorted(source.parent.glob("*.cuh")))}
    for old, new in replacements:
        hits = [f for f, src in files.items() if old in src]
        if not hits:
            raise RuntimeError(f"variant {name}: {old!r} not in the sources")
        for f in hits:
            files[f] = files[f].replace(old, new)
    where = out / name
    where.mkdir(parents=True, exist_ok=True)
    for f, src in files.items():
        (where / f).write_text(src)
    so = where / f"lib{name}.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(so), str(where / source.name)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"variant {name} failed to build:\n"
                           f"{proc.stderr[-3000:]}")
    report = [line.strip() for line in proc.stdout.splitlines()
              + proc.stderr.splitlines()
              if "registers" in line or "spill" in line]
    return so, report


def build(name: str):
    return compile_variant(CSRC / "lstmp_fwd.cu", name, VARIANTS[name], OUT)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("lstmp_variants: needs a CUDA card", file=sys.stderr)
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

    gen = torch.Generator().manual_seed(0)
    inputs, refs = {}, {}
    for t, b in SHAPES:
        xp4 = torch.randn((t, b, 4, C_DIM), generator=gen)
        w_h = (torch.rand((P_DIM, 4, C_DIM), generator=gen) * 2 - 1) \
            / P_DIM ** 0.5
        b3 = torch.zeros((1, 4, C_DIM))
        w_p = (torch.rand((C_DIM, P_DIM), generator=gen) * 2 - 1) \
            / C_DIM ** 0.5
        inputs[(t, b)] = [a.cuda() for a in (xp4, w_h, b3, w_p)]
        refs[(t, b)] = rnn_cuda.lstmp_sequence_torch(*inputs[(t, b)])
    for name, (so, report) in built.items():
        fn = ctypes.CDLL(str(so)).lstmp_seq_fwd_f32
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        print(f"{name}: " + "; ".join(report))
        for (t, b), (xp4, w_h, b3, w_p) in inputs.items():
            plan = rnn_cuda.lstmp_fwd_plan(b, C_DIM, P_DIM)
            outs = [torch.empty((t, b, d), device="cuda")
                    for d in (P_DIM, P_DIM, C_DIM, C_DIM)]
            part = torch.empty(plan["scratch"], device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                err = fn(xp4.data_ptr(), w_h.data_ptr(), b3.data_ptr(),
                         w_p.data_ptr(), *(o.data_ptr() for o in outs),
                         part.data_ptr(), t, b, C_DIM, P_DIM, plan["cells"],
                         plan["rows"], 3.0, 3.0, stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")

            call()
            torch.cuda.synchronize()
            err = max(((o - r).abs().max() / r.abs().max()).item()
                      for o, r in zip(outs, refs[(t, b)]))
            times = []
            for _ in range(REPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            times.sort()
            med = times[REPS // 2]
            print(f"  {name} T={t} B={b}: median {med:.4f} ms, least "
                  f"{times[0]:.4f} ms ({med / t * 1e3:.2f} us a step), "
                  f"max|d| {err:.2e} of max|plain| (CUDA events, {REPS} "
                  f"calls) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
