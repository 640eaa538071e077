"""Runs one cell of the port's benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  It sets up the system under test (weights and inputs drawn from
``--seed``), warms the cell's shapes, measures for ``--seconds`` (``--trace
1``: a traced window of fixed work instead, read by the per-layer
metrics), checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output::

    {"correct", "attempted", "failed", "metrics", "device",
     ["breakdown",] "compared"}

``--control 1`` also runs the control (the reference in TF32) on the same
sample and prints its numbers on standard error; the benchmark's own
runs leave it off.

It exits with a code other than 0, and prints no result, when the cards
are missing, when the port cannot be imported, or when JAX or the JAX
package was loaded.  The port's kernels build into ``portbench/.build/``
(``ICASSP_TPU_TORCH_BUILD_DIR``), so only a checkout's first run builds.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
BUILD = HERE / ".build"


def _confine() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    os.environ["ICASSP_TPU_TORCH_BUILD_DIR"] = str(BUILD / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["ICASSP_SUPPRESS_STANDIN_WARNING"] = "1"
    os.environ.pop("ICASSP_ELMO_WEIGHTS", None)
    if str(HERE.parent) not in sys.path:
        sys.path.insert(0, str(HERE.parent))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def make_cell(args, device: str = "cuda"):
    from portbench.harness import registry
    from portbench.harness.cell import Cell

    workload = registry.workload(args.workload)
    return Cell(name=args.workload,
                config=registry.config(workload["config"]),
                traffic=registry.traffic(workload["traffic"]),
                workload=workload, seed=args.seed, seconds=args.seconds,
                trace=bool(args.trace), device=device,
                control=bool(args.control), started=STARTED)


def execute(cell):
    """Run the cell through its traffic driver -> (result dict, the
    compared numbers' lines)."""
    from portbench.harness import registry

    run = registry.driver(cell.traffic["driver"]).run(cell)
    for note in run.notes:
        print(note, file=sys.stderr, flush=True)
    device = {"platform": "gpu" if cell.device == "cuda" else cell.device,
              "kind": _kind(cell.device), "count": cell.workload["chips"],
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    result = {"correct": run.correct, "attempted": run.attempted,
              "failed": run.failed}
    if cell.trace:
        ctx = run.context
        metrics = {}
        for name, reader in registry.metrics().items():
            value = reader.read(ctx)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": reader.UNIT}
        result["metrics"] = metrics
        device["busy_s"] = ctx.trace.busy_s()
        device["window_s"] = ctx.trace.window_s
        result["device"] = device
        result["breakdown"] = ctx.trace.breakdown()
    else:
        result["metrics"] = {k: {"value": float(v), "unit": u}
                             for k, (v, u) in run.metrics.items()}
        result["device"] = device
    result["compared"] = {c.name: {"value": c.value, "limit": c.limit}
                          for c in run.compared}
    lines = [f"control {c.name} {c.value!r} limit {c.limit!r} "
             f"{'passes' if c.ok else 'fails'}" for c in run.control]
    lines += [f"compared {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAIL'}" for c in run.compared]
    return result, lines


def _kind(device: str) -> str:
    import torch

    return torch.cuda.get_device_name(0) if device == "cuda" else device


def main(argv=None) -> int:
    args = parse(argv)
    _confine()
    from portbench.harness import card, registry

    workload = registry.workload(args.workload)
    missing = card.cuda_ready(int(workload["chips"]))
    if missing:
        print(f"portbench: no run: {missing}", file=sys.stderr)
        return 2
    result, lines = execute(make_cell(args))
    banned = card.banned_modules()
    if banned:
        print(f"portbench: the run loaded {', '.join(banned)}; no result",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
