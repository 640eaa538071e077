"""The card a run uses, read beside the run, and the check that the run
loaded nothing of JAX."""

from __future__ import annotations

import subprocess
import sys
from typing import Iterable, List

#: top-level module names a run must not hold once its window has closed
#: (the JAX package's name is compared whole: the port's name begins
#: with it)
BANNED = ("jax", "jaxlib", "flax", "icassp2022_depression_tpu")


def banned_modules(modules: Iterable[str] | None = None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(BANNED))


def smi() -> str:
    """nvidia-smi's name, power limit, SM clock and temperature, or why
    they could not be read."""
    query = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi not read: {err}"
    return (out.stdout.strip().replace("\n", " | ")
            or f"nvidia-smi: {out.stderr.strip()}")


def cuda_ready(count: int) -> str | None:
    """None when ``count`` cards are visible, else why not."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < count:
        return (f"{torch.cuda.device_count()} card(s) visible, the cell "
                f"asks for {count}")
    return None
