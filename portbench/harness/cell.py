"""What a traffic driver gets (:class:`Cell`) and gives back (:class:`Run`),
and what a per-layer reader reads (:class:`Context`)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from portbench.harness.trace import Trace


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    workload: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    #: run the control (the reference in the precision below the
    #: configuration's) beside the reference; the benchmark's own runs
    #: never do
    control: bool = False
    #: perf_counter() at process start: set-up is counted from there
    started: float = 0.0


@dataclass
class Compared:
    """One number of the correctness check beside its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Context:
    """A traced window and the work the driver counted in it."""

    family: str
    config: dict
    trace: Trace
    #: counts of work in the traced window: "requests", "speakers",
    #: "steps", "flops" (useful model operations), and per-kernel
    #: (operations, bytes) under "kernel_work"
    work: Dict[str, object] = field(default_factory=dict)


@dataclass
class Run:
    attempted: int
    failed: int
    #: end-to-end metrics (trace 0) as {name: (value, unit)}
    metrics: Dict[str, tuple] = field(default_factory=dict)
    compared: List[Compared] = field(default_factory=list)
    memory_peak_bytes: int = 0
    context: Optional[Context] = None
    #: lines printed before the result (card, link, cache, tracks)
    notes: List[str] = field(default_factory=list)
    control: List[Compared] = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and self.attempted > 0
                and bool(self.compared)
                and all(c.ok for c in self.compared))


def run_dir(name: str) -> Path:
    """``$TMPDIR/portbench/<name>``: where a run writes what it hands the
    program as files (a bundle, checkpoints).  ``TMPDIR`` must be set:
    a fixed fallback would be shared between runs."""
    tmp = os.environ.get("TMPDIR")
    if not tmp:
        raise RuntimeError("portbench: TMPDIR is not set; a run writes "
                           "its files under it")
    return Path(tmp) / "portbench" / name
