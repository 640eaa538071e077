"""Profiling hooks (port of :mod:`icassp2022_depression_tpu.utils.profiling`).

* :func:`annotate` names a region: a ``torch.profiler.record_function``
  range, which a :func:`trace` (or any ``torch.profiler`` run) records
  with the operations and kernel launches inside it, and an NVTX range
  when the region works on a card.  The product's regions carry the JAX
  package's names: ``wav2vlad/bucket{blen}`` (one length bucket of
  :func:`..frontend.audio.extract_batch`), ``wav2vlad/readback`` (the
  features' copy to the host in :func:`..frontend.audio.extract_eatd`)
  and ``{task}/fold{i}`` (one fold of a serial trainer,
  :mod:`..train.trainers`).  A region adds no device synchronisation.
* :func:`trace` profiles the enclosed region (the CPU, and the card when
  there is one) and writes it as a Chrome trace into a directory.
* :class:`Stopwatch` sums host wall time by section.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def annotate(name: str, device=None):
    """Named region in profiler traces; also an NVTX range when ``device``
    is a card (``torch.cuda.nvtx`` is never touched otherwise, so a
    CPU-only torch runs this too)."""
    nvtx = device is not None and torch.device(device).type == "cuda"
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(log_dir):
    """Profile the enclosed region and write it to ``log_dir`` as
    ``<host>_<pid>.<ms>.pt.trace.json`` (a Chrome trace: open it in
    Perfetto or ``chrome://tracing``, or TensorBoard's PyTorch profiler
    plugin).  The card's kernels are recorded when there is a card.
    Yields the ``torch.profiler.profile``; its ``trace_path`` attribute is
    set to the file once the region has ended.  A region that raises
    still writes its trace (as the JAX package stops its trace in a
    ``finally``), and the error goes on."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        path = log_dir / (f"{socket.gethostname()}_{os.getpid()}."
                          f"{int(time.time() * 1000)}.pt.trace.json")
        prof.export_chrome_trace(str(path))
        prof.trace_path = path


class Stopwatch:
    """Accumulating section timer for host-side phases."""

    def __init__(self):
        self.sections = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections[name] = (self.sections.get(name, 0.0) +
                                   time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.sections.values())
        lines = [f"{name}: {secs:.3f}s ({100 * secs / max(total, 1e-9):.1f}%)"
                 for name, secs in sorted(self.sections.items(),
                                          key=lambda kv: -kv[1])]
        return "\n".join(lines)
