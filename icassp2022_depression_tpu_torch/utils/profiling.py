"""Profiling hooks (port of :mod:`icassp2022_depression_tpu.utils.profiling`).

* :func:`annotate` names a region and records it.  Every region leaves a
  :class:`Span` record in an in-memory ring (always on): its name, its
  start and end on ``time.time_ns()`` (the clock ``torch.profiler``
  stamps its events with, so a record lies on a trace's timeline), its
  own id, the id of the region that encloses it on the same thread
  (``parent``) and of the outermost one (``root``: every region of one
  request or one training track shares it), and its counts.  While a
  profiler runs the region is also a ``torch.profiler.record_function``
  range, which a :func:`trace` records with the operations and kernel
  launches inside it; on a card it is an NVTX range as well.  A region
  adds no device synchronisation and reads no device value.
* :func:`records` returns the records that overlap an interval,
  :func:`dropped` how many the ring has let go, :func:`clear` empties it.
* :func:`trace` profiles the enclosed region (the CPU, and the card when
  there is one) and writes it as a Chrome trace into a directory.

The regions carry the JAX package's names where it has them:
``wav2vlad/bucket{blen}`` (one length bucket of
:func:`..frontend.audio.extract_batch`), ``wav2vlad/readback`` (the
features' copy to the host in :func:`..frontend.audio.extract_eatd`) and
``{task}/fold{i}`` (one fold of a serial trainer, :mod:`..train.trainers`).
The port adds ``serve/*`` (a request in
:class:`..serving.predictors.Predictor`, rooted at ``serve/call``),
``prng/*`` (one threefry draw, :mod:`..ops.prng`), ``text/segment`` and
``elmo/*`` (the text frontend), ``{task}/track``, ``{task}/plan``,
``{task}/folds`` and ``{task}/save`` (a track of a branch trainer) and
``foldrun/*`` (:class:`..train.loop.FoldRun`'s warm-up, capture, replays
and readback).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import socket
import threading
import time
from pathlib import Path
from typing import List, Optional

import torch

#: records the ring keeps; past it the oldest go first
RING_RECORDS = 1 << 16

_ring: collections.deque = collections.deque(maxlen=RING_RECORDS)
_ring_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_dropped = 0


class Span:
    """One region's record; :func:`annotate` yields it."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns",
                 "counts")

    def __init__(self, name: str, counts: dict):
        self.name = name
        self.counts = counts
        self.id = self.parent = self.root = None
        self.start_ns = self.end_ns = None

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"root={self.root}, {self.start_ns}..{self.end_ns}, "
                f"{self.counts})")


class _Region:
    __slots__ = ("span", "nvtx", "ranged")

    def __init__(self, name: str, device, counts: dict):
        self.span = Span(name, counts)
        self.nvtx = device is not None and torch.device(device).type == "cuda"
        self.ranged = None

    def __enter__(self) -> Span:
        span = self.span
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        span.id = next(_ids)
        if stack:
            span.parent, span.root = stack[-1].id, stack[-1].root
        else:
            span.root = span.id
        stack.append(span)
        span.start_ns = time.time_ns()
        if torch._C._autograd._profiler_enabled():
            self.ranged = torch.profiler.record_function(span.name)
            self.ranged.__enter__()
        if self.nvtx:
            torch.cuda.nvtx.range_push(span.name)
        return span

    def __exit__(self, *exc) -> bool:
        global _dropped
        span = self.span
        try:
            if self.nvtx:
                torch.cuda.nvtx.range_pop()
            if self.ranged is not None:
                self.ranged.__exit__(*exc)
        finally:
            span.end_ns = time.time_ns()
            stack = _local.stack
            if stack and stack[-1] is span:
                stack.pop()
            else:
                stack.remove(span)
            with _ring_lock:
                if len(_ring) == _ring.maxlen:
                    _dropped += 1
                _ring.append(span)
        return False


def annotate(name: str, device=None, **counts) -> _Region:
    """Named, recorded region (a context manager yielding its
    :class:`Span`, which keeps ``counts``).  It is also a
    ``torch.profiler`` range while a profiler runs, and an NVTX range
    when ``device`` is a card (``torch.cuda.nvtx`` is never touched
    otherwise, so a CPU-only torch runs this too)."""
    return _Region(name, device, counts)


def records(start_ns: Optional[int] = None,
            end_ns: Optional[int] = None) -> List[Span]:
    """The finished records in the ring that overlap ``[start_ns,
    end_ns]`` (either end open when None), in the order they ended."""
    with _ring_lock:
        out = list(_ring)
    if start_ns is not None:
        out = [r for r in out if r.end_ns >= start_ns]
    if end_ns is not None:
        out = [r for r in out if r.start_ns <= end_ns]
    return out


def dropped() -> int:
    """Records the ring has let go since it was last cleared."""
    return _dropped


def clear() -> None:
    """Empty the ring (and its count of dropped records)."""
    global _dropped
    with _ring_lock:
        _ring.clear()
        _dropped = 0


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
