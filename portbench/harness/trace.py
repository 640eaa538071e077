"""The traced run: ``torch.profiler`` (CPU and CUDA activity) over a
window, reduced to what the per-layer readers need.

* device activity: every kernel, copy and set on the card, with its name
  and interval; ``busy_s`` is the union of those intervals inside the
  window, so launches that overlap (programmatic dependent launch) count
  once;
* host spans: the ``record_function`` regions (the program's own, such
  as ``wav2vlad/bucket*``, and the ones this harness puts around its calls
  into each layer, ``portbench/*``), with their intervals;
* the breakdown: the device operations that took most time, and the
  device's idle gaps by the innermost host span that was open at each
  gap's middle.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

Interval = Tuple[float, float]          # seconds on the profiler's clock
WINDOW = "portbench/window"


def short_name(name: str) -> str:
    """``void (anonymous namespace)::kernel<T>(args)`` -> ``kernel``;
    ``Memcpy HtoD (Pageable -> Device)`` -> ``Memcpy HtoD``."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split("(")[0].strip()
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0].split("::")[-1].strip()
    return name.split(" ")[-1] or name


@dataclass
class Trace:
    window: Interval
    device_ops: List[Tuple[str, Interval]] = field(default_factory=list)
    spans: List[Tuple[str, Interval]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self) -> List[Tuple[str, Interval]]:
        """Device operations that are kernels (not copies or sets)."""
        return [(n, iv) for n, iv in self.device_ops
                if not n.startswith(("Memcpy", "Memset"))]

    def busy_s(self, names: Callable[[str], bool] | None = None) -> float:
        """Seconds in which some device operation (whose short name
        ``names`` accepts) ran inside the window."""
        ivs = sorted(iv for n, iv in self.device_ops
                     if names is None or names(short_name(n)))
        return _union(ivs, self.window)

    def span_s(self, prefix: str) -> float:
        """Host seconds of the spans whose name starts with ``prefix``
        (nested spans of one prefix counted once)."""
        return _union(sorted(iv for n, iv in self.spans
                             if n.startswith(prefix)), self.window)

    def gaps(self) -> List[Interval]:
        ivs = sorted(iv for _, iv in self.device_ops)
        gaps, reach = [], self.window[0]
        for s, e in ivs:
            if s > reach:
                gaps.append((reach, min(s, self.window[1])))
            reach = max(reach, e)
        if reach < self.window[1]:
            gaps.append((reach, self.window[1]))
        return [g for g in gaps if g[1] > g[0]]

    def breakdown(self, top: int = 10) -> dict:
        by_op: Dict[str, float] = {}
        for n, (s, e) in self.device_ops:
            k = short_name(n)
            by_op[k] = by_op.get(k, 0.0) + (e - s)
        by_host: Dict[str, float] = {}
        spans = [(n, iv) for n, iv in self.spans if n != WINDOW]
        for s, e in self.gaps():
            mid = 0.5 * (s + e)
            inner = [(iv[1] - iv[0], n) for n, iv in spans
                     if iv[0] <= mid <= iv[1]]
            what = min(inner)[1] if inner else "host outside spans"
            by_host[what] = by_host.get(what, 0.0) + (e - s)

        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]

        return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_host)}


def _union(ivs, window: Interval) -> float:
    total, reach = 0.0, window[0]
    for s, e in ivs:
        s, e = max(s, reach), min(e, window[1])
        if e > s:
            total += e - s
        reach = max(reach, e)
    return total


def profile(fn: Callable[[], None]) -> Trace:
    """Run ``fn`` once under ``torch.profiler`` on the card and reduce the
    trace.  The window is the ``portbench/window`` region around ``fn``,
    which ends after a device synchronisation.  The profiler's raw events
    are read (not its per-event Python tree), so a window of a million
    kernels reduces in seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    window, device_ops, spans = None, [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, length = _times(e)
        iv = (start, start + length)
        # a host region's mirror on the device timeline is no work; the
        # regions are the only events whose names hold a "/"
        region = "/" in name
        if e.device_type() == DeviceType.CUDA:
            if not region:
                device_ops.append((name, iv))
        elif name == WINDOW:
            window = iv
        elif region:
            spans.append((name, iv))
    if window is None:
        raise RuntimeError("the profiler recorded no window region")
    return Trace(window, device_ops, spans)


def _times(e) -> Interval:
    """(start, duration) in seconds of a raw profiler event (the
    nanosecond accessors where the torch version has them)."""
    if hasattr(e, "start_ns"):
        return e.start_ns() * 1e-9, e.duration_ns() * 1e-9
    return e.start_us() * 1e-6, e.duration_us() * 1e-6


@contextlib.contextmanager
def spans_around(targets):
    """Wrap callables in ``record_function`` regions while the block runs:
    ``targets`` is a list of (owner, attribute, span name); the original
    attributes are put back after."""
    saved = []
    try:
        for owner, attr, name in targets:
            orig = owner.__dict__[attr] if isinstance(owner, type) \
                else getattr(owner, attr)
            saved.append((owner, attr, orig))
            setattr(owner, attr, _wrapped(orig, name))
        yield
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


def _wrapped(orig, name: str):
    fn = orig.__func__ if isinstance(orig, staticmethod) else orig

    def call(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)

    return staticmethod(call) if isinstance(orig, staticmethod) else call
