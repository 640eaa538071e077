"""Shared arithmetic of the per-layer readers in ``metrics/``: each reader
names its family (the suffix of its name, the kind of cell whose
end-to-end metric it moves) and returns None in a cell of another family
or where the trace holds nothing to read."""

from __future__ import annotations

from typing import Optional

from portbench.counts.peaks import PEAK_FP32_FLOPS
from portbench.harness.cell import Context


def _work(ctx: Context, family: str, unit: str) -> Optional[float]:
    if ctx is None or ctx.family != family:
        return None
    n = ctx.work.get(unit, 0)
    return float(n) if n else None


def span_ms_per(ctx: Context, family: str, prefix: str,
                unit: str) -> Optional[float]:
    """Host milliseconds of the ``prefix`` spans per ``unit`` of work."""
    n = _work(ctx, family, unit)
    if n is None:
        return None
    s = ctx.trace.span_s(prefix)
    return 1e3 * s / n if s > 0 else None


def kernels_per(ctx: Context, family: str, unit: str) -> Optional[float]:
    n = _work(ctx, family, unit)
    if n is None:
        return None
    k = len(ctx.trace.kernels())
    return k / n if k else None


def idle_pct(ctx: Context, family: str) -> Optional[float]:
    if ctx is None or ctx.family != family or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)


def mfu_pct(ctx: Context, family: str) -> Optional[float]:
    if ctx is None or ctx.family != family:
        return None
    flops = ctx.work.get("flops", 0.0)
    if not flops or ctx.trace.window_s <= 0:
        return None
    return 100.0 * flops / (ctx.trace.window_s * PEAK_FP32_FLOPS)


def roofline_pct(ctx: Context, family: str, kernel: str,
                 names: tuple) -> Optional[float]:
    """100 x the kernel's least time (``work["bound_s"][kernel]``, from
    the inputs' real sizes) over the device time of the kernels whose
    short name starts with one of ``names`` (their union)."""
    if ctx is None or ctx.family != family:
        return None
    bound = ctx.work.get("bound_s", {}).get(kernel, 0.0)
    busy = ctx.trace.busy_s(lambda n: n.startswith(names))
    if bound <= 0 or busy <= 0:
        return None
    return 100.0 * bound / busy
