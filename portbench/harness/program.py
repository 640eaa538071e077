"""Shared arithmetic of the per-layer readers that read the port's own
span records (``utils/profiling.py``'s ring).  The port stamps its records
with ``time.time_ns()``, the clock of ``torch.profiler``'s events and so of
:attr:`..trace.Trace.window`, which lets a reader pick the records of the
traced window, or of the track that holds it, fixed costs outside the
profiled slice included.

Each reader returns None in a cell of another family, where the window
holds nothing to read, and where the port keeps no records: a checkout
from before its recorder, which a traced run of the benchmark as it
stands meets when it measures an older commit.  :func:`ring` then gives
None.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

from portbench.harness.cell import Context
from portbench.harness.trace import _union

#: the regions of a track's fixed costs: the fold datas' build and
#: upload, the warm-up epoch, the graph capture, the gated saves
TRACK_FIXED = ("{task}/plan", "foldrun/warm_epoch", "foldrun/capture",
               "{task}/save")


def ring(start_ns: int, end_ns: int) -> Optional[list]:
    """The port's records that overlap ``[start_ns, end_ns]``, or None
    where the port keeps none (a checkout from before its recorder)."""
    from icassp2022_depression_tpu_torch.utils import profiling
    records = getattr(profiling, "records", None)
    return None if records is None else records(start_ns, end_ns)


def window_ns(ctx: Context) -> Tuple[int, int]:
    lo, hi = ctx.trace.window
    return math.floor(lo * 1e9), math.ceil(hi * 1e9)


def _inside(r, lo: int, hi: int) -> bool:
    return lo <= r.start_ns and r.end_ns <= hi


def pad_share_pct(ctx: Context, family: str) -> Optional[float]:
    """100 x the padded samples over all the samples the length buckets
    processed (``wav2vlad/bucket*`` records inside the window)."""
    if ctx is None or ctx.family != family:
        return None
    lo, hi = window_ns(ctx)
    records = ring(lo, hi)
    if not records:
        return None
    padded = real = 0
    for r in records:
        if (r.name.startswith("wav2vlad/bucket") and _inside(r, lo, hi)
                and "padded_samples" in r.counts):
            padded += r.counts["padded_samples"]
            real += r.counts["samples"]
    return 100.0 * padded / (padded + real) if padded + real else None


def track_fixed_s(ctx: Context, family: str) -> Optional[float]:
    """Host seconds of the fixed costs (:data:`TRACK_FIXED`) of the one
    ``{task}/track`` record whose interval holds the window, read from
    its descendants wherever they lie in the track."""
    if ctx is None or ctx.family != family:
        return None
    task = ctx.config.get("task")
    lo, hi = window_ns(ctx)
    records = ring(lo, hi)
    if not records:
        return None
    tracks = [r for r in records if r.name == f"{task}/track"
              and r.start_ns <= lo and hi <= r.end_ns]
    if len(tracks) != 1:
        return None
    track = tracks[0]
    fixed = {n.format(task=task) for n in TRACK_FIXED}
    mine = sorted((r.start_ns * 1e-9, r.end_ns * 1e-9)
                  for r in ring(track.start_ns, track.end_ns) or []
                  if r.root == track.id and r.name in fixed)
    total = _union(mine, (track.start_ns * 1e-9, track.end_ns * 1e-9))
    return total if total > 0 else None
