"""The device an entry point runs on when its caller names none: the card
of this process's rank when it is one of a launched group
(:mod:`..parallel.distributed`), else the first card, and an error when
there is none (no silent run on the CPU).  Also the host <-> device link
probe of ``cli doctor`` (:func:`probe_link`)."""

from __future__ import annotations

import statistics
import time
from typing import Optional

import torch

#: the device :func:`..parallel.distributed.launch` or ``initialize`` gave
#: this process's rank (None outside a group)
_RANK_DEVICE: Optional[torch.device] = None


def set_rank_device(device) -> None:
    """Make ``device`` the default of this process (its rank's device); a
    card also becomes torch's current device."""
    global _RANK_DEVICE
    _RANK_DEVICE = None if device is None else torch.device(device)
    if _RANK_DEVICE is not None and _RANK_DEVICE.type == "cuda":
        torch.cuda.set_device(_RANK_DEVICE)


def require_card() -> None:
    """Raises when there is no card (no silent run on the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "false); pass --device cpu (or device='cpu') to run on the CPU")


def local_rank_device(local_rank: int) -> torch.device:
    """The card of local rank ``local_rank`` (one card per rank, in order);
    raises when the host has no such card."""
    require_card()
    have = torch.cuda.device_count()
    if local_rank >= have:
        raise RuntimeError(
            f"local rank {local_rank} needs card cuda:{local_rank} but this "
            f"host has {have} CUDA device(s); launch CPU ranks with "
            "--device cpu")
    return torch.device("cuda", local_rank)


def default_device() -> torch.device:
    """This rank's device inside a launched group, else the first card;
    raises when there is none."""
    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    require_card()
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device``, or :func:`default_device` when it is None."""
    return default_device() if device is None else torch.device(device)


def probe_link(device, size_mb: float = 8.0, reps: int = 3) -> dict:
    """Measure the host <-> ``device`` link now, as the JAX package's relay
    probe does (``utils/relay.py::probe_weather``) -> a JSON-able dict:

    * ``roundtrip_s``: median time of a 256-byte upload read straight
      back, the latency every blocking readback pays;
    * ``up_mb_s`` / ``down_mb_s``: a ``size_mb`` int16 payload a rep in
      each direction, latency-corrected (the median transfer time less
      ``roundtrip_s``).  Each up rep copies a fresh host buffer (cloned
      outside the timed region) and is sequenced by reading back its
      first element; each down rep reads back a distinct device tensor.

    Host memory is pageable, as in the product's ``.to(device)`` and
    ``.cpu()``; the clock is the host's, around work ending in
    ``torch.cuda.synchronize``.  On the CPU the same code times copies
    within host memory."""
    device = torch.device(device)
    n = max(128, int(size_mb * 1e6 / 2))             # int16 elements
    payload_bytes = 2 * n
    host = torch.arange(n, dtype=torch.int64).remainder(251).to(torch.int16)
    tiny = torch.ones(128, dtype=torch.int16)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(fn) -> float:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return time.perf_counter() - t0

    # warm: first-touch allocations and transfers of both sizes
    y = host.to(device, copy=True)
    y[:1].to("cpu", copy=True)
    (y + 0).to("cpu", copy=True)
    tiny.to(device, copy=True).to("cpu", copy=True)

    rts = []
    for _ in range(reps):
        buf = tiny.clone()
        rts.append(timed(lambda: buf.to(device, copy=True).to("cpu",
                                                              copy=True)))
    roundtrip = statistics.median(rts)

    ups = []
    for _ in range(reps):
        buf = host.clone()                           # copied outside timing
        ups.append(timed(lambda: buf.to(device, copy=True)[:1].to(
            "cpu", copy=True)))

    downs = []
    for i in range(reps):
        w = y + (i + 1)                              # a distinct tensor
        downs.append(timed(lambda: w.to("cpu", copy=True)))

    def bandwidth(dt):
        return payload_bytes / 1e6 / max(dt - roundtrip, 1e-9)

    return {
        "device": str(device),
        "size_mb": payload_bytes / 1e6,
        "reps": reps,
        "roundtrip_s": roundtrip,
        "roundtrip_min_s": min(rts),
        "roundtrip_max_s": max(rts),
        "up_mb_s": bandwidth(statistics.median(ups)),
        "down_mb_s": bandwidth(statistics.median(downs)),
        "up_s": ups,
        "down_s": downs,
    }
