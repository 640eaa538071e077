"""The device an entry point runs on when its caller names none: the card
of this process's rank when it is one of a launched group
(:mod:`..parallel.distributed`), else the first card, and an error when
there is none (no silent run on the CPU)."""

from __future__ import annotations

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
