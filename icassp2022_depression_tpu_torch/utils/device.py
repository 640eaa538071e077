"""The device an entry point runs on when its caller names none: the first
card, and an error when there is none (no silent run on the CPU)."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The first card; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "false); pass --device cpu (or device='cpu') to run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device``, or :func:`default_device` when it is None."""
    return default_device() if device is None else torch.device(device)
