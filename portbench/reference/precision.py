"""The products of the plain references, in the precision asked for.

``"fp32"`` is full float32: TF32 is off for matrix products and cuDNN
convolutions.  ``"tf32"`` is the control's precision, the next below the
configurations' float32: on a card the products run with TF32 switched
on, as a later change might switch it on; on the CPU, which has no TF32,
each operand is rounded to TF32's 10-bit mantissa before a float32
product, which is what the tensor cores compute.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "tf32")


@contextlib.contextmanager
def tf32(on: bool):
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties away);
    a gradient passes through it unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return x + (bits.view(torch.float32) - x).detach()


def _check(prec: str) -> None:
    if prec not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{prec!r}")


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    _check(prec)
    if prec == "tf32" and a.device.type != "cuda":
        a, b = round_tf32(a), round_tf32(b)
    with tf32(prec == "tf32"):
        return torch.matmul(a, b)


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           prec: str) -> torch.Tensor:
    _check(prec)
    if prec == "tf32" and x.device.type != "cuda":
        x, w = round_tf32(x), round_tf32(w)
    with tf32(prec == "tf32"):
        return F.conv1d(x, w, b)
