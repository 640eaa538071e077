"""Useful model operations of the traced track (forward and backward of
the valid train rows, the evaluation's forward; ``counts.flops``) over
its time, against the fp32 peak."""

from portbench.harness import readers

UNIT = "%"


def read(ctx):
    return readers.mfu_pct(ctx, "train")
