"""Useful model operations (``counts.flops``, from the inputs' unpadded
sizes) over the traced window's time, against the fp32 peak."""

from portbench.harness import readers

UNIT = "%"


def read(ctx):
    return readers.mfu_pct(ctx, "cohort")
