"""The LSTMP forward kernel's share of its roofline: its least time from the
sentences' real token counts (``counts.flops.lstmp_fwd``) over the device
time of its kernels."""

from portbench.harness import readers

UNIT = "%"


def read(ctx):
    return readers.roofline_pct(ctx, "cohort", "lstmp_fwd",
                                ("lstmp_fwd_",))
