"""Device kernels launched a speaker in the traced window."""

from portbench.harness import readers

UNIT = "kernels/speaker"


def read(ctx):
    return readers.kernels_per(ctx, "cohort", "speakers")
