"""The device's idle share of the traced window."""

from portbench.harness import readers

UNIT = "%"


def read(ctx):
    return readers.idle_pct(ctx, "lm_cohort")
