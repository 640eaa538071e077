"""Share of the traced window in which no operation ran on the card."""

from portbench.harness import readers

UNIT = "%"


def read(ctx):
    return readers.idle_pct(ctx, "cohort")
