"""Share of the traced track in which no operation ran on the card."""

from portbench.harness import readers

UNIT = "%"


def read(ctx):
    return readers.idle_pct(ctx, "train")
