"""Host milliseconds a speaker costs in the threefry draws (the program's
``prng/*`` regions), over the traced speakers."""

from portbench.harness import readers

UNIT = "ms/speaker"


def read(ctx):
    return readers.span_ms_per(ctx, "lm_cohort", "prng/", "speakers")
