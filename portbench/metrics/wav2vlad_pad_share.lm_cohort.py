"""Share of the samples the wav2vlad length buckets processed that are
padding, from the program's ``wav2vlad/bucket*`` records in the traced
window."""

from portbench.harness import program

UNIT = "%"


def read(ctx):
    return program.pad_share_pct(ctx, "lm_cohort")
