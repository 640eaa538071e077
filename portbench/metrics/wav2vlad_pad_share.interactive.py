"""Share of the samples the wav2vlad length buckets processed that are
padding (rows rounded up to 8, lengths to the bucket's power of two), from
the program's ``wav2vlad/bucket*`` records in the traced window."""

from portbench.harness import program

UNIT = "%"


def read(ctx):
    return program.pad_share_pct(ctx, "interactive")
