"""Host milliseconds a speaker costs in the wav2vlad length buckets (the
program's ``wav2vlad/bucket*`` regions), over the traced speakers."""

from portbench.harness import readers

UNIT = "ms/speaker"


def read(ctx):
    return readers.span_ms_per(ctx, "cohort", "wav2vlad/bucket",
                               "speakers")
