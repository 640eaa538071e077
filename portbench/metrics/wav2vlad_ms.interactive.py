"""Host milliseconds a request spends in the wav2vlad length buckets (the
program's ``wav2vlad/bucket*`` regions), over the traced requests."""

from portbench.harness import readers

UNIT = "ms/request"


def read(ctx):
    return readers.span_ms_per(ctx, "interactive", "wav2vlad/bucket",
                               "requests")
