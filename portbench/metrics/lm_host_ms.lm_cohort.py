"""Host milliseconds a speaker spends in the text embedder's regions (the
program's ``lm/*``: ``lm/embed`` and all inside it), over the traced
speakers."""

from portbench.harness import readers

UNIT = "ms/speaker"


def read(ctx):
    return readers.span_ms_per(ctx, "lm_cohort", "lm/", "speakers")
