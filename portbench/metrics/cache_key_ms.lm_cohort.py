"""Host milliseconds a speaker costs on the feature cache's blake2b keys
(the program's ``serve/cache_key`` regions), over the traced speakers."""

from portbench.harness import readers

UNIT = "ms/speaker"


def read(ctx):
    return readers.span_ms_per(ctx, "lm_cohort", "serve/cache_key",
                               "speakers")
