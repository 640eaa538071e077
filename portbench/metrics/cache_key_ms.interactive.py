"""Host milliseconds a request spends on the feature cache's blake2b keys
(the program's ``serve/cache_key`` regions, audio and text), over the
traced requests."""

from portbench.harness import readers

UNIT = "ms/request"


def read(ctx):
    return readers.span_ms_per(ctx, "interactive", "serve/cache_key",
                               "requests")
