"""Host milliseconds a request spends in the threefry draws (the
program's ``prng/*`` regions: NetVLAD's fold_in, split and normals in each
length bucket), over the traced requests."""

from portbench.harness import readers

UNIT = "ms/request"


def read(ctx):
    return readers.span_ms_per(ctx, "interactive", "prng/", "requests")
