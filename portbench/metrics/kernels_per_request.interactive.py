"""Device kernels launched a request in the traced window."""

from portbench.harness import readers

UNIT = "kernels/request"


def read(ctx):
    return readers.kernels_per(ctx, "interactive", "requests")
