"""Device kernels a stacked training step (all folds) in the traced track,
evaluation and gate included: the launch count the dropout draws
inflate."""

from portbench.harness import readers

UNIT = "kernels/step"


def read(ctx):
    return readers.kernels_per(ctx, "train", "steps")
