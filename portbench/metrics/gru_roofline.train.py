"""The GRU recurrence kernels' share of their roofline in training (the
forward and backward kernels under graph replay): their least time from
the folds' valid rows (``counts.flops.gru_launch`` and
``gru_bwd_launch``) over their device time.  The kernels are those of
``csrc/gru_fwd.cu`` and ``csrc/gru_bwd.cu``, with the backward's step
helpers from ``csrc/rnn_bwd_step.cuh`` (shared with the LSTM's, which
does not run in this cell)."""

from portbench.harness import readers

UNIT = "%"
GRU_KERNELS = ("gru_", "gates_kernel", "dw_kernel", "dw_finish_kernel")


def read(ctx):
    return readers.roofline_pct(ctx, "train", "gru", GRU_KERNELS)
