"""The grouped-expert kernel's share of its roofline: its least time from
the answers' real token counts (``counts.moe_lm.moe_experts``, both
launches of every expert layer) over the device time of its kernels."""

from portbench.harness import readers

UNIT = "%"


def read(ctx):
    return readers.roofline_pct(ctx, "lm_cohort", "moe_experts",
                                ("moe_experts_",))
