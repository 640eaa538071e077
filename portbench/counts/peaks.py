"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit).  The port computes in float32 with TF32 off,
so its yardstick is the float32 rate outside the tensor cores."""

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the fp32 peak and the bytes over the memory rate."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
