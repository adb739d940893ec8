"""Published peaks of the card the benchmark runs on, stated once.

NVIDIA H100 SXM5 80 GB data sheet, dense rates without sparsity: 989.4
TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of HBM3 bandwidth.
Those rates assume the card's full power limit of 700 W; every result
line carries the limit the card was set to (``device.power_limit_w``),
so a share of a peak is read beside it.
"""
BF16_FLOPS = 989e12  # FLOP/s, dense bf16 tensor cores
HBM_BYTES = 3.35e12  # bytes/s
PEAK_POWER_W = 700.0  # the power limit the two rates above assume
SOURCE = "NVIDIA H100 SXM5 80GB data sheet: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3, at 700 W"


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the bf16 peak and the bytes at the HBM peak."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
