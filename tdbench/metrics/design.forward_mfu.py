"""The FLOPs of the real (unpadded) frames served in the traced window over
the device time of the convolution kernels at the dense bf16 peak: the
share of the forward's convolution time that served real frames."""
from tdbench import kernels, peaks


def read(record):
    spent = kernels.seconds(record.get("kernels", {}), kernels.CONV)
    if not spent:
        return None
    return 100.0 * record["frames"] * record["flop_per_frame"] / (spent * peaks.BF16_FLOPS)
