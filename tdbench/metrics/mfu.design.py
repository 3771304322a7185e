"""The whole window's share of the dense bf16 peak: the FLOPs of the real
frames served over the traced window's wall time."""
from tdbench import peaks


def read(record):
    if not record.get("window_s"):
        return None
    return 100.0 * record["frames"] * record["flop_per_frame"] / (
        record["window_s"] * peaks.BF16_FLOPS)
