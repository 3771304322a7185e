"""The training window's share of the dense bf16 peak: frames a second
times three forwards' FLOPs a frame (forward, data and weight gradients)."""
from tdbench import peaks


def read(record):
    if not record.get("window_s") or record.get("kind") != "train":
        return None
    return 100.0 * 3 * record["frames"] * record["flop_per_frame"] / (
        record["window_s"] * peaks.BF16_FLOPS)
