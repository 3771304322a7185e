"""The whole pass's share of the dense bf16 peak: the traced run's frames a
second times the forward's FLOPs a frame."""
from tdbench import peaks


def read(record):
    if not record.get("window_s") or record.get("kind") != "predict":
        return None
    return 100.0 * record["frames"] * record["flop_per_frame"] / (
        record["window_s"] * peaks.BF16_FLOPS)
