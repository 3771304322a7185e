"""A DenseNet forward's share of its roofline: the least time of a batch's
forward (`densenet.forward_least_s`: its FLOPs over the bf16 peak or the
convolutions' least bytes over the memory rate) over the median of the
program's `forward` device spans."""
from tdbench import densenet, program_trace

program_trace.install()


def read(record):
    cfg = record.get("config", {})
    if "growth_rate" not in cfg:
        return None
    ms = program_trace.median_device_ms(record, "predict", "forward")
    if not ms:
        return None
    return 100.0 * densenet.forward_least_s(cfg, record["batch"]) / (ms / 1e3)
