"""The TIMED head's share of its roofline: the least time of a batch's head
(`rotamer.head_least_s`: its bf16 input read once and its float32 output
written once over the memory rate, or projecting the pooled features at the
bf16 peak) over the median of the program's `timed.head` device spans."""
from tdbench import program_trace, rotamer

program_trace.install()


def read(record):
    cfg = record.get("config", {})
    if "filters" not in cfg or not record.get("batch"):
        return None
    ms = program_trace.median_device_ms(record, "predict", "timed.head")
    if not ms:
        return None
    return 100.0 * rotamer.head_least_s(cfg, record["batch"]) / (ms / 1e3)
