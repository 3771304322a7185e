"""The share of DenseNet's BatchNorm-ReLUs that ran through a dense block's
buffer and its fused pass, in %: the program's `densenet.bn_relu.fused`
counter over the sum of it and `densenet.bn_relu.plain` (those that ran as
float32 BatchNorm and ReLU modules), in `models/densenet.py`."""
from tdbench import program_trace

program_trace.install()


def read(record):
    r = program_trace.of(record) if record.get("kind") == "predict" else None
    counters = r["counters"] if r else {}
    fused = counters.get("densenet.bn_relu.fused", 0)
    total = fused + counters.get("densenet.bn_relu.plain", 0)
    return 100.0 * fused / total if total else None
