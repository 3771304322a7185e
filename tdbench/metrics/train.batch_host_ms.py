"""The median host time of a step's `train.next_batch` and `train.step`
spans in `fit`: the loader's lookups and voxelization launch, the batch to
the device and the step's launch."""
import statistics

from tdbench import program_trace

program_trace.install()


def read(record):
    r = program_trace.of(record) if record.get("kind") == "train" else None
    if r is None:
        return None
    parts: dict = {}
    for name, a, b, _, step in r["spans"]:
        if name in ("train.next_batch", "train.step"):
            parts.setdefault(step, {})[name] = (b - a) / 1e3
    ms = [sum(p.values()) for p in parts.values() if len(p) == 2]
    return statistics.median(ms) if ms else None
