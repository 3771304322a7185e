"""The median of the CUDA-event times around each training step of the
traced window (`make_train_step` wrapped from the benchmark's side)."""
import statistics


def read(record):
    steps = record.get("step_ms")
    return statistics.median(steps) if steps else None
