"""The median of the program's `train.step_device` device spans: CUDA events
inside `fit` around each step's forward, backward and Adam (the inside twin
of `train.step_ms`)."""
from tdbench import program_trace

program_trace.install()


def read(record):
    return program_trace.median_device_ms(record, "train", "train.step_device")
