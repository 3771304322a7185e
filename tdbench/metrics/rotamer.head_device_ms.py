"""The median of the program's `timed.head` device spans (CUDA events around
the head's 1^3 convolution, its float32 cast and the global pooling in
`models/timed.py::TIMED.forward`), one a batch."""
from tdbench import program_trace

program_trace.install()


def read(record):
    return program_trace.median_device_ms(record, "predict", "timed.head")
