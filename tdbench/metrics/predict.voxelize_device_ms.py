"""The median of the program's `voxelize` device spans (CUDA events around
`FrameSet.voxelize_rows` in `FrameBatchSource`), one a batch."""
from tdbench import program_trace

program_trace.install()


def read(record):
    return program_trace.median_device_ms(record, "predict", "voxelize")
