"""The median of the program's `voxelize` device spans in training: CUDA
events around each shuffled batch's `FrameSet.voxelize_rows`."""
from tdbench import program_trace

program_trace.install()


def read(record):
    return program_trace.median_device_ms(record, "train", "voxelize")
