"""The median of the program's `forward` device spans (CUDA events around
the models' `run_device_batch` in `load_dataset_and_predict`), one a
batch."""
from tdbench import program_trace

program_trace.install()


def read(record):
    return program_trace.median_device_ms(record, "predict", "forward")
