"""The device time of DenseNet's three dense blocks a batch: the sum over
the blocks of the median of the program's `densenet.block` device spans of
that block's id (CUDA events around each block in `models/densenet.py`)."""
from tdbench import densenet, program_trace

program_trace.install()


def read(record):
    return densenet.span_ms(record, ("densenet.block",))
