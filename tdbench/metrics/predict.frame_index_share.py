"""The share of the passes' wall time in the program's `frame_set.index`
spans: the `FrameSet`'s key index, label rows and flat tables."""
from tdbench import program_trace

program_trace.install()


def read(record):
    return program_trace.pass_share(record, "frame_set.index")
