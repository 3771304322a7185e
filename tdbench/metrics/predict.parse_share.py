"""The share of the passes' wall time in the program's `frame_set.parse`
spans: `load_pdb` of each file in `voxel/dataset.py::make_frame_set`."""
from tdbench import program_trace

program_trace.install()


def read(record):
    return program_trace.pass_share(record, "frame_set.parse")
