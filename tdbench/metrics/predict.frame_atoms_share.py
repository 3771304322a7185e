"""The share of the passes' wall time in the program's
`frame_set.frame_atoms` spans: `structure_to_frame_atoms` (and the NMR
states' alignment) of each file in `voxel/dataset.py::make_frame_set`."""
from tdbench import program_trace

program_trace.install()


def read(record):
    return program_trace.pass_share(record, "frame_set.frame_atoms")
