"""The share of the voxelizer's frame-atom pairs that are padding, in
td-predict: 1 - `voxelize.pairs_real` / `voxelize.pairs_computed`, the
program's counters in `FrameSet.voxelize_rows`."""
from tdbench import program_trace

program_trace.install()


def read(record):
    return program_trace.pad_share(record, "predict")
