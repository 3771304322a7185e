"""The share (%) of td-predict's frame-set files that a worker process
parsed and turned into frame atoms, in the window: the program's
`frame_set.pooled_files` counter over its `frame_set.files`
(`voxel/dataset.py::make_frame_set`, the pool of `voxel/frame_pool.py`)."""
from tdbench import program_trace

program_trace.install()


def read(record):
    r = program_trace.of(record) if record.get("kind") == "predict" else None
    files = r["counters"].get("frame_set.files") if r else None
    if not files:
        return None
    return 100.0 * r["counters"].get("frame_set.pooled_files", 0) / files
