"""td-predict's frame set, host microseconds an atom record: the program's
`frame_set` spans (`voxel/dataset.py::make_frame_set`) over its
`frame_set.atoms` counter, the atom records its files held, in the window."""
from tdbench import program_trace

program_trace.install()


def read(record):
    r = program_trace.of(record) if record.get("kind") == "predict" else None
    atoms = r["counters"].get("frame_set.atoms") if r else None
    if not atoms:
        return None
    return 1e6 * program_trace.span_seconds(r, "frame_set") / atoms
