"""Frames over the `predict` phase of `load_dataset_and_predict`'s
`PhaseTimer` (voxelization, forwards and the writer thread)."""


def read(record):
    passes = record.get("passes")
    if not passes:
        return None
    return sum(p["frames"] for p in passes) / sum(p["timings"]["predict"] for p in passes)
