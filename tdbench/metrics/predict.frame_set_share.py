"""The share of the passes' wall time spent in `make_frame_set` (host
clock around the call)."""


def read(record):
    passes = record.get("passes")
    if not passes:
        return None
    return 100.0 * sum(p["frame_set_s"] for p in passes) / sum(p["wall_s"] for p in passes)
