"""The share of the passes' wall time in the `decode` and `write` phases of
`PredictionResult.timings` (the `_rot.csv` writer thread runs inside
`predict` and is not in it)."""


def read(record):
    passes = record.get("passes")
    if not passes:
        return None
    spent = sum(p["timings"].get("decode", 0.0) + p["timings"].get("write", 0.0) for p in passes)
    return 100.0 * spent / sum(p["wall_s"] for p in passes)
