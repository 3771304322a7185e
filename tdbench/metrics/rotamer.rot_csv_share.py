"""The share (%) of the `predict` phase that the `csv-writer` thread spent
writing the full-precision `_rot.csv`: the program's `write.rot_csv` spans
(`engine/predictor.py::load_dataset_and_predict`) over its `predict`
spans; nothing where the program records no such span."""
from tdbench import program_trace

program_trace.install()


def read(record):
    r = program_trace.of(record) if record.get("kind") == "predict" else None
    if r is None or not any(s[0] == "write.rot_csv" for s in r["spans"]):
        return None
    return program_trace.predict_share(r, "write.rot_csv")
