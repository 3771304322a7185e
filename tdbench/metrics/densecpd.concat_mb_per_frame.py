"""The bytes DenseNet's concatenations write a frame, in MB (1e6 bytes):
the program's `densenet.concat_bytes` counter (each `torch.cat` output's
bytes, in `models/densenet.py`) over the frames of the device batches,
padded rows included."""
from tdbench import program_trace

program_trace.install()


def read(record):
    r = program_trace.of(record) if record.get("kind") == "predict" else None
    written = r["counters"].get("densenet.concat_bytes") if r else None
    if not written or not record.get("device_frames"):
        return None
    return written / record["device_frames"] / 1e6
