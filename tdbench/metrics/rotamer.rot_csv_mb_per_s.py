"""The rate of the full-precision `_rot.csv` writer, in MB (1e6 bytes) a
second: the bytes of the window's rows (`rotamer.rot_csv_bytes`, fixed by the
`%.18e` format) over the summed seconds of the program's `write.rot_csv`
spans, the text and the file's write together; nothing where the program
records no such span."""
from tdbench import program_trace, rotamer

program_trace.install()


def read(record):
    r = program_trace.of(record) if record.get("kind") == "predict" else None
    seconds = program_trace.span_seconds(r, "write.rot_csv") if r else 0.0
    if not seconds or "n_classes" not in record.get("config", {}):
        return None
    return rotamer.rot_csv_bytes(record["config"], record["frames"]) / seconds / 1e6
