"""The share of the device's idle time in the traced window with no
program span open on the main thread: `idle_by_span[""]` over all of
`idle_by_span`."""
from tdbench import program_trace

program_trace.install()


def read(record):
    r = program_trace.of(record) if record.get("kind") == "predict" else None
    idle = sum(r["idle_by_span"].values()) if r else 0.0
    return 100.0 * r["idle_by_span"][""] / idle if idle else None
