"""The share of the `predict` phase the main thread spent blocked on a
batch's results: the program's `fetch_wait` spans over its `predict`
spans."""
from tdbench import program_trace

program_trace.install()


def read(record):
    return program_trace.predict_share(record, "fetch_wait")
