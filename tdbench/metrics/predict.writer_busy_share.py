"""The share of the `predict` phase the `csv-writer` thread was busy: the
program's `write_batch` spans over its `predict` spans."""
from tdbench import program_trace

program_trace.install()


def read(record):
    return program_trace.predict_share(record, "write_batch")
