"""The device time of DenseNet's work between and after its dense blocks
a batch: the sum of the medians of the program's `densenet.transition`
device spans of each id and of its `densenet.head` span (the last
BN-ReLU, the global pooling and the Dense head)."""
from tdbench import densenet, program_trace

program_trace.install()


def read(record):
    return densenet.span_ms(record, ("densenet.transition", "densenet.head"))
