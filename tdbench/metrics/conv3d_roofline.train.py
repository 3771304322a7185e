"""The training convolutions' share of their roofline: the least time of
the forward, the weight gradients and the data gradients of every frame
trained in the window (`peaks.conv_least_s(training=True)`) over the
device time of the convolution kernels."""
from tdbench import kernels, peaks


def read(record):
    spent = kernels.seconds(record.get("kernels", {}), kernels.CONV)
    if not spent or record.get("kind") != "train":
        return None
    return 100.0 * peaks.conv_least_s(record["config"], record["frames"], training=True) / spent
