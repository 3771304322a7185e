"""The convolutions' share of their roofline in the traced window: the
least time of every device batch's convolutions (`peaks.conv_least_s`,
from the configuration's shapes, padded rows included as the kernels
compute them) over the device time of the convolution kernels."""
from tdbench import kernels, peaks


def read(record):
    spent = kernels.seconds(record.get("kernels", {}), kernels.CONV)
    if not spent or "device_frames" not in record:
        return None
    return 100.0 * peaks.conv_least_s(record["config"], record["device_frames"]) / spent
