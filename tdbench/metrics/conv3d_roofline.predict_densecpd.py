"""DenseNet's convolutions' share of their roofline in the traced window:
the least time of every device batch's convolutions (`densenet.conv_least_s`,
from the configuration's widths, padded rows included as the kernels
compute them) over the device time of the convolution kernels
(`densenet.CONV`: cuDNN's, and the bf16 cuBLAS GEMMs that 1^3
convolutions run as)."""
from tdbench import densenet, kernels


def read(record):
    spent = kernels.seconds(record.get("kernels", {}), densenet.CONV)
    if not spent or "growth_rate" not in record.get("config", {}):
        return None
    return 100.0 * densenet.conv_least_s(record["config"], record["device_frames"]) / spent
