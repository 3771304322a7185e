"""The sampling kernel's share of its roofline in the traced window: the
least time of every answered request's draws (`peaks.sample_least_s`) over
the device time of `sample_inverse_cdf_kernel`."""
from tdbench import kernels


def read(record):
    spent = kernels.seconds(record.get("kernels", {}), kernels.SAMPLE)
    if not spent:
        return None
    return 100.0 * record["sample_least_s"] / spent
