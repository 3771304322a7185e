"""Which device kernels of a profiler trace do which work, by name."""
from __future__ import annotations

import re

# cuDNN's convolution kernels (forward, data and weight gradients) on an
# H100: implicit GEMMs, the named convolution kernels, and the bf16 GEMMs
# that it runs the 1^3 head as (the voxelizer's products are float32)
CONV = re.compile(r"fprop|dgrad|wgrad|implicit|conv|bf16.*gemm|gemm.*bf16", re.IGNORECASE)
SAMPLE = re.compile(r"sample_inverse_cdf")


def seconds(kernels: dict, pattern: re.Pattern) -> float:
    """Device seconds of the kernels whose name matches ``pattern``."""
    return sum(s for name, s in kernels.items() if pattern.search(name))
