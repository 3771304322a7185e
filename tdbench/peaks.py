"""The card's published peaks and the least time of the work the cells do.

NVIDIA H100 SXM data sheet, dense rates: 989 TFLOP/s in bfloat16, 3.35
TB/s of HBM3. 32-bit integer operations: 132 SMs x 64 INT32 lanes x 1.98
GHz (boost) = 16.7 T/s.
"""
from __future__ import annotations

import math

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# the least integer work of one Philox4x32-10 block: 10 rounds of two 32x32
# -> 64-bit products (four multiply halves) and two three-input XORs
PHILOX_OPS = 60
VOXELS = 21 ** 3


def convs(config: dict) -> list[tuple[int, int, int]]:
    """(kernel edge, Cin, Cout) of each convolution of a TIMED configuration."""
    widths = [config["in_channels"], *config["filters"]]
    return [(3, a, b) for a, b in zip(widths, widths[1:])] + [(1, widths[-1], config["n_classes"])]


def forward_flop_per_frame(config: dict) -> int:
    """Multiply-adds x 2 of one frame's forward: every convolution;
    BatchNorm, ELU and pooling not counted."""
    return sum(2 * k ** 3 * a * b * VOXELS for k, a, b in convs(config))


def conv_least_s(config: dict, frames: int, training: bool = False,
                 value_bytes: int = 2) -> float:
    """Least time of the convolutions of ``frames`` frames: per convolution
    and pass the larger of its operations over the bf16 peak and its bytes
    (each input read once, the output written once, ``value_bytes`` a value)
    over the memory rate. A forward is one pass; a training step adds the
    weight gradient of every convolution and the data gradient of all but
    the first, whose input needs none."""
    total = 0.0
    for i, (k, a, b) in enumerate(convs(config)):
        flop = 2 * k ** 3 * a * b * VOXELS * frames
        moved = value_bytes * (VOXELS * frames * (a + b) + k ** 3 * a * b)
        passes = 1 if not training else (2 if i == 0 else 3)
        total += passes * max(flop / BF16_FLOPS, moved / HBM_BYTES_PER_S)
    return total


def sample_least_s(L: int, C: int, n: int) -> float:
    """Least time of n draws at each of L positions from (L, C) float32
    probabilities mapped to 20 amino acids: the probabilities, the uint8
    codes, the (n, 20) int32 counts and the class map moved once over the
    memory rate, or a Philox block and ceil(log2(C+1)) compares a draw over
    the integer rate, whichever is longer."""
    t_bytes = (L * C * 4 + n * L + n * 20 * 4 + C) / HBM_BYTES_PER_S
    t_ops = n * L * (PHILOX_OPS + math.ceil(math.log2(C + 1))) / INT32_OPS_PER_S
    return max(t_bytes, t_ops)
