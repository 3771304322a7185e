"""A DenseNet configuration's work, from its widths (``configs/densecpd.json``):
its convolutions, its FLOPs a frame, the least time of its convolutions and
of its whole forward on the card (``peaks``' rates), which kernels are its
convolutions, and the device time of its spans in a traced window."""
from __future__ import annotations

import re
import statistics

from . import kernels, peaks, program_trace

# the convolution kernels of a DenseNet forward on an H100: ``kernels.CONV``'s
# names, and cuBLAS's own bf16 GEMMs (``nvjet_tst_...``: bf16 operands and
# output, float32 sums) that most 1^3 convolutions run as
CONV = re.compile(kernels.CONV.pattern + r"|^nvjet_t[a-z]t_", re.IGNORECASE)


def convs(config: dict) -> list[tuple[int, int, int, int]]:
    """(kernel edge, Cin, Cout, voxels a frame) of each convolution, in
    the forward's order: the 3^3 stem; per dense layer a 1^3 bottleneck to
    4 x growth and a 3^3 convolution to growth; per transition a 1^3
    convolution to ``compression`` of the channels, after which 2^3 pooling
    halves the edge (floored)."""
    edge, g = config["frame"][0], config["growth_rate"]
    c = config["init_features"]
    out = [(3, config["in_channels"], c, edge ** 3)]
    blocks = config["block_layers"]
    for b, n in enumerate(blocks):
        for _ in range(n):
            out += [(1, c, 4 * g, edge ** 3), (3, 4 * g, g, edge ** 3)]
            c += g
        if b < len(blocks) - 1:
            out.append((1, c, int(c * config["compression"]), edge ** 3))
            c, edge = int(c * config["compression"]), edge // 2
    return out


def features(config: dict) -> int:
    """The channels the Dense head reads."""
    c = config["init_features"]
    for b, n in enumerate(config["block_layers"]):
        c += n * config["growth_rate"]
        if b < len(config["block_layers"]) - 1:
            c = int(c * config["compression"])
    return c


def forward_flop_per_frame(config: dict) -> int:
    """Multiply-adds x 2 of one frame's forward: every convolution and the
    Dense head; BatchNorm, ReLU, concatenation and pooling not counted."""
    return (sum(2 * k ** 3 * a * b * v for k, a, b, v in convs(config))
            + 2 * features(config) * config["n_classes"])


def conv_least_s(config: dict, frames: int, value_bytes: int = 2) -> float:
    """Least time of the forward convolutions of ``frames`` frames, as
    ``peaks.conv_least_s`` counts it: per convolution the larger of its
    operations over the bf16 peak and its bytes (input read once, output
    written once, weights once) over the memory rate."""
    total = 0.0
    for k, a, b, v in convs(config):
        flop = 2 * k ** 3 * a * b * v * frames
        moved = value_bytes * (v * frames * (a + b) + k ** 3 * a * b)
        total += max(flop / peaks.BF16_FLOPS, moved / peaks.HBM_BYTES_PER_S)
    return total


def forward_least_s(config: dict, frames: int, value_bytes: int = 2) -> float:
    """Least time of a forward of ``frames`` frames as a whole: the larger
    of its FLOPs over the bf16 peak and its least bytes over the memory
    rate, the least bytes being each convolution's input and output moved
    once and its weights once, concatenation, BatchNorm and ReLU free."""
    flop = forward_flop_per_frame(config) * frames
    moved = value_bytes * sum(v * frames * (a + b) + k ** 3 * a * b
                              for k, a, b, v in convs(config))
    return max(flop / peaks.BF16_FLOPS, moved / peaks.HBM_BYTES_PER_S)


def span_ms(record: dict, names) -> float | None:
    """The sum over the program's device spans of ``names``, each (name,
    id) taken once at its median (a forward records each once), in ms;
    None where the window holds none of them."""
    r = program_trace.of(record) if record.get("kind") == "predict" else None
    by_span: dict = {}
    for name, id_, ms in r["device_spans"] if r else ():
        if name in names:
            by_span.setdefault((name, id_), []).append(ms)
    return sum(statistics.median(v) for v in by_span.values()) if by_span else None
