"""The work of a TIMED head that cannot be avoided, from the configuration's
widths (``configs/timed_rotamer.json``): the least time of the head of a
batch on the card at ``peaks``' rates; and the size of the full-precision
``_rot.csv`` that td-predict writes for it."""
from __future__ import annotations

from . import peaks


def head_least_s(config: dict, frames: int) -> float:
    """Least time of the head (the 1^3 projection, the float32 cast and the
    global pooling) of ``frames`` frames: its bf16 input of ``filters[-1]``
    channels at every voxel read once and its (frames, n_classes) float32
    output written once, over the memory rate; or, if longer, the operations
    of projecting the pooled features over the bf16 peak. The same work
    whatever computes the head: projecting every voxel, then pooling, does
    more and counts no more."""
    width, classes = config["filters"][-1], config["n_classes"]
    voxels = 1
    for edge in config["frame"]:
        voxels *= edge
    moved = frames * (2 * voxels * width + 4 * classes)
    flop = 2 * frames * width * classes
    return max(moved / peaks.HBM_BYTES_PER_S, flop / peaks.BF16_FLOPS)


# a probability in [0, 1] as ``%.18e`` is 24 characters (two exponent digits
# down to float32's least subnormal), then a ',' or the row's '\n'
ROT_CSV_CELL_BYTES = 25


def rot_csv_bytes(config: dict, frames: int) -> int:
    """Bytes of the ``_rot.csv`` rows of ``frames`` frames: one row of
    ``n_classes`` fixed-width cells a frame."""
    return frames * config["n_classes"] * ROT_CSV_CELL_BYTES
