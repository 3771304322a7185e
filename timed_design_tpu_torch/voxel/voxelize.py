"""Voxelizer entry point: FrameAtoms + Codec -> (R, V, V, V, C) frames.

The port of ``voxelize_frame_atoms`` (timed_design_tpu/voxel/voxelize.py)
with its default formulation, the separable matrix products of
``ops/matmul_voxelize.py`` and the per-axis ``integral`` spread. The scatter
voxelizer and its ``pdf`` spread are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.matmul_voxelize import voxelize_matmul
from .codec import Codec
from .frames import FrameAtoms


def voxelize_frame_atoms(
    fa: FrameAtoms,
    codec: Codec,
    voxels_per_side: int = 21,
    frame_edge_length: float = 21.0,
    gaussian: bool = True,
    chunk: int | None = None,
    *,
    device: torch.device | str,
) -> torch.Tensor:
    """Voxelize one structure on ``device`` (named by the caller: there is
    no default); returns float32 frames there.

    The atom and frame arrays cross to the device as one float32 buffer,
    one copy per structure; on a card it goes through pinned memory, so the
    copy queues behind the device's work instead of waiting for it."""
    prop = codec.property_channel
    A, R = fa.atom_channel.shape[0], fa.ca.shape[0]
    host = torch.from_numpy(np.concatenate([
        fa.atoms_xyz.ravel(), fa.atom_channel, fa.atom_sigma, fa.atom_prop,
        fa.ca.ravel(), fa.rot.ravel(),
    ]).astype(np.float32))  # channel ids are small integers, exact in float32
    if torch.device(device).type == "cuda":
        host = host.pin_memory()
    xyz, channel, sigma, atom_prop, ca, rot = host.to(device, non_blocking=True).split(
        [3 * A, A, A, A, 3 * R, 9 * R])
    return voxelize_matmul(
        xyz.view(A, 3), channel.to(torch.int32), sigma, atom_prop,
        ca.view(R, 3), rot.view(R, 3, 3),
        n_channels=codec.n_channels,
        prop_channel=codec.channels.index(prop) if prop else -1,
        voxels_per_side=voxels_per_side,
        voxel_size=frame_edge_length / voxels_per_side,
        gaussian=gaussian,
        chunk=chunk,
    )
