"""Voxelizers: atom arrays -> (R, V, V, V, C) frames; the port of
``timed_design_tpu/voxel/voxelize.py``.

``voxelize_frame_atoms`` (FrameAtoms + Codec) takes one of two
formulations, as the JAX package's does: ``impl="matmul"`` (the default),
the separable matrix products of ``ops/matmul_voxelize.py``, or
``impl="scatter"``, the segment sum of ``voxelize`` here, the only one with
the ``pdf`` spread. Both are plain PyTorch: neither the JAX package's
voxelizers nor these reach a TPU kernel.

The scatter formulation: every (residue, atom) pair puts the atom in the
residue's frame and spreads its unit density over the 27 voxels around its
nearest one (gaussian mode) or puts it in that voxel (boolean mode); the
weights go into one flat float32 buffer by ``index_add_``, where the
out-of-frame voxels and the dropped atoms go to one slot past the end, which
is cut off. Gaussian weights are the products of per-axis integrals of
N(0, sigma^2) over each voxel (``spread="integral"``) or of the density at
the voxels' centres (``"pdf"``), sigma the element's van der Waals radius,
divided by their sum over the 27 voxels. Property codecs (P, Q) add density
x the residue's property to the property channel. Work is chunked over
residues to bound the (chunk, A, 27) intermediates.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.special import erf

from ..ops.matmul_voxelize import voxelize_matmul
from .codec import Codec
from .frames import FrameAtoms

_SQRT2 = 1.4142135623730951
_CHUNK_BYTES = 256 * 1024 * 1024  # the scatter's (chunk, A, 27, 3) intermediates
# the 27 offsets of the voxels around the nearest one, x slowest
_NEIGHBORHOOD = np.stack(
    np.meshgrid(np.arange(-1, 2), np.arange(-1, 2), np.arange(-1, 2), indexing="ij"),
    axis=-1,
).reshape(27, 3)


def voxelize(
    atoms_xyz: torch.Tensor,  # (A, 3)
    atom_channel: torch.Tensor,  # (A,) int, -1 = dropped
    atom_sigma: torch.Tensor,  # (A,)
    atom_prop: torch.Tensor,  # (A,)
    ca: torch.Tensor,  # (R, 3)
    rot: torch.Tensor,  # (R, 3, 3)
    *,
    n_channels: int,
    prop_channel: int = -1,
    voxels_per_side: int = 21,
    voxel_size: float = 1.0,
    gaussian: bool = True,
    chunk: int | None = None,
    spread: str = "integral",
) -> torch.Tensor:
    """Voxelize every residue of one structure by a scatter-add. Returns
    (R, V, V, V, C) float32 on the inputs' device. ``spread`` (gaussian
    mode): ``"integral"`` or ``"pdf"``. ``chunk``: residues per pass; by
    default as many as keep the intermediates within 256 MB."""
    if spread not in ("integral", "pdf"):
        raise ValueError(f"Unknown spread {spread!r}")
    V, C = voxels_per_side, n_channels
    R, A = ca.shape[0], atoms_xyz.shape[0]
    center = (V - 1) / 2.0
    dev = ca.device
    if chunk is None:
        chunk = max(1, _CHUNK_BYTES // (max(A, 1) * 27 * 3 * 4 * 4))
    neighborhood = torch.as_tensor(_NEIGHBORHOOD, dtype=torch.float32, device=dev)
    channel = atom_channel.to(torch.int64)
    sigma = atom_sigma[None, :, None, None]
    frames = torch.empty((R, V, V, V, C), dtype=torch.float32, device=dev)
    for s in range(0, R, chunk):
        ca_c, rot_c = ca[s : s + chunk], rot[s : s + chunk]
        r = ca_c.shape[0]
        rel = atoms_xyz[None, :, :] - ca_c[:, None, :]  # (r, A, 3)
        g = torch.einsum("rij,raj->rai", rot_c, rel) / voxel_size + center
        if gaussian:
            v = torch.round(g)[:, :, None, :] + neighborhood  # (r, A, 27, 3)
            if spread == "integral":
                lo = (v - 0.5 - g[:, :, None, :]) * voxel_size
                hi = lo + voxel_size
                w_axes = 0.5 * (erf(hi / (sigma * _SQRT2)) - erf(lo / (sigma * _SQRT2)))
            else:
                d = (v - g[:, :, None, :]) * voxel_size
                w_axes = torch.exp(-0.5 * (d / sigma) ** 2)  # the density up to a constant
            w = w_axes.prod(dim=-1)  # (r, A, 27)
            w = w / w.sum(-1, keepdim=True).clamp_min(1e-12)
        else:
            v = torch.round(g)[:, :, None, :]  # (r, A, 1, 3)
            w = torch.ones(v.shape[:3], dtype=torch.float32, device=dev)
        vi = v.to(torch.int64)
        valid = ((vi >= 0) & (vi < V)).all(-1) & (channel >= 0)[None, :, None]
        size = r * V * V * V * C
        r_idx = torch.arange(r, device=dev)[:, None, None]
        voxel = ((r_idx * V + vi[..., 0]) * V + vi[..., 1]) * V + vi[..., 2]
        out = torch.zeros(size + 1, dtype=torch.float32, device=dev)  # slot `size`: dropped
        out.index_add_(0, torch.where(valid, voxel * C + channel[None, :, None], size).reshape(-1),
                       w.reshape(-1))
        if prop_channel >= 0:
            out.index_add_(0, torch.where(valid, voxel * C + prop_channel, size).reshape(-1),
                           (w * atom_prop[None, :, None]).reshape(-1))
        frames[s : s + r] = out[:size].view(r, V, V, V, C)
    if not gaussian:
        # occupancy saturates at 1; the signed property channel at +-1
        frames.clamp_(max=1.0)
        if prop_channel >= 0:
            frames[..., prop_channel].clamp_(min=-1.0)
    return frames


def voxelize_frame_atoms(
    fa: FrameAtoms,
    codec: Codec,
    voxels_per_side: int = 21,
    frame_edge_length: float = 21.0,
    gaussian: bool = True,
    chunk: int | None = None,
    impl: str = "matmul",
    spread: str = "integral",
    *,
    device: torch.device | str,
) -> torch.Tensor:
    """Voxelize one structure on ``device`` (named by the caller: there is
    no default); returns float32 frames there.

    ``impl``: ``"matmul"`` (``ops/matmul_voxelize.py``) or ``"scatter"``
    (``voxelize``); a ``spread`` other than ``"integral"`` takes the scatter,
    the only one that has it. The atom and frame arrays cross to the device
    as one float32 buffer, one copy per structure; on a card it goes through
    pinned memory, so the copy queues behind the device's work instead of
    waiting for it."""
    if spread != "integral" and impl == "matmul":
        impl = "scatter"
    if impl == "matmul":
        fn = voxelize_matmul
    elif impl == "scatter":
        fn = functools.partial(voxelize, spread=spread)
    else:
        raise ValueError(f"Unknown voxelizer impl {impl!r}")
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
    return fn(
        xyz.view(A, 3), channel.to(torch.int32), sigma, atom_prop,
        ca.view(R, 3), rot.view(R, 3, 3),
        n_channels=codec.n_channels,
        prop_channel=codec.channels.index(prop) if prop else -1,
        voxels_per_side=voxels_per_side,
        voxel_size=frame_edge_length / voxels_per_side,
        gaussian=gaussian,
        chunk=chunk,
    )
