"""Voxelization as batched matrix products (plain PyTorch).

The port of ``timed_design_tpu/ops/matmul_voxelize.py``, which is plain JAX
(no Pallas kernel). The per-atom density is a product of per-axis Gaussian
integrals, so for a residue with atoms a and frame coords g_a:

    frame[x, y, z, c] = sum_a Wx[x, a] * Wy[y, a] * Wz[z, a] * E[a, c]

with Wd[v, a] the integral of N(g_a_d, sigma_a) over voxel v along axis d,
masked to the 3-voxel window around round(g_a_d) and divided by the
unclipped window sum. That is T = Wx (x) Wy, shape (V*V, A), times
(Wz (x) E), shape (A, V*C): one (441, A) x (A, 21*C) product per residue,
batched over a chunk of residues with ``torch.bmm``. Boolean mode uses
one-hot weights and saturates at 1 afterwards. The frames of one call may
come from several structures: each frame then sees its own structure's atoms
only, padded to the call's largest structure with dropped atoms.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.special import erf

_SQRT2 = 1.4142135623730951
_CHUNK_BYTES = 512 * 1024 * 1024


def _axis_weights(g, sigma, V: int, voxel_size: float, gaussian: bool):
    """(..., A, 3) continuous voxel coords -> (..., A, 3, V) per-axis
    weights, masked to the 3-voxel window around round(g) and divided by
    the window's unclipped sum. ``sigma``: (..., A), broadcast against g."""
    v = torch.arange(V, dtype=g.dtype, device=g.device)
    n0 = torch.round(g)[..., None]
    if not gaussian:
        return (n0 == v).to(g.dtype)  # nearest voxel only
    g = g[..., None]
    s = sigma[..., None, None] * _SQRT2
    lo = (v - 0.5 - g) * voxel_size
    w = 0.5 * (erf((lo + voxel_size) / s) - erf(lo / s))
    # the window's sum over [n0 - 1.5, n0 + 1.5] voxels, out-of-frame included
    wsum = 0.5 * (erf((n0 + 1.5 - g) * voxel_size / s) - erf((n0 - 1.5 - g) * voxel_size / s))
    w = torch.where((v - n0).abs() <= 1.0, w, 0.0)
    return w / wsum.clamp_min(1e-12)


def voxelize_matmul(
    atoms_xyz: torch.Tensor,  # (A, 3), or (S, A, 3) with frame_structure
    atom_channel: torch.Tensor,  # (A,) or (S, A) int, -1 = dropped
    atom_sigma: torch.Tensor,  # (A,) or (S, A)
    atom_prop: torch.Tensor,  # (A,) or (S, A)
    ca: torch.Tensor,  # (R, 3)
    rot: torch.Tensor,  # (R, 3, 3)
    *,
    n_channels: int,
    prop_channel: int = -1,
    voxels_per_side: int = 21,
    voxel_size: float = 1.0,
    gaussian: bool = True,
    chunk: int | None = None,
    frame_structure: torch.Tensor | None = None,  # (R,) int, into S
) -> torch.Tensor:
    """Voxelize all residues. Returns (R, V, V, V, C) float32 on the
    inputs' device. ``chunk``: residues per batched product; by default as
    many as keep the (chunk, V*V, A) weight product within 512 MB, so a
    typical structure is one product (few launches per request).

    Without ``frame_structure`` every frame sees all the atoms. With it the
    atom arrays hold S structures, each padded to A atoms with dropped ones
    (channel -1), and frame r sees the atoms of structure
    ``frame_structure[r]`` only: the frames of many structures in one call."""
    if frame_structure is None:  # one structure, shared by every frame
        atoms_xyz, atom_channel, atom_sigma, atom_prop = (
            a[None] for a in (atoms_xyz, atom_channel, atom_sigma, atom_prop))
    V, C = voxels_per_side, n_channels
    R, A = ca.shape[0], atoms_xyz.shape[1]
    center = (V - 1) / 2.0

    kept = atom_channel >= 0
    E = F.one_hot(atom_channel.clamp_min(0).long(), C).to(torch.float32)
    E = E * kept[..., None]  # dropped atoms contribute nothing
    if prop_channel >= 0:
        E[..., prop_channel] += torch.where(kept, atom_prop, 0.0)

    if chunk is None:  # residues per product, from a memory budget
        chunk = max(1, _CHUNK_BYTES // (V * V * max(A, 1) * 4))
    frames = torch.empty((R, V, V, V, C), dtype=torch.float32, device=ca.device)
    for s in range(0, R, chunk):
        ca_c, rot_c = ca[s : s + chunk], rot[s : s + chunk]
        r = ca_c.shape[0]
        xyz, sigma, E_c = atoms_xyz, atom_sigma, E  # (1, A, ...): broadcast
        if frame_structure is not None:  # (r, A, ...): each frame's own
            k = frame_structure[s : s + chunk]
            xyz, sigma, E_c = xyz[k], sigma[k], E_c[k]
        rel = xyz - ca_c[:, None, :]
        g = torch.einsum("rij,raj->rai", rot_c, rel) / voxel_size + center
        w = _axis_weights(g, sigma, V, voxel_size, gaussian)  # (r, A, 3, V)
        T = (w[:, :, 0, :, None] * w[:, :, 1, None, :]).permute(0, 2, 3, 1)
        U = w[:, :, 2, :, None] * E_c[:, :, None, :]
        F_ = torch.bmm(T.reshape(r, V * V, A), U.reshape(r, A, V * C))
        frames[s : s + r] = F_.reshape(r, V, V, V, C)
    if not gaussian:
        # occupancy saturates at 1; the signed property channel at +-1
        frames.clamp_(max=1.0)
        if prop_channel >= 0:
            frames[..., prop_channel].clamp_(min=-1.0)
    return frames
