"""Frames from PDB text, written again from the published method: plain
NumPy and PyTorch, independent of the program under test.

A residue's frame is a 21^3 grid of 1 A voxels centred on its CA, in the
residue's own basis: y along CA->C, x along N (orthogonalised against y),
z = y x x. The backbone atoms N, CA, C, O of every residue of the structure
and a virtual CB at the fixed offset (-0.741287356, -0.53937931,
-1.224287356) of each residue's frame (aposteriori's default, CB imputed)
are spread over the grid: each atom's unit density is a product of three
per-axis integrals of N(g, sigma^2) over the voxels within one voxel of its
nearest one, divided by the integral over those three voxels (frame edge
included), sigma the element's van der Waals radius. Channels follow the
codec CNOCACB: C, N, O, CA, CB.
"""
from __future__ import annotations

import math

import numpy as np
import torch

CB_OFFSET = np.array([-0.741287356, -0.53937931, -1.224287356])
CHANNELS = ("C", "N", "O", "CA", "CB")
# atom -> (channel, van der Waals radius)
ATOM_KIND = {"N": (1, 1.55), "CA": (3, 1.7), "C": (0, 1.7), "O": (2, 1.52), "CB": (4, 1.7)}
AA3 = ("ALA", "CYS", "ASP", "GLU", "PHE", "GLY", "HIS", "ILE", "LYS", "LEU",
       "MET", "ASN", "PRO", "GLN", "ARG", "SER", "THR", "VAL", "TRP", "TYR")
V = 21


def parse_backbone(text: str) -> list[dict]:
    """The residues of the first model of PDB text, in file order: chain,
    residue id (sequence number and insertion code), three-letter name and
    the coordinates of N, CA, C, O (NaN where absent). Standard amino acids
    only; the first of alternate locations."""
    residues: list[dict] = []
    where: dict[tuple[str, str], dict] = {}
    for line in text.splitlines():
        if line.startswith("ENDMDL"):
            break
        if not line.startswith("ATOM  ") or len(line) < 54:
            continue
        name, resname = line[12:16].strip(), line[17:20].strip()
        if resname not in AA3:
            continue
        key = (line[21], f"{int(line[22:26])}{line[26]}".strip())
        res = where.get(key)
        if res is None:
            res = {"chain": key[0], "id": key[1], "name": resname,
                   "xyz": {a: np.full(3, np.nan) for a in ("N", "CA", "C", "O")}}
            where[key] = res
            residues.append(res)
        if name in res["xyz"] and np.isnan(res["xyz"][name][0]):
            res["xyz"][name] = np.array([float(line[30:38]), float(line[38:46]),
                                         float(line[46:54])])
    return residues


def frame_atoms(residues: list[dict]) -> dict:
    """Atoms of a structure in world coordinates (x, y, z, channel, sigma),
    and each residue's frame: its CA and its basis (rows x, y, z), for the
    residues whose N, CA and C give a basis."""
    n = np.array([r["xyz"]["N"] for r in residues])
    ca = np.array([r["xyz"]["CA"] for r in residues])
    c = np.array([r["xyz"]["C"] for r in residues])
    y = c - ca
    y = y / np.linalg.norm(y, axis=1, keepdims=True)
    x = n - ca
    x = x - (x * y).sum(1, keepdims=True) * y
    x = x / np.linalg.norm(x, axis=1, keepdims=True)
    basis = np.stack([x, y, np.cross(y, x)], axis=1)  # (R, 3, 3), rows x, y, z
    valid = np.isfinite(basis).all((1, 2))
    atoms = []
    for i, r in enumerate(residues):
        for a in ("N", "CA", "C", "O"):
            p = r["xyz"][a]
            if np.isfinite(p).all():
                atoms.append((*p, *ATOM_KIND[a]))
        if valid[i]:
            p = ca[i] + basis[i].T @ CB_OFFSET
            atoms.append((*p, *ATOM_KIND["CB"]))
    keep = np.nonzero(valid)[0]
    return {"atoms": np.array(atoms, np.float64), "ca": ca[keep], "basis": basis[keep],
            "keys": [(residues[i]["chain"], residues[i]["id"]) for i in keep],
            "labels": [residues[i]["name"] for i in keep]}


def _axis_weights(g: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """(A, 3) voxel coordinates -> (A, 3, V) normalised per-axis weights."""
    v = torch.arange(V, dtype=g.dtype, device=g.device)
    nearest = torch.round(g)[..., None]
    g = g[..., None]
    s = sigma[:, None, None] * math.sqrt(2.0)
    w = 0.5 * (torch.erf((v + 0.5 - g) / s) - torch.erf((v - 0.5 - g) / s))
    total = 0.5 * (torch.erf((nearest + 1.5 - g) / s) - torch.erf((nearest - 1.5 - g) / s))
    w = torch.where((v - nearest).abs() <= 1.0, w, torch.zeros_like(w))
    return w / total


def voxelize(fa: dict, rows, device, dtype=torch.float32) -> torch.Tensor:
    """Frames (len(rows), 21, 21, 21, 5) of the residues ``rows`` of
    ``frame_atoms``' output, in ``dtype`` on ``device``."""
    atoms = torch.as_tensor(fa["atoms"], dtype=dtype, device=device)
    xyz, channel, sigma = atoms[:, :3], atoms[:, 3].long(), atoms[:, 4]
    onehot = torch.nn.functional.one_hot(channel, len(CHANNELS)).to(dtype)
    ca = torch.as_tensor(fa["ca"][rows], dtype=dtype, device=device)
    basis = torch.as_tensor(fa["basis"][rows], dtype=dtype, device=device)
    out = torch.empty((len(ca), V, V, V, len(CHANNELS)), dtype=dtype, device=device)
    A = len(xyz)
    step = max(1, (1 << 27) // (A * V * V))
    for s in range(0, len(ca), step):
        rel = xyz[None] - ca[s : s + step, None]  # (r, A, 3)
        g = torch.einsum("rij,raj->rai", basis[s : s + step], rel) + (V - 1) / 2
        w = _axis_weights(g.reshape(-1, 3), sigma.repeat(len(g))).view(len(g), A, 3, V)
        xy = (w[:, :, 0, :, None] * w[:, :, 1, None, :]).reshape(len(g), A, V * V)
        zc = (w[:, :, 2, :, None] * onehot[None, :, None, :]).reshape(len(g), A, -1)
        out[s : s + step] = torch.bmm(xy.transpose(1, 2), zc).view(len(g), V, V, V, -1)
    return out
