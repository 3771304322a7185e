"""Structure-derived analyses: packing density, B-factor, prediction
entropy; the port of ``timed_design_tpu/analyse/structure_analysis.py``.

The all-pairs atom count of ``atom_packing_density`` runs on the device in
blocks of rows; the rest is host numpy per structure.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..engine.predictor import default_device
from ..structure.pdb import Structure, load_pdb


def atom_packing_density(
    coords, radius: float = 7.0, chunk: int = 2048,
    device: torch.device | str | None = None,
) -> np.ndarray:
    """Atomic contact number: the atoms within ``radius`` of each atom,
    itself excluded (Weiss 2007). (N,) int32.

    O(N^2) on ``device`` (default: the CUDA device), ``chunk`` atoms against
    all at a time. The squared distance is the JAX package's float32
    ``((a - b) ** 2).sum(-1)``, summed x, y, z in numpy's order, so an atom
    pair exactly at the boundary falls on the same side and the counts are
    equal on the card, the CPU and in the JAX package (``torch.cdist`` or
    |a|^2 + |b|^2 - 2ab would round otherwise).
    """
    device = torch.device(device) if device is not None else default_device()
    xyz = torch.as_tensor(np.asarray(coords, np.float32)).to(device)
    n = xyz.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=device)
    r2 = np.float32(radius * radius).item()
    for start in range(0, n, chunk):
        d = xyz[start:start + chunk, None, :] - xyz[None, :, :]
        sq = d * d
        d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        out[start:start + chunk] = ((d2 < r2).sum(1) - 1).to(torch.int32)
    return out.cpu().numpy()


def structure_packing_density(
    structure: Structure, radius: float = 7.0,
    device: torch.device | str | None = None,
) -> np.ndarray:
    """Per-atom contact numbers over the structure's standard-residue atoms
    (hydrogens excluded); -1 for hydrogens."""
    non_h = structure.elements != "H"
    dens = np.full(len(structure.elements), -1, np.int32)
    dens[non_h] = atom_packing_density(structure.coords[non_h], radius, device=device)
    return dens


def extract_packdensity_from_structure(
    structure: Structure,
    atom_filter: str = "ca",
    radius: float = 7.0,
    reference_compat: bool = False,
    device: torch.device | str | None = None,
) -> list[float]:
    """Per-residue packing density: 'ca' = the CA atom only, 'backbone' =
    over N/CA/C/O, 'all' = over the non-H atoms.

    Over several atoms the default is their mean; ``reference_compat=True``
    gives the reference's repeated (acc + b) / 2 instead, which weights
    later atoms more (its published numbers).
    """
    if atom_filter == "backbone":
        filter_set = {"N", "CA", "C", "O"}
    elif atom_filter == "ca":
        filter_set = {"CA"}
    elif atom_filter == "all":
        filter_set = None
    else:
        raise ValueError(f"Atom filter {atom_filter} not in (backbone, ca, all)")

    dens = structure_packing_density(structure, radius, device=device)
    out: list[float] = []
    for r_idx in range(structure.res_index.max() + 1 if len(structure.res_index) else 0):
        sel = structure.res_index == r_idx
        names = structure.atom_names[sel]
        vals = dens[sel]
        if filter_set is not None:
            keep = np.isin(names, list(filter_set))
            vals = vals[keep]
        vals = vals[vals >= 0]
        if not len(vals):
            out.append(-1.0)
        elif reference_compat:
            acc = float(vals[0])
            for v in vals[1:]:
                acc = (acc + float(v)) / 2
            out.append(acc)
        else:
            out.append(float(vals.mean()))
    return out


def extract_bfactor_from_structure(structure: Structure) -> list[list[float]]:
    """Per-chain lists of per-residue B-factors (the first atom's: AF2
    writes its pLDDT uniformly per residue)."""
    out = []
    for chain in structure.chains:
        vals = [
            float(res.bfactors[0]) if len(res.bfactors) else float("nan")
            for res in chain.residues
            if res.is_standard_aa
        ]
        if vals:
            out.append(vals)
    return out


def extract_bfactor(pdb_path: Path) -> list[list[float]]:
    return extract_bfactor_from_structure(load_pdb(Path(pdb_path)))


def calculate_prediction_entropy(residue_predictions) -> np.ndarray:
    """Shannon entropy (base 2) per residue of a (n, n_classes) probability
    matrix."""
    p = np.asarray(residue_predictions, np.float64)
    p = p / np.maximum(p.sum(axis=1, keepdims=True), 1e-300)
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(p > 0, -p * np.log2(p), 0.0)
    return terms.sum(axis=1)


def extract_prediction_entropy_to_dict(
    model_pred_path: Path,
    model_map_path: Path,
    rotamer_mode: bool = False,
    is_old: bool = False,
) -> dict[str, np.ndarray]:
    """Per-structure entropy from a saved prediction CSV and its map."""
    from ..constants import ROTAMER_CATEGORIES
    from ..io import extract_sequences, load_datasetmap, load_prediction_matrix

    P = load_prediction_matrix(Path(model_pred_path))
    dmap = load_datasetmap(Path(model_map_path), is_old=is_old)
    decoded = extract_sequences(
        dmap, P, rotamer_categories=ROTAMER_CATEGORIES if rotamer_mode else None
    )
    return {
        pdb: calculate_prediction_entropy(prob)
        for pdb, prob in decoded.pdb_to_probability.items()
    }
