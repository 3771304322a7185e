"""Structural geometry: dihedrals, chi tagging, Kabsch superposition, GDT.

The port's copy of ``timed_design_tpu/structure/geometry.py``, host numpy
per structure like the rest of ``structure/``: a dihedral and chi-bin
computation over whole structures (the rotamer ground truth of
``td-analyse-rotamers``) and a closed-form Kabsch superposition (RMSD and
GDT of AlphaFold2 refolds).
"""
from __future__ import annotations

import numpy as np

from ..constants import AA3_TO_INT, CHI_COUNTS, SIDE_CHAIN_DIHEDRALS
from ..constants.rotamers import encode_chi_bins_to_rotamer
from .pdb import Structure


def dihedral(p0, p1, p2, p3) -> np.ndarray:
    """Dihedral angle(s) in degrees, in [0, 360).

    Accepts (..., 3) arrays; fully batched. Convention: the IUPAC
    (praxeolitic) signed dihedral about the p1-p2 axis (an alpha-helix phi
    of ~-60 deg is ~300 here), mapped to [0, 360) so the chi-bin boundaries
    sit at 120 and 240. The sign matters: gauche+ (+60, bin 1) and gauche-
    (-60 -> 300, bin 3) must not swap.
    """
    p0, p1, p2, p3 = (np.asarray(p, dtype=np.float64) for p in (p0, p1, p2, p3))
    b0 = p0 - p1  # praxeolitic: first vector points AWAY from the axis
    b1 = p2 - p1
    b2 = p3 - p2
    b1 = b1 / np.linalg.norm(b1, axis=-1, keepdims=True)
    v = b0 - (b0 * b1).sum(-1, keepdims=True) * b1
    w = b2 - (b2 * b1).sum(-1, keepdims=True) * b1
    x = (v * w).sum(-1)
    y = (np.cross(b1, v) * w).sum(-1)
    ang = np.degrees(np.arctan2(y, x))
    return np.mod(ang, 360.0)


def chi_bin(angle_deg: np.ndarray) -> np.ndarray:
    """Map chi angles (degrees, any range) to rotamer bins {1, 2, 3}:
    [0, 120) gauche+, [120, 240) trans, [240, 360) gauche-, the three bins
    per chi that the 338-class codec enumerates."""
    a = np.mod(np.asarray(angle_deg), 360.0)
    return (a // 120.0).astype(np.int32) + 1


def tag_chi_angles(structure: Structure) -> list[tuple[list[float], list[int]]]:
    """Per standard residue: ([chi angles in deg], [chi bins 1..3]).

    Residues with missing side-chain atoms get NaN angles / bin 0 at the
    affected positions. Every chi of the structure is computed in one
    ``dihedral`` call, each angle as a call of its own would give it.
    """
    out: list[tuple[list[float], list[int]]] = []
    quads, where = [], []
    for res in structure.residues:
        if not res.is_standard_aa:
            continue
        chis = SIDE_CHAIN_DIHEDRALS.get(res.res_name, [])
        for j, quad in enumerate(chis):
            pts = [res.atom(a) for a in quad]
            if all(p is not None for p in pts):
                quads.append(pts)
                where.append((len(out), j))
        out.append(([float("nan")] * len(chis), [0] * len(chis)))
    if quads:
        q = np.asarray(quads, np.float64)  # (n_chi, 4, 3)
        angles = dihedral(q[:, 0], q[:, 1], q[:, 2], q[:, 3])
        for (i, j), ang, b in zip(where, angles.tolist(), chi_bin(angles).tolist()):
            out[i][0][j] = ang
            out[i][1][j] = b
    return out


def encode_structure_rotamers(structure: Structure) -> list[float]:
    """Per standard residue: its rotamer class 0..337, or NaN where the
    chi-bin combination cannot be formed (missing atoms)."""
    codes: list[float] = []
    std_residues = [r for r in structure.residues if r.is_standard_aa]
    tags = tag_chi_angles(structure)
    for res, (_, bins) in zip(std_residues, tags):
        aa_idx = AA3_TO_INT[res.res_name]
        if CHI_COUNTS[res.res_name] == 0:
            code = encode_chi_bins_to_rotamer(aa_idx, ())
        elif 0 in bins:
            code = None
        else:
            code = encode_chi_bins_to_rotamer(aa_idx, tuple(bins))
        codes.append(float("nan") if code is None else float(code))
    return codes


def kabsch(P, Q):
    """Optimal rotation matrix aligning P onto Q (both (N, 3), centered).
    Returns (R, rmsd)."""
    P = np.asarray(P, dtype=np.float64)
    Q = np.asarray(Q, dtype=np.float64)
    H = P.T @ Q
    U, S, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag(np.asarray([1.0, 1.0, 1.0]) * np.stack([np.ones(()), np.ones(()), d]))
    R = Vt.T @ D @ U.T
    P_rot = P @ R.T
    rmsd = np.sqrt(((P_rot - Q) ** 2).sum() / P.shape[0])
    return R, rmsd


def superpose(mobile: np.ndarray, target: np.ndarray):
    """Center + Kabsch-align mobile onto target. Returns (aligned, rmsd)."""
    mobile = np.asarray(mobile, np.float64)
    target = np.asarray(target, np.float64)
    mc = mobile - mobile.mean(axis=0)
    tc = target - target.mean(axis=0)
    R, rmsd = kabsch(mc, tc)
    return mc @ R.T + target.mean(axis=0), float(rmsd)


def gdt(mobile_ca: np.ndarray, target_ca: np.ndarray,
        cutoffs: tuple[float, ...] = (1.0, 2.0, 4.0, 8.0)) -> dict[float, float]:
    """Global Distance Test after CA superposition: {cutoff in A: fraction
    of CA atoms within it}."""
    aligned, _ = superpose(mobile_ca, target_ca)
    dists = np.linalg.norm(aligned - target_ca, axis=1)
    return {c: float((dists <= c).mean()) for c in cutoffs}


def ca_rmsd(mobile_ca: np.ndarray, target_ca: np.ndarray) -> float:
    """CA RMSD after optimal superposition."""
    _, rmsd = superpose(mobile_ca, target_ca)
    return rmsd
