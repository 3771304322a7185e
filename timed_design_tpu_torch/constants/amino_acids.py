"""Amino-acid constant tables.

The port's copy of the tables it uses from
``timed_design_tpu/constants/amino_acids.py``, with the same names and
values: everything keys off the ordering of ``STANDARD_AMINO_ACIDS``
(alphabetical by one-letter code). The per-residue arrays are ordered by
``AA1``, so a sequence of codes 0..19 indexes any of them in one gather.
"""
from __future__ import annotations

import numpy as np

STANDARD_AMINO_ACIDS: dict[str, str] = {
    "A": "ALA", "C": "CYS", "D": "ASP", "E": "GLU", "F": "PHE",
    "G": "GLY", "H": "HIS", "I": "ILE", "K": "LYS", "L": "LEU",
    "M": "MET", "N": "ASN", "P": "PRO", "Q": "GLN", "R": "ARG",
    "S": "SER", "T": "THR", "V": "VAL", "W": "TRP", "Y": "TYR",
}

AA1: tuple[str, ...] = tuple(STANDARD_AMINO_ACIDS.keys())
AA3: tuple[str, ...] = tuple(STANDARD_AMINO_ACIDS.values())
AA1_TO_AA3: dict[str, str] = dict(STANDARD_AMINO_ACIDS)
AA3_TO_AA1: dict[str, str] = {v: k for k, v in STANDARD_AMINO_ACIDS.items()}
AA1_TO_INT: dict[str, int] = {a: i for i, a in enumerate(AA1)}
AA3_TO_INT: dict[str, int] = {a: i for i, a in enumerate(AA3)}
N_AMINO_ACIDS = 20

# Chi dihedrals per residue: the rotamer codec's 3**n_chi fan-out sums to 338.
CHI_COUNTS: dict[str, int] = {
    "ALA": 0, "CYS": 1, "ASP": 2, "GLU": 3, "PHE": 2,
    "GLY": 0, "HIS": 2, "ILE": 2, "LYS": 4, "LEU": 2,
    "MET": 3, "ASN": 2, "PRO": 2, "GLN": 3, "ARG": 4,
    "SER": 1, "THR": 1, "VAL": 1, "TRP": 2, "TYR": 2,
}

# Side-chain dihedral atom quadruples (standard chi definitions): chi tagging.
SIDE_CHAIN_DIHEDRALS: dict[str, list[tuple[str, str, str, str]]] = {
    "ARG": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD"),
            ("CB", "CG", "CD", "NE"), ("CG", "CD", "NE", "CZ")],
    "ASN": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "OD1")],
    "ASP": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "OD1")],
    "CYS": [("N", "CA", "CB", "SG")],
    "GLN": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD"),
            ("CB", "CG", "CD", "OE1")],
    "GLU": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD"),
            ("CB", "CG", "CD", "OE1")],
    "HIS": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "ND1")],
    "ILE": [("N", "CA", "CB", "CG1"), ("CA", "CB", "CG1", "CD1")],
    "LEU": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD1")],
    "LYS": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD"),
            ("CB", "CG", "CD", "CE"), ("CG", "CD", "CE", "NZ")],
    "MET": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "SD"),
            ("CB", "CG", "SD", "CE")],
    "PHE": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD1")],
    "PRO": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD")],
    "SER": [("N", "CA", "CB", "OG")],
    "THR": [("N", "CA", "CB", "OG1")],
    "TRP": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD1")],
    "TYR": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD1")],
    "VAL": [("N", "CA", "CB", "CG1")],
}

# Zimmerman polarity; < 20 is non-polar (the P property channel).
POLARITY_ZIMMERMAN: dict[str, float] = {
    "A": 0.00, "R": 52.00, "N": 3.38, "D": 49.70, "C": 1.48,
    "Q": 3.53, "E": 49.90, "G": 0.00, "H": 51.60, "I": 0.13,
    "L": 0.13, "K": 49.50, "M": 1.43, "F": 0.35, "P": 1.58,
    "S": 1.67, "T": 1.66, "W": 2.10, "Y": 1.61, "V": 0.13,
}

# Coarse formal charge (the Q property channel).
RESIDUE_CHARGE: dict[str, int] = {
    "A": 0, "C": 0, "D": -1, "E": -1, "F": 0,
    "G": 0, "H": 1, "I": 0, "K": 1, "L": 0,
    "M": 0, "N": 0, "P": 0, "Q": 0, "R": 1,
    "S": 0, "T": 0, "V": 0, "W": 0, "Y": 0,
}

# Average residue masses (g/mol); one water per chain.
RESIDUE_MW: dict[str, float] = {
    "A": 71.0788, "R": 156.1875, "N": 114.1038, "D": 115.0886,
    "C": 103.1388, "E": 129.1155, "Q": 128.1307, "G": 57.0519,
    "H": 137.1411, "I": 113.1594, "L": 113.1594, "K": 128.1741,
    "M": 131.1926, "F": 147.1766, "P": 97.1167, "S": 87.0782,
    "T": 101.1051, "W": 186.2132, "Y": 163.1760, "V": 99.1326,
}
WATER_MASS = 18.01528

# Molar extinction coefficients at 280 nm (Gill & von Hippel).
RESIDUE_EXT_280: dict[str, int] = {"W": 5690, "Y": 1280, "C": 120}

# Side-chain and terminus pKa values (EMBOSS set).
PKA_POSITIVE: dict[str, float] = {"Nterm": 8.6, "K": 10.8, "R": 12.5, "H": 6.5}
PKA_NEGATIVE: dict[str, float] = {"Cterm": 3.6, "D": 3.9, "E": 4.1, "C": 8.5, "Y": 10.1}

# Van der Waals radii (Bondi) per element: the voxelizer's density spread.
VDW_RADII: dict[str, float] = {"C": 1.7, "N": 1.55, "O": 1.52, "S": 1.8, "H": 1.2, "P": 1.8}

# Non-standard residues mapped to their closest standard residue.
UNCOMMON_RESIDUE_DICT: dict[str, str] = {
    # Modified cysteines
    "CSO": "CYS", "OCS": "CYS", "CSX": "CYS", "CSS": "CYS", "CME": "CYS",
    "CSD": "CYS", "CAS": "CYS", "SMC": "CYS", "SCY": "CYS", "YCM": "CYS",
    "CSW": "CYS", "CSU": "CYS", "CAF": "CYS", "SNC": "CYS",
    # Modified lysines
    "MLY": "LYS", "KCX": "LYS", "LLP": "LYS", "M3L": "LYS", "ALY": "LYS",
    "MLZ": "LYS", "LYZ": "LYS",
    # Modified methionines
    "MSE": "MET", "FME": "MET", "CXM": "MET", "MHO": "MET",
    # Modified histidines
    "HIC": "HIS", "NEP": "HIS", "MHS": "HIS",
    # Modified serines / threonines / tyrosines (phospho etc.)
    "SEP": "SER", "PN2": "SER", "SAC": "SER", "TPO": "THR", "PTR": "TYR",
    "TYS": "TYR", "TYI": "TYR",
    # Modified prolines
    "HYP": "PRO", "PCA": "GLN",
    # Modified arginines / others
    "AGM": "ARG", "ARO": "ARG", "MEN": "ASN", "BFD": "ASP", "PHD": "ASP",
    "CGU": "GLU", "SAR": "GLY", "GL3": "GLY", "ALM": "ALA", "AIB": "ALA",
    "DAL": "ALA", "MAA": "ALA", "FLA": "ALA", "DHA": "ALA",
}

# Arrays ordered by AA1 (CHI_COUNTS_ARR by AA3, the same order).
CHI_COUNTS_ARR = np.array([CHI_COUNTS[a] for a in AA3], dtype=np.int32)
POLARITY_ARR = np.array([POLARITY_ZIMMERMAN[a] for a in AA1], dtype=np.float32)
IS_POLAR_ARR = (POLARITY_ARR >= 20.0).astype(np.int32)
CHARGE_ARR = np.array([RESIDUE_CHARGE[a] for a in AA1], dtype=np.int32)
MW_ARR = np.array([RESIDUE_MW[a] for a in AA1], dtype=np.float64)
EXT280_ARR = np.array([RESIDUE_EXT_280.get(a, 0) for a in AA1], dtype=np.float64)
# pKa of the side chain, NaN where it is not titratable; sign +1 basic, -1 acidic.
PKA_SIDECHAIN_ARR = np.array(
    [PKA_POSITIVE.get(a, PKA_NEGATIVE.get(a, np.nan)) for a in AA1], dtype=np.float64
)
PKA_SIGN_ARR = np.array(
    [1 if a in PKA_POSITIVE else (-1 if a in PKA_NEGATIVE else 0) for a in AA1],
    dtype=np.int32,
)


def sequence_to_int(seq: str) -> np.ndarray:
    """A one-letter sequence -> int32 codes 0..19 (the order of AA1)."""
    return np.array([AA1_TO_INT[r] for r in seq], dtype=np.int32)


def int_to_sequence(codes) -> str:
    """Codes 0..19 (any shape, read flat) -> a one-letter sequence."""
    return "".join(AA1[int(c)] for c in np.asarray(codes).reshape(-1))
