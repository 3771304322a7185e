"""The 338-class rotamer codec: the port's copy of ``ROTAMER_CATEGORIES``,
``ROTAMER_CATEGORIES_1LETTER``, ``ROTAMER_TO_AA``, ``ROTAMER_TO_AA_ONEHOT``,
``ROTAMER_CHI_BINS``, ``REDUCTION_GUIDE``, ``compress_rotamer_probs``,
``get_rotamer_codec`` and ``encode_chi_bins_to_rotamer`` from
``timed_design_tpu/constants/rotamers.py``.

Per amino acid in AA1 order, one class for every chi-bin combination
``product([1, 2, 3], repeat=n_chi)`` (e.g. ``LYS_1232``), and a single
``<RES>_0`` class for ALA and GLY.
"""
from __future__ import annotations

from itertools import product

import numpy as np

from .amino_acids import AA1, AA3, CHI_COUNTS

N_ROTAMER_CLASSES = 338

# the class names, and (338,) int32: rotamer class -> amino-acid class
ROTAMER_CATEGORIES = [
    f"{res}_{''.join(map(str, combo)) or '0'}"
    for res in AA3 for combo in product([1, 2, 3], repeat=CHI_COUNTS[res])
]
ROTAMER_TO_AA = np.array(
    [i for i, res in enumerate(AA3) for _ in product([1, 2, 3], repeat=CHI_COUNTS[res])],
    np.int32,
)
assert len(ROTAMER_CATEGORIES) == ROTAMER_TO_AA.shape[0] == N_ROTAMER_CLASSES
# where each amino acid's block of rotamer classes starts
REDUCTION_GUIDE = np.searchsorted(ROTAMER_TO_AA, np.arange(len(AA1))).astype(np.int32)

# (338, 20) one-hot matrix: column j collects every rotamer of amino acid j
ROTAMER_TO_AA_ONEHOT = np.zeros((N_ROTAMER_CLASSES, len(AA1)), dtype=np.float32)
ROTAMER_TO_AA_ONEHOT[np.arange(N_ROTAMER_CLASSES), ROTAMER_TO_AA] = 1.0

# the one-letter amino acid of each class
ROTAMER_CATEGORIES_1LETTER = [AA1[i] for i in ROTAMER_TO_AA]

# (338, 4) int32: each class's chi bins (1..3), 0 past the residue's chis
ROTAMER_CHI_BINS = np.zeros((N_ROTAMER_CLASSES, 4), dtype=np.int32)
for _k, _name in enumerate(ROTAMER_CATEGORIES):
    for _c, _b in enumerate(_name.split("_")[1].lstrip("0")):
        ROTAMER_CHI_BINS[_k, _c] = int(_b)


def compress_rotamer_probs(prediction_matrix: np.ndarray) -> np.ndarray:
    """(N, 338) rotamer probabilities -> (N, 20) amino-acid probabilities:
    each amino acid's rotamers summed, as one matrix product."""
    return prediction_matrix @ ROTAMER_TO_AA_ONEHOT.astype(prediction_matrix.dtype)


def get_rotamer_codec(return_reduction_guide: bool = False):
    """``(rot_to_20res, flat_categories[, reduction_guide])``: rotamer class
    -> its (20,) one-hot row, the class names, and each amino acid's first
    class."""
    rot_to_20res = {k: ROTAMER_TO_AA_ONEHOT[k] for k in range(N_ROTAMER_CLASSES)}
    if return_reduction_guide:
        return rot_to_20res, list(ROTAMER_CATEGORIES), list(REDUCTION_GUIDE)
    return rot_to_20res, list(ROTAMER_CATEGORIES)


def encode_chi_bins_to_rotamer(aa_index: int, chi_bins: tuple[int, ...]) -> int | None:
    """(amino acid, chi bins 1..3 each) -> its rotamer class, or None when
    the bins do not fit the residue: the block's start plus the bins read
    as a base-3 number."""
    n_chi = CHI_COUNTS[AA3[aa_index]]
    if n_chi == 0:
        return int(REDUCTION_GUIDE[aa_index]) if len(chi_bins) == 0 else None
    if len(chi_bins) != n_chi or any(b not in (1, 2, 3) for b in chi_bins):
        return None
    offset = 0
    for b in chi_bins:
        offset = offset * 3 + (b - 1)
    return int(REDUCTION_GUIDE[aa_index]) + offset
