"""The 338-class rotamer codec: the port's copy of ``ROTAMER_CATEGORIES``,
``ROTAMER_TO_AA``, ``ROTAMER_TO_AA_ONEHOT`` and ``compress_rotamer_probs``
from ``timed_design_tpu/constants/rotamers.py``.

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

# (338, 20) one-hot matrix: column j collects every rotamer of amino acid j
ROTAMER_TO_AA_ONEHOT = np.zeros((N_ROTAMER_CLASSES, len(AA1)), dtype=np.float32)
ROTAMER_TO_AA_ONEHOT[np.arange(N_ROTAMER_CLASSES), ROTAMER_TO_AA] = 1.0


def compress_rotamer_probs(prediction_matrix: np.ndarray) -> np.ndarray:
    """(N, 338) rotamer probabilities -> (N, 20) amino-acid probabilities:
    each amino acid's rotamers summed, as one matrix product."""
    return prediction_matrix @ ROTAMER_TO_AA_ONEHOT.astype(prediction_matrix.dtype)
