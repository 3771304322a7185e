"""Prediction decoding: probability matrix + datasetmap -> per-structure
sequences and probabilities. The port's copy of
``timed_design_tpu/io/decode.py`` without the NMR consensus flow, which the
sampling path does not use.
"""
from __future__ import annotations

import dataclasses
import typing as t

import numpy as np

from ..constants import AA1, AA3_TO_AA1
from .datasetmap import DatasetMap


@dataclasses.dataclass
class DecodedPredictions:
    pdb_to_sequence: dict[str, str]
    pdb_to_probability: dict[str, np.ndarray]
    pdb_to_real_sequence: dict[str, str]


def _category_letters(rotamer_categories: t.Sequence[str] | None) -> list[str]:
    """Class index -> one-letter residue. Handles 20-class (None), 338-class
    ('ALA_0' style), and pre-flattened one-letter category lists."""
    if rotamer_categories is None:
        return list(AA1)
    if len(rotamer_categories[0]) == 1:
        return list(rotamer_categories)
    return [AA3_TO_AA1[c.split("_")[0]] for c in rotamer_categories]


def extract_sequences(
    dmap: DatasetMap,
    prediction_matrix: np.ndarray,
    rotamer_categories: t.Sequence[str] | None = None,
) -> DecodedPredictions:
    """Decode a (N, n_classes) probability matrix into per-structure results.

      * old datasetmap: per-residue rows keyed by ``pdb + chain``, the real
        sequence recovered from the label column;
      * new datasetmap: ``(pdb_chain, count)`` blocks of consecutive rows.
    """
    P = np.asarray(prediction_matrix)
    if P.ndim == 1:
        P = P[None, :]
    letters = np.array(_category_letters(rotamer_categories))
    max_idx = P.argmax(axis=1)

    pdb_to_sequence: dict[str, str] = {}
    pdb_to_probability: dict[str, np.ndarray] = {}
    pdb_to_real_sequence: dict[str, str] = {}
    if dmap.is_old:
        reals = [AA3_TO_AA1.get(e[3], "X") for e in dmap.entries]
        # row indices per key in first-seen order, in one pass
        idx_by_key: dict[str, list[int]] = {}
        for i, e in enumerate(dmap.entries):
            idx_by_key.setdefault(e[0] + e[1], []).append(i)
        for key, rows in idx_by_key.items():
            idx = np.asarray(rows)
            pdb_to_probability[key] = P[idx]
            pdb_to_sequence[key] = "".join(letters[max_idx[idx]])
            pdb_to_real_sequence[key] = "".join(reals[i] for i in rows)
    else:
        offset = 0
        for pdb_chain, count in dmap.counts:
            rows = slice(offset, offset + count)
            pdb_to_probability[pdb_chain] = P[rows]
            pdb_to_sequence[pdb_chain] = "".join(letters[max_idx[rows]])
            pdb_to_real_sequence[pdb_chain] = ""
            offset += count
    return DecodedPredictions(pdb_to_sequence, pdb_to_probability, pdb_to_real_sequence)
