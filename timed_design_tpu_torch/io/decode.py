"""Prediction decoding: probability matrix + datasetmap -> per-structure
sequences and probabilities, and the NMR multi-state consensus. The port's
copy of ``timed_design_tpu/io/decode.py``.
"""
from __future__ import annotations

import dataclasses
import re
import typing as t

import numpy as np

from ..constants import AA1, AA3_TO_AA1
from .datasetmap import DatasetMap


@dataclasses.dataclass
class DecodedPredictions:
    pdb_to_sequence: dict[str, str]
    pdb_to_probability: dict[str, np.ndarray]
    pdb_to_real_sequence: dict[str, str]
    pdb_to_consensus: dict[str, str] | None = None
    pdb_to_consensus_prob: dict[str, np.ndarray] | None = None

    def astuple(self):
        """The reference-shaped 5-tuple."""
        return (
            self.pdb_to_sequence,
            self.pdb_to_probability,
            self.pdb_to_real_sequence,
            self.pdb_to_consensus,
            self.pdb_to_consensus_prob,
        )


def _category_letters(rotamer_categories: t.Sequence[str] | None) -> list[str]:
    """Class index -> one-letter residue. Handles 20-class (None), 338-class
    ('ALA_0' style), and pre-flattened one-letter category lists."""
    if rotamer_categories is None:
        return list(AA1)
    if len(rotamer_categories[0]) == 1:
        return list(rotamer_categories)
    return [AA3_TO_AA1[c.split("_")[0]] for c in rotamer_categories]


def consensus_running_average(per_state_probs) -> np.ndarray:
    """The NMR consensus: the running pairwise average consensus =
    (consensus + cur) / 2 over the states in order (so later states weigh
    more), in the states' own dtype."""
    acc = np.array(per_state_probs[0])
    for k, prob in enumerate(per_state_probs[1:], start=1):
        prob = np.array(prob)
        if prob.shape != acc.shape:
            raise ValueError(
                f"NMR consensus states are not index-aligned: state 0 has "
                f"shape {acc.shape} but state {k} has {prob.shape}. States "
                f"must cover the same residues in the same order (voxelize "
                f"with voxelise_all_states=True, which aligns states on "
                f"their common residues)."
            )
        acc = (acc + prob) / 2
    return acc


def _base_chain(key: str) -> tuple[str, str]:
    """``<base>_<state><chain>`` -> (base, chain); other keys -> (key, "")."""
    m = re.match(r"^(.*?)_\d+(.*)$", key)
    return (m.group(1), m.group(2)) if m else (key, "")


def extract_sequences(
    dmap: DatasetMap,
    prediction_matrix: np.ndarray,
    rotamer_categories: t.Sequence[str] | None = None,
    is_consensus: bool = False,
) -> DecodedPredictions:
    """Decode a (N, n_classes) probability matrix into per-structure results.

      * old datasetmap: per-residue rows keyed by ``pdb + chain``, the real
        sequence recovered from the label column;
      * new datasetmap: ``(pdb_chain, count)`` blocks of consecutive rows;
      * ``is_consensus``: NMR states ``<pdb>_<i>`` grouped per (base, chain)
        and averaged by ``consensus_running_average`` in the map's order,
        then argmax-decoded. The key is the bare base when the base has one
        chain, else base + chain; two groups on one key raise.
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
    if not is_consensus:
        return DecodedPredictions(pdb_to_sequence, pdb_to_probability, pdb_to_real_sequence)

    by_group: dict[tuple[str, str], list[np.ndarray]] = {}
    for pdb_chain in pdb_to_sequence:
        by_group.setdefault(_base_chain(pdb_chain), []).append(
            np.array(pdb_to_probability[pdb_chain])
        )
    chains_per_base: dict[str, set[str]] = {}
    for base, chain in by_group:
        chains_per_base.setdefault(base, set()).add(chain)
    by_base: dict[str, list[np.ndarray]] = {}
    for (base, chain), probs in by_group.items():
        key = base if len(chains_per_base[base]) == 1 else base + chain
        if key in by_base:
            raise ValueError(
                f"consensus key collision: two structure groups both map "
                f"to {key!r}; rename the conflicting structures"
            )
        by_base[key] = probs
    pdb_to_consensus_prob = {
        base: consensus_running_average(probs) for base, probs in by_base.items()
    }
    pdb_to_consensus = {
        base: "".join(letters[prob.argmax(axis=1)])
        for base, prob in pdb_to_consensus_prob.items()
    }
    return DecodedPredictions(pdb_to_sequence, pdb_to_probability, pdb_to_real_sequence,
                              pdb_to_consensus, pdb_to_consensus_prob)
