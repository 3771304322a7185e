"""Property-constrained design: residue property maps (polarity 0/1, charge
-1/0/1), the rewrite of a structure's residues to meet a map, the residue
picker's labels and the maps' cache keys; the port of
``timed_design_tpu/structure/properties.py``.

A design constraint is a per-residue property map. The structure's residue
identities are rewritten to meet it (0 -> ALA, 1 -> LYS, -1 -> ASP) before
it is voxelized with a codec that carries the property channel (``P`` or
``Q``), so the network sees the constraint in its input frames.
"""
from __future__ import annotations

import random
import string
import typing as t

import numpy as np

from ..constants import (
    AA1_TO_AA3,
    AA3_TO_AA1,
    POLARITY_ZIMMERMAN,
    RESIDUE_CHARGE,
    STANDARD_AMINO_ACIDS,
)
from .pdb import Structure

ACCEPTED_PROPERTIES = ("polarity", "charge")
# property value -> the residue that carries it
PROPERTY_TO_RESIDUE = {0: "A", 1: "K", -1: "D"}


def _check_property(property: str) -> str:
    prop = property.lower()
    if prop not in ACCEPTED_PROPERTIES:
        raise ValueError(f"Property {property} not found among {ACCEPTED_PROPERTIES}")
    return prop


def _residue_property(letter: str, prop: str) -> int:
    """polarity: Zimmerman < 20 -> 0 (non-polar) else 1; charge: the coarse
    formal charge (-1/0/1); 0 for a letter outside the 20 amino acids."""
    if letter not in STANDARD_AMINO_ACIDS:
        return 0
    if prop == "polarity":
        return 0 if POLARITY_ZIMMERMAN[letter] < 20 else 1
    return RESIDUE_CHARGE[letter]


def convert_seq_to_property(seq: str, property: str) -> list[int]:
    """Sequence -> property list (see ``_residue_property``)."""
    prop = _check_property(property)
    return [_residue_property(r, prop) for r in seq]


def modify_structure_with_property(
    structure: Structure, property_map: np.ndarray, property: str
) -> Structure:
    """Rewrite residue identities so that their property meets
    ``property_map`` (one value per residue, in chain order), in place: parse
    a fresh copy to keep the original. Raises AssertionError when the
    rewritten sequence's map is not ``property_map``."""
    prop = _check_property(property)
    count = 0
    merged_sequence = ""
    for chain in structure.chains:
        for res in chain.residues:
            letter = AA3_TO_AA1.get(res.res_name, "X")
            if property_map[count] != _residue_property(letter, prop):
                letter = PROPERTY_TO_RESIDUE[int(property_map[count])]
                res.res_name = AA1_TO_AA3[letter]
            merged_sequence += letter
            count += 1
    new_map = convert_seq_to_property(merged_sequence, property=prop)
    np.testing.assert_array_equal(new_map, property_map, err_msg="Property maps differ.")
    return structure


def create_residue_map(structure: Structure) -> tuple[list[str], str]:
    """The residue picker's labels (``K6 (Chain A)``) and the chains'
    sequences concatenated."""
    residue_map: list[str] = []
    merged_sequence = ""
    for chain in structure.chains:
        for res in chain.residues:
            letter = AA3_TO_AA1.get(res.res_name, "X")
            residue_map.append(f"{letter}{res.id} (Chain {chain.chain_id})")
            merged_sequence += letter
    return residue_map, merged_sequence


def create_map_alphanumeric_code(property_map: t.Sequence[int], k: int = 32) -> str:
    """A deterministic cache key for a property map, the JAX package's: the
    stdlib generator seeded with the map's digits after a leading 1, -1
    written as 2."""
    seed_map = "1"
    for v in property_map:
        seed_map += "2" if v < 0 else str(int(v))
    rng = random.Random(int(seed_map))
    return "".join(rng.choices(string.ascii_letters + string.digits, k=k))
