"""Residue property maps: the port's copy of ``convert_seq_to_property``
from ``timed_design_tpu/structure/properties.py`` (the P and Q codecs'
property channel)."""
from __future__ import annotations

from ..constants import POLARITY_ZIMMERMAN, RESIDUE_CHARGE, STANDARD_AMINO_ACIDS

ACCEPTED_PROPERTIES = ("polarity", "charge")


def convert_seq_to_property(seq: str, property: str) -> list[int]:
    """Sequence -> property list.

    polarity: Zimmerman < 20 -> 0 (non-polar) else 1. Non-standard letters -> 0.
    charge: coarse formal charge (-1/0/1).
    """
    prop = property.lower()
    if prop not in ACCEPTED_PROPERTIES:
        raise ValueError(f"Property {property} not found among {ACCEPTED_PROPERTIES}")
    out = []
    for r in seq:
        if r in STANDARD_AMINO_ACIDS:
            if prop == "polarity":
                out.append(0 if POLARITY_ZIMMERMAN[r] < 20 else 1)
            else:
                out.append(RESIDUE_CHARGE[r])
        else:
            out.append(0)
    return out
