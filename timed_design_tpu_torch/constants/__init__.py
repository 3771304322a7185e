"""Constant tables the port uses: amino acids and the rotamer codec.

Copies of ``timed_design_tpu/constants`` (same names, same values), kept
here so that the port imports nothing of the JAX package.
"""
from .amino_acids import (  # noqa: F401
    AA1,
    AA1_TO_INT,
    AA3,
    AA3_TO_AA1,
    AA3_TO_INT,
    CHI_COUNTS,
    EXT280_ARR,
    MW_ARR,
    PKA_NEGATIVE,
    PKA_POSITIVE,
    PKA_SIDECHAIN_ARR,
    PKA_SIGN_ARR,
    POLARITY_ZIMMERMAN,
    RESIDUE_CHARGE,
    RESIDUE_EXT_280,
    RESIDUE_MW,
    STANDARD_AMINO_ACIDS,
    UNCOMMON_RESIDUE_DICT,
    VDW_RADII,
    WATER_MASS,
)
from .rotamers import (  # noqa: F401
    N_ROTAMER_CLASSES,
    ROTAMER_CATEGORIES,
    ROTAMER_TO_AA,
    ROTAMER_TO_AA_ONEHOT,
    compress_rotamer_probs,
)
