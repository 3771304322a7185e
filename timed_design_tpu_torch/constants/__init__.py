"""Constant tables the port uses: amino acids, the rotamer codec, BLOSUM62.

Copies of ``timed_design_tpu/constants`` (same names, same values), kept
here so that the port imports nothing of the JAX package.
"""
from .amino_acids import (  # noqa: F401
    AA1,
    AA1_TO_AA3,
    AA1_TO_INT,
    AA3,
    AA3_TO_AA1,
    AA3_TO_INT,
    CHARGE_ARR,
    CHI_COUNTS,
    CHI_COUNTS_ARR,
    EXT280_ARR,
    IS_POLAR_ARR,
    MW_ARR,
    N_AMINO_ACIDS,
    PKA_NEGATIVE,
    PKA_POSITIVE,
    PKA_SIDECHAIN_ARR,
    PKA_SIGN_ARR,
    POLARITY_ARR,
    POLARITY_ZIMMERMAN,
    RESIDUE_CHARGE,
    RESIDUE_EXT_280,
    RESIDUE_MW,
    SIDE_CHAIN_DIHEDRALS,
    STANDARD_AMINO_ACIDS,
    UNCOMMON_RESIDUE_DICT,
    VDW_RADII,
    WATER_MASS,
    int_to_sequence,
    sequence_to_int,
)
from .blosum import (  # noqa: F401
    BLOSUM62_ALPHABET,
    BLOSUM62_MATRIX,
    blosum62_scores,
    lookup_blosum62,
    sequence_similarity,
)
from .rotamers import (  # noqa: F401
    N_ROTAMER_CLASSES,
    REDUCTION_GUIDE,
    ROTAMER_CATEGORIES,
    ROTAMER_CATEGORIES_1LETTER,
    ROTAMER_CHI_BINS,
    ROTAMER_TO_AA,
    ROTAMER_TO_AA_ONEHOT,
    compress_rotamer_probs,
    encode_chi_bins_to_rotamer,
    get_rotamer_codec,
)
