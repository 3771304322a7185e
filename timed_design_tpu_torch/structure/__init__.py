"""Structure layer: PDB parsing, geometry (chi angles, rotamer tags,
superposition) and property-constrained design (copies of the parts of
``timed_design_tpu/structure`` that the port uses)."""
from .pdb import (  # noqa: F401
    BACKBONE_ATOMS,
    Chain,
    Residue,
    Structure,
    load_pdb,
    parse_pdb_string,
    residue_labels,
)
from .geometry import (  # noqa: F401
    ca_rmsd,
    chi_bin,
    dihedral,
    encode_structure_rotamers,
    gdt,
    kabsch,
    superpose,
    tag_chi_angles,
)
from .properties import (  # noqa: F401
    ACCEPTED_PROPERTIES,
    PROPERTY_TO_RESIDUE,
    convert_seq_to_property,
    create_map_alphanumeric_code,
    create_residue_map,
    modify_structure_with_property,
)
