"""Structure layer: PDB parsing and residue property maps (copies of the
parts of ``timed_design_tpu/structure`` that the port uses)."""
from .pdb import Chain, Residue, Structure, load_pdb, parse_pdb_string  # noqa: F401
from .properties import convert_seq_to_property  # noqa: F401
