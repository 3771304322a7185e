"""PDB parsing into a struct-of-arrays structure.

The port's copy of ``Structure``, ``load_pdb``, ``parse_pdb_string`` and
``residue_labels`` from ``timed_design_tpu/structure/pdb.py``, with both of
its scanners: the native C++ one (``csrc/pdbscan.cpp`` via ``_native.py``)
when a toolchain is available, else the Python one; both give the same
field arrays. A
``Structure`` is one model (state) as flat NumPy arrays (coords, elements,
atom names, residue indices) with a chain/residue index on top.

Supports ATOM/HETATM records, multiple MODELs, chains, altloc filtering,
insertion codes, gzipped files and uncommon-residue remapping, and writes
PDB text back (``Structure.to_pdb``).
"""
from __future__ import annotations

import dataclasses
import gzip
import typing as t
from pathlib import Path

import numpy as np

from ..constants import AA3_TO_INT, UNCOMMON_RESIDUE_DICT

BACKBONE_ATOMS = ("N", "CA", "C", "O", "CB")


@dataclasses.dataclass
class Residue:
    """Host-side view of one residue (built from the scan's arrays)."""

    chain_id: str
    res_seq: int
    icode: str
    res_name: str  # three-letter, post uncommon-remap
    atom_names: list[str]
    coords: np.ndarray  # (n_atoms, 3)
    elements: list[str]
    bfactors: np.ndarray  # (n_atoms,)
    is_standard_aa: bool
    # position of this residue in the Structure's flat std-residue order;
    # None for non-standard residues
    std_index: int | None = None

    @property
    def id(self) -> str:
        return f"{self.res_seq}{self.icode}".strip()

    def atom(self, name: str) -> np.ndarray | None:
        try:
            return self.coords[self.atom_names.index(name)]
        except ValueError:
            return None


@dataclasses.dataclass
class Chain:
    chain_id: str
    residues: list[Residue]

    def sequence1(self) -> str:
        from ..constants import AA3_TO_AA1

        return "".join(
            AA3_TO_AA1.get(r.res_name, "X") for r in self.residues if r.is_standard_aa
        )


@dataclasses.dataclass
class Structure:
    """One model (state) of a parsed PDB file.

    Flat atom arrays (struct-of-arrays) + a chain/residue index built on top.
    """

    name: str
    chains: list[Chain]
    # Flat arrays over all atoms of standard residues:
    coords: np.ndarray  # (n_atoms, 3) float32
    elements: np.ndarray  # (n_atoms,) '<U2'
    atom_names: np.ndarray  # (n_atoms,) '<U4'
    res_index: np.ndarray  # (n_atoms,) int32: index into residue list
    bfactors: np.ndarray  # (n_atoms,) float32

    @property
    def residues(self) -> list[Residue]:
        return [r for c in self.chains for r in c.residues]

    @property
    def n_residues(self) -> int:
        return sum(len(c.residues) for c in self.chains)

    def sequence1(self) -> str:
        return "".join(c.sequence1() for c in self.chains)

    def select_chain(self, chain_id: str) -> "Structure":
        """One chain as a Structure of its own: the flat arrays sliced to
        its standard residues, ``res_index`` renumbered from 0."""
        target = next(
            (c for c in self.chains if c.chain_id == chain_id), None
        )
        if target is None:
            raise KeyError(f"no chain {chain_id!r} in {self.name}")
        # the std indices recorded at parse time hold when a chain's records
        # are not contiguous in the file
        idxs = np.array(
            [r.std_index for r in target.residues
             if r.is_standard_aa and r.std_index is not None],
            np.int64,
        )
        mask = np.isin(self.res_index, idxs)
        remap = np.full(int(self.res_index.max(initial=0)) + 1, -1, np.int64)
        remap[idxs] = np.arange(len(idxs))
        return Structure(
            name=self.name,
            chains=[target],
            coords=self.coords[mask],
            elements=self.elements[mask],
            atom_names=self.atom_names[mask],
            res_index=remap[self.res_index[mask]].astype(np.int32),
            bfactors=self.bfactors[mask],
        )

    def backbone_arrays(self) -> dict[str, np.ndarray]:
        """(R, 3) coordinate array per backbone atom name, NaN where missing,
        one row per standard residue in file order."""
        std = [r for r in self.residues if r.is_standard_aa]
        out = {name: np.full((len(std), 3), np.nan, np.float32) for name in BACKBONE_ATOMS}
        for i, res in enumerate(std):
            for name in BACKBONE_ATOMS:
                xyz = res.atom(name)
                if xyz is not None:
                    out[name][i] = xyz
        return out

    def to_pdb(self) -> str:
        """PDB text of the structure (what the SCWRL adapter hands the
        binary): ATOM/HETATM records, a TER per chain, END."""
        lines = []
        serial = 1
        for chain in self.chains:
            for res in chain.residues:
                record = "ATOM" if res.is_standard_aa else "HETATM"
                for an, xyz, el, bf in zip(
                    res.atom_names, res.coords, res.elements, res.bfactors
                ):
                    name_field = f" {an:<3s}" if len(an) < 4 else an
                    lines.append(
                        f"{record:<6s}{serial:>5d} {name_field:<4s} {res.res_name:<3s} "
                        f"{chain.chain_id:1s}{res.res_seq:>4d}{res.icode:1s}   "
                        f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}{1.0:6.2f}{bf:6.2f}"
                        f"          {el:>2s}  "
                    )
                    serial += 1
            lines.append(f"TER   {serial:>5d}      {chain.residues[-1].res_name if chain.residues else '':<3s} {chain.chain_id:1s}")
            serial += 1
        lines.append("END")
        return "\n".join(lines) + "\n"


def _scan_python(text: str) -> dict[str, np.ndarray]:
    """Pure-Python scanner producing the same field arrays as the native
    C++ scanner (csrc/pdbscan.cpp)."""
    coords, bfs, res_seq, model_idx = [], [], [], []
    atom_name, res_name, element, chain_id, icode, altloc, is_het = (
        [], [], [], [], [], [], []
    )
    model = 0
    model_has_atoms = False
    for line in text.splitlines():
        rec = line[:6]
        if rec == "MODEL ":
            if model_has_atoms:
                model += 1
                model_has_atoms = False
            continue
        if rec == "ENDMDL":
            model += 1
            model_has_atoms = False
            continue
        if rec not in ("ATOM  ", "HETATM") or len(line) < 54:
            continue
        try:
            seq = int(line[22:26])
            xyz = (float(line[30:38]), float(line[38:46]), float(line[46:54]))
        except ValueError:
            continue
        try:
            bf = float(line[60:66])
        except (ValueError, IndexError):
            bf = 0.0
        coords.append(xyz)
        bfs.append(bf)
        res_seq.append(seq)
        model_idx.append(model)
        atom_name.append(line[12:16].strip())
        res_name.append(line[17:20].strip())
        element.append(line[76:78].strip() if len(line) >= 78 else "")
        chain_id.append(line[21])
        icode.append(line[26].strip())
        altloc.append(line[16])
        is_het.append(rec == "HETATM")
        model_has_atoms = True
    return {
        "coords": np.asarray(coords, np.float32).reshape(-1, 3),
        "bfactors": np.asarray(bfs, np.float32),
        "res_seq": np.asarray(res_seq, np.int32),
        "model_idx": np.asarray(model_idx, np.int32),
        "atom_name": np.asarray(atom_name, dtype="U4"),
        "res_name": np.asarray(res_name, dtype="U3"),
        "element": np.asarray(element, dtype="U2"),
        "chain_id": np.asarray(chain_id, dtype="U1"),
        "icode": np.asarray(icode, dtype="U1"),
        "altloc": np.asarray(altloc, dtype="U1"),
        "is_het": np.asarray(is_het, bool),
    }


def parse_pdb_string(
    text: str,
    name: str = "",
    remap_uncommon: bool = True,
    keep_hetatms: bool = False,
    all_states: bool = False,
) -> list[Structure]:
    """Parse PDB text into one Structure per MODEL (the first only unless
    ``all_states``). Uncommon residues are remapped to standard ones with
    their backbone kept."""
    from ._native import scan_pdb_native

    fields = scan_pdb_native(text)
    if fields is None:
        fields = _scan_python(text)
    if fields["coords"].shape[0] == 0:
        raise ValueError(f"No ATOM records found in PDB {name!r}")

    model_ids = np.unique(fields["model_idx"])
    if not all_states:
        model_ids = model_ids[:1]
    structures = []
    multi = all_states and len(model_ids) > 1
    for state_i, mid in enumerate(model_ids):
        sel = fields["model_idx"] == mid
        structures.append(
            _build_structure_from_fields(
                {k: v[sel] for k, v in fields.items()},
                f"{name}_{state_i}" if multi else name,
                remap_uncommon,
                keep_hetatms,
            )
        )
    return structures


def _build_structure_from_fields(
    f: dict[str, np.ndarray], name: str, remap_uncommon: bool, keep_hetatms: bool
) -> Structure:
    n = f["coords"].shape[0]
    # altloc: per residue keep ONE conformer — 'A' if present, else the
    # smallest letter; blank-altloc atoms are shared and always kept, and
    # atoms of two conformers are never mixed.
    keep = np.ones(n, bool)
    lettered = f["altloc"] != " "
    lettered &= f["altloc"] != ""
    if lettered.any():
        chosen: dict[tuple, str] = {}
        for i in np.nonzero(lettered)[0]:
            key = (f["chain_id"][i], int(f["res_seq"][i]), f["icode"][i])
            al = f["altloc"][i]
            prev = chosen.get(key)
            chosen[key] = al if prev is None else min(al, prev)
        for i in np.nonzero(lettered)[0]:
            key = (f["chain_id"][i], int(f["res_seq"][i]), f["icode"][i])
            if f["altloc"][i] != chosen[key]:
                keep[i] = False
    # element inference where the PDB column is absent: first alphabetic char
    # of the atom name
    element = f["element"].copy()
    missing = element == ""
    if missing.any():
        inferred = np.array(
            [next((c.upper() for c in an if c.isalpha()), "C") for an in f["atom_name"][missing]],
            dtype="U2",
        )
        element[missing] = inferred
    element = np.array(
        [e.capitalize() if len(e) > 1 else e.upper() for e in element], dtype="U2"
    )

    # residue identity remap + standard-ness, vectorized over unique names
    uniq_names = {}
    for rn in np.unique(f["res_name"]):
        mapped = rn
        if remap_uncommon and rn not in AA3_TO_INT and rn in UNCOMMON_RESIDUE_DICT:
            mapped = UNCOMMON_RESIDUE_DICT[rn]
        uniq_names[rn] = (mapped, mapped in AA3_TO_INT)
    mapped_names = np.array([uniq_names[rn][0] for rn in f["res_name"]], dtype="U3")
    is_std = np.array([uniq_names[rn][1] for rn in f["res_name"]], bool)
    if not keep_hetatms:
        keep &= ~(f["is_het"] & ~is_std)  # drop waters/ligands

    idx = np.nonzero(keep)[0]
    chains: dict[str, Chain] = {}
    res_key_to_obj: dict[tuple, Residue] = {}
    flat_idx: list[int] = []
    flat_ri: list[int] = []
    std_res_counter = -1
    for i in idx:
        chain_c = f["chain_id"][i]
        key = (chain_c, int(f["res_seq"][i]), f["icode"][i])
        res = res_key_to_obj.get(key)
        if res is None:
            if chain_c not in chains:
                chains[chain_c] = Chain(chain_c, [])
            res = Residue(
                chain_c, int(f["res_seq"][i]), f["icode"][i].strip(),
                mapped_names[i], [], None, [], None, bool(is_std[i]),
            )
            res._atom_idx = []  # type: ignore[attr-defined]
            res_key_to_obj[key] = res
            chains[chain_c].residues.append(res)
            if res.is_standard_aa:
                std_res_counter += 1
                res.std_index = std_res_counter
        an = f["atom_name"][i]
        if an in res.atom_names:
            continue  # duplicate atom (altloc remnants)
        res.atom_names.append(an)
        res.elements.append(element[i])
        res._atom_idx.append(int(i))  # type: ignore[attr-defined]
        if res.is_standard_aa:
            flat_idx.append(int(i))
            flat_ri.append(std_res_counter)

    # materialize per-residue arrays as views into the scan output
    for res in res_key_to_obj.values():
        ai = np.asarray(res._atom_idx, int)  # type: ignore[attr-defined]
        res.coords = f["coords"][ai]
        res.bfactors = f["bfactors"][ai]
        del res._atom_idx  # type: ignore[attr-defined]

    # std_index was assigned in file-encounter order, but `.residues` is
    # chain-grouped: for interleaved chain records (A1, B1, A2) the orders
    # differ, so renumber both to the residues-list order.
    old_to_new = np.full(std_res_counter + 1, -1, np.int64)
    new_i = -1
    for ch in chains.values():
        for res in ch.residues:
            if res.is_standard_aa and res.std_index is not None:
                new_i += 1
                old_to_new[res.std_index] = new_i
                res.std_index = new_i
    if flat_ri:
        flat_ri = old_to_new[np.asarray(flat_ri, np.int64)].tolist()

    fi = np.asarray(flat_idx, int)
    return Structure(
        name=name,
        chains=list(chains.values()),
        coords=f["coords"][fi].reshape(-1, 3),
        elements=element[fi],
        atom_names=f["atom_name"][fi],
        res_index=np.asarray(flat_ri, np.int32),
        bfactors=f["bfactors"][fi],
    )


def load_pdb(
    path: t.Union[str, Path],
    all_states: bool = False,
    keep_hetatms: bool = False,
) -> t.Union[Structure, list[Structure]]:
    """Load a PDB file (optionally .gz): its first state, or a list of every
    state with ``all_states=True``."""
    path = Path(path)
    if path.suffix == ".gz":
        with gzip.open(str(path), "rb") as f:
            text = f.read().decode()
    else:
        text = path.read_text()
    name = path.name
    for suffix in (".gz", ".pdb1", ".pdb", ".ent"):
        if name.endswith(suffix):
            name = name[: -len(suffix)]
    structures = parse_pdb_string(
        text, name=name, all_states=all_states, keep_hetatms=keep_hetatms
    )
    return structures if all_states else structures[0]


def residue_labels(structure: Structure) -> list[tuple[str, str, str]]:
    """[(chain_id, residue_id, three-letter label)] for standard residues,
    in file order."""
    return [
        (r.chain_id, r.id, r.res_name)
        for r in structure.residues
        if r.is_standard_aa
    ]
