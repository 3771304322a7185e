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
        one row per standard residue in file order; the first atom of a name
        in a residue, as ``Residue.atom`` gives it.

        One scatter of the flat arrays, whose atoms ``res_index`` numbers by
        residue, unless a residue's records were split apart in the file
        (A1, A2, A1): the parser then numbers its later atoms by the other
        residue (the JAX package's numbering), and the residues' own atoms
        are scattered instead."""
        std = [r for c in self.chains for r in c.residues if r.is_standard_aa]
        counts = [len(r.atom_names) for r in std]
        rows, names, coords = self.res_index, self.atom_names, self.coords
        if not np.array_equal(np.bincount(rows, minlength=len(std)), counts):
            rows = np.repeat(np.arange(len(std)), counts)
            names = np.array([n for r in std for n in r.atom_names], "U4")
            coords = np.concatenate([r.coords for r in std])
        n = len(BACKBONE_ATOMS)
        slot = np.full(len(names), n)
        for k, name in enumerate(BACKBONE_ATOMS):
            slot[names == name] = k
        _, first = np.unique(rows * (n + 1) + slot, return_index=True)
        first = first[slot[first] < n]
        block = np.full((len(std), n, 3), np.nan, np.float32)
        block[rows[first], slot[first]] = coords[first]
        return {name: block[:, k] for k, name in enumerate(BACKBONE_ATOMS)}

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


def distinct_rows(*columns: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The rows of parallel ``columns`` by value: the index of each distinct
    row's first occurrence, and each row's number among the distinct rows.

    Columns are integers, or unicode read by their code points: no string
    is compared or sorted. The columns' bits lie side by side in one int64
    a row, renumbered densely wherever they would pass 63 bits."""
    n = len(columns[0])
    parts: list[np.ndarray] = []
    for c in columns:
        if c.dtype.kind == "U":
            parts += list(np.ascontiguousarray(c).view(np.uint32)
                          .reshape(n, c.dtype.itemsize // 4).T)
        else:
            parts.append(c)
    key, used = np.zeros(n, np.int64), 0
    for part in parts:
        part = part.astype(np.int64)
        part -= part.min(initial=0)
        bits = int(part.max(initial=0)).bit_length()
        if used + bits > 63:
            key = np.unique(key, return_inverse=True)[1].reshape(n)
            used = int(key.max(initial=0)).bit_length()
        key = (key << bits) | part
        used += bits
    _, first, ids = np.unique(key, return_index=True, return_inverse=True)
    return first, ids.reshape(n)


def _objects(values: np.ndarray) -> np.ndarray:
    """The numpy scalars of ``values`` in an object array, one object for
    each element: gathered from it, ``tolist`` gives numpy strings."""
    out = np.empty(len(values), object)
    out[:] = list(values)
    return out


def scan_pdb_text(text: str) -> tuple[dict[str, np.ndarray], bool]:
    """The field arrays of the ATOM/HETATM records of PDB text, and whether
    the C++ scanner made them (else the Python one did)."""
    from ._native import scan_pdb_native

    fields = scan_pdb_native(text)
    if fields is not None:
        return fields, True
    return _scan_python(text), False


def structures_from_fields(
    fields: dict[str, np.ndarray],
    name: str = "",
    remap_uncommon: bool = True,
    keep_hetatms: bool = False,
    all_states: bool = False,
) -> list[Structure]:
    """The Structures of a scan's field arrays (``parse_pdb_string``)."""
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
    return structures_from_fields(
        scan_pdb_text(text)[0], name, remap_uncommon, keep_hetatms, all_states)


def _capital(element: str) -> str:
    return element.capitalize() if len(element) > 1 else element.upper()


def _build_structure_from_fields(
    f: dict[str, np.ndarray], name: str, remap_uncommon: bool, keep_hetatms: bool
) -> Structure:
    """One model's Structure, in array passes over its field arrays; the one
    Python loop makes the residue tree, a residue at a time."""
    chain_cp = np.ascontiguousarray(f["chain_id"], "U1").view(np.uint32)
    # residues keyed by (chain, res_seq, icode), in integers
    _, res_of = distinct_rows(chain_cp, f["res_seq"], f["icode"])
    # altloc: per residue keep ONE conformer — 'A' if present, else the
    # smallest letter; blank-altloc atoms are shared and always kept, and
    # atoms of two conformers are never mixed.
    altloc = np.ascontiguousarray(f["altloc"], "U1").view(np.uint32).astype(np.int64)
    lettered = (altloc != ord(" ")) & (altloc != 0)
    chosen = np.full(int(res_of.max()) + 1, np.iinfo(np.int64).max)
    np.minimum.at(chosen, res_of[lettered], altloc[lettered])
    keep = ~lettered | (altloc == chosen[res_of])

    # elements, a distinct value at a time: capitalised; where the PDB column
    # is absent, the first letter of the atom name
    name_first, name_of = distinct_rows(f["atom_name"])
    el_first, el_of = distinct_rows(f["element"])
    given = [_capital(e) for e in f["element"][el_first]]
    inferred = np.array([next((c.upper() for c in an if c.isalpha()), "C")
                         for an in f["atom_name"][name_first]], "U2")
    el_table = np.array(given + [_capital(e) for e in inferred], "U2")
    el_of = np.where(f["element"] == "", len(given) + name_of, el_of)
    element = el_table[el_of]

    # residue names remapped, and their standard-ness, a distinct name at a time
    rn_first, rn_of = distinct_rows(f["res_name"])
    mapped = []
    for rn in f["res_name"][rn_first]:
        if remap_uncommon and rn not in AA3_TO_INT and rn in UNCOMMON_RESIDUE_DICT:
            rn = UNCOMMON_RESIDUE_DICT[rn]
        mapped.append(rn)
    mapped_names = np.array(mapped, "U3")[rn_of]
    is_std = np.array([rn in AA3_TO_INT for rn in mapped], bool)[rn_of]
    if not keep_hetatms:
        keep &= ~(f["is_het"] & ~is_std)  # drop waters/ligands

    kept = np.flatnonzero(keep)
    # a residue keeps the first atom of each name (altloc remnants dropped)
    pair_first, _ = distinct_rows(res_of[kept], name_of[kept])
    kept = kept[np.sort(pair_first)]
    # residues in the order they are first met, each described by its first atom
    first_pos, local = distinct_rows(res_of[kept])
    order = np.argsort(first_pos)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    local = rank[local]  # each kept atom's residue, numbered in order of meeting
    head = kept[first_pos[order]]
    n_res = len(head)
    # chains in the order they are first met; residues grouped by chain
    chain_first, chain_of = distinct_rows(chain_cp[head])
    chain_rank = np.empty_like(chain_first)
    chain_rank[np.argsort(chain_first)] = np.arange(len(chain_first))
    chain_of = chain_rank[chain_of]
    grouped = np.lexsort((np.arange(n_res), chain_of))
    res_std = is_std[head]
    std_index = np.full(n_res, -1, np.int64)
    std_rows = grouped[res_std[grouped]]
    std_index[std_rows] = np.arange(len(std_rows))

    # each residue's atoms as slices of arrays gathered once
    by_res = kept[np.argsort(local, kind="stable")]
    ends = np.cumsum(np.bincount(local, minlength=n_res)).tolist()
    coords, bfactors = f["coords"][by_res], f["bfactors"][by_res]
    atom_names = _objects(f["atom_name"][name_first])[name_of[by_res]].tolist()
    elements = _objects(el_table)[el_of[by_res]].tolist()

    chains = [Chain(c, []) for c in _objects(f["chain_id"][head[np.sort(chain_first)]]).tolist()]
    for j, (chain_i, chain_c, seq, icode, res_name, std, std_i) in enumerate(zip(
            chain_of.tolist(), _objects(f["chain_id"][head]).tolist(),
            f["res_seq"][head].tolist(), f["icode"][head].tolist(),
            _objects(mapped_names[head]).tolist(), res_std.tolist(), std_index.tolist())):
        s, e = (ends[j - 1] if j else 0), ends[j]
        chains[chain_i].residues.append(Residue(
            chain_c, seq, icode.strip(), res_name, atom_names[s:e], coords[s:e],
            elements[s:e], bfactors[s:e], std, std_i if std else None))

    # the flat arrays: standard residues' atoms in file order, each numbered
    # by the standard residue met last when it was read: its own, unless its
    # residue's records are split apart by another's (A1, A2, A1)
    met = np.zeros(len(kept), bool)
    met[first_pos] = True
    last_met = np.cumsum(met & res_std[local]) - 1
    flat = res_std[local]
    fi = kept[flat]
    return Structure(
        name=name,
        chains=chains,
        coords=f["coords"][fi].reshape(-1, 3),
        elements=element[fi],
        atom_names=f["atom_name"][fi],
        res_index=std_index[np.flatnonzero(res_std)][last_met[flat]].astype(np.int32),
        bfactors=f["bfactors"][fi],
    )


def read_pdb_file(path: t.Union[str, Path]) -> tuple[str, str]:
    """The text of a PDB file (optionally .gz) and its structure name: the
    file name without .gz/.pdb1/.pdb/.ent."""
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
    return text, name


def load_pdb(
    path: t.Union[str, Path],
    all_states: bool = False,
    keep_hetatms: bool = False,
) -> t.Union[Structure, list[Structure]]:
    """Load a PDB file (optionally .gz): its first state, or a list of every
    state with ``all_states=True``."""
    text, name = read_pdb_file(path)
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
