"""Datasetmap formats: the port's copy of ``timed_design_tpu/io/datasetmap.py``
(what ``td-sample``, ``td-predict`` and training use of it), with the residue
order and the blacklist reader of ``timed_design_tpu/io/h5frames.py``.

  * "old": CSV rows ``pdb,chain,residue_id,label``, one row per residue;
  * "new"/SRB: 3 header lines (``ignore_uncommon False``, ``include_pdbs``,
    ``##########``) then ``<pdb_chain> <count>`` rows.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np

SRB_HEADER = "ignore_uncommon False\ninclude_pdbs\n##########\n"


@dataclasses.dataclass
class DatasetMap:
    """Either per-residue entries (old) or per-chain counts (new)."""

    # old format: [(pdb, chain, residue_id, label)]
    entries: list[tuple[str, str, str, str]] | None = None
    # new format: [(pdb_chain, count)]
    counts: list[tuple[str, int]] | None = None
    # the resolved path of the flat HDF5 dataset whose rows these entries
    # are, in order (set by io/h5frames.py::create_flat_dataset_map): the
    # loader then reads rows by position, with no lookup by key
    row_identity_for: str | None = None

    @property
    def is_old(self) -> bool:
        return self.entries is not None

    @property
    def n_residues(self) -> int:
        if self.is_old:
            return len(self.entries)
        return sum(c for _, c in self.counts)

    def to_counts(self) -> list[tuple[str, int]]:
        """Collapse per-residue entries into SRB chain counts: a trailing
        NMR state suffix ``_<digits>`` stripped, the chain appended to a
        4-letter pdb code (the JAX package's rule, which fixes the
        reference's ``"_0" in pdb`` substring test)."""
        if not self.is_old:
            return list(self.counts)
        count_dict: dict[str, int] = {}
        for pdb, chain, _, _ in self.entries:
            pdb = re.sub(r"_\d+$", "", pdb)
            if len(pdb) == 4:
                pdb += chain
            count_dict[pdb] = count_dict.get(pdb, 0) + 1
        return list(count_dict.items())


def load_datasetmap(path: Path, is_old: bool = False) -> DatasetMap:
    """Parse a datasetmap file in either format."""
    path = Path(path)
    if path.suffix != ".txt":
        raise ValueError(f"Expected .txt datasetmap, got {path.suffix}")
    lines = path.read_text().splitlines()
    if is_old:
        entries = []
        for line in lines:
            if not line.strip():
                continue
            parts = line.split(",")
            entries.append((parts[0], parts[1], parts[2], parts[3]))
        return DatasetMap(entries=entries)
    counts = []
    for line in lines[3:]:
        if not line.strip():
            continue
        pdb_chain, count = line.split()
        counts.append((pdb_chain, int(count)))
    return DatasetMap(counts=counts)


def save_datasetmap(dmap: DatasetMap, path: Path) -> Path:
    """Write the per-residue (old/CSV) format, ``datasetmap.txt``."""
    path = Path(path)
    if not dmap.is_old:
        raise ValueError("save_datasetmap writes the per-residue format; got chain counts")
    with open(path, "w") as f:
        for pdb, chain, rid, label in dmap.entries:
            f.write(f"{pdb},{chain},{rid},{label}\n")
    return path


def save_srb_datasetmap(dmap: DatasetMap, model_name: str, path_to_output: Path) -> Path:
    """Write the PDBench/SRB format ``{model}.txt``."""
    path = Path(path_to_output) / f"{model_name}.txt"
    with open(path, "w") as f:
        f.write(SRB_HEADER)
        for pdb_chain, count in dmap.to_counts():
            f.write(f"{pdb_chain} {count}\n")
    return path


def split_dataset_map(
    dmap: DatasetMap, val_fraction: float, seed: int = 0
) -> tuple[DatasetMap, DatasetMap]:
    """Structure-level train/validation split of a per-residue map: whole
    structures go to one side, a trailing NMR state suffix ``_<digits>``
    collapsed to its parent so every state of one deposit stays together.

    ``round(n_structures * val_fraction)`` of the sorted parents (at least 1
    when the fraction is > 0) go to validation, chosen by
    ``np.random.default_rng(seed).permutation``; each side keeps the map's
    row order. ``val_fraction`` 0 returns the map itself and an empty one."""
    if not dmap.is_old:
        raise ValueError("split_dataset_map needs a per-residue dataset map")
    if not 0.0 <= val_fraction < 1.0:
        raise ValueError(f"val_fraction must be in [0, 1), got {val_fraction}")

    def parent(pdb: str) -> str:
        return re.sub(r"_\d+$", "", pdb)

    structures = sorted({parent(p) for p, _, _, _ in dmap.entries})
    if val_fraction == 0.0 or not structures:
        return dmap, DatasetMap(entries=[])
    n_val = max(1, round(len(structures) * val_fraction))
    if n_val >= len(structures):
        raise ValueError(
            f"val_fraction={val_fraction} leaves no training structures "
            f"({n_val} of {len(structures)} would go to validation)"
        )
    order = np.random.default_rng(seed).permutation(len(structures))
    val_set = {structures[i] for i in order[:n_val]}
    return (DatasetMap(entries=[e for e in dmap.entries if parent(e[0]) not in val_set]),
            DatasetMap(entries=[e for e in dmap.entries if parent(e[0]) in val_set]))


def _residue_sort_key(rid: str) -> tuple:
    """Natural order of residue ids, per id: numeric part, then insertion
    code ('2' < '10' < '100' < '100A' < '100B'); ids without a number last."""
    m = re.match(r"^\s*(-?\d+)(.*)$", rid)
    if m:
        return (0, int(m.group(1)), m.group(2))
    return (1, 0, rid)


def get_pdb_keys_to_filter(pdb_key_path: Path, file_extension: str = ".txt") -> list[str]:
    """The 4-letter PDB codes listed in the blacklist files under
    ``pdb_key_path`` (a directory; every ``*{file_extension}`` below it)."""
    files = list(Path(pdb_key_path).glob(f"**/*{file_extension}"))
    if not files:
        raise ValueError("Expected at least 1 pdb key file.")
    keys: list[str] = []
    for f in files:
        for token in f.read_text().split():
            keys.append(token[:4])
    return keys
