"""Datasetmap formats: the port's copy of ``timed_design_tpu/io/datasetmap.py``
(what the sampling path uses of it).

  * "old": CSV rows ``pdb,chain,residue_id,label``, one row per residue;
  * "new"/SRB: 3 header lines (``ignore_uncommon False``, ``include_pdbs``,
    ``##########``) then ``<pdb_chain> <count>`` rows.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path


@dataclasses.dataclass
class DatasetMap:
    """Either per-residue entries (old) or per-chain counts (new)."""

    # old format: [(pdb, chain, residue_id, label)]
    entries: list[tuple[str, str, str, str]] | None = None
    # new format: [(pdb_chain, count)]
    counts: list[tuple[str, int]] | None = None

    @property
    def is_old(self) -> bool:
        return self.entries is not None


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
