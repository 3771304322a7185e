"""SCWRL4 side-chain packing adapter (an optional external tool): the port
of ``timed_design_tpu/analyse/scwrl.py``.

SCWRL4 is a licensed binary and stays a subprocess: failures per structure
are recorded into ``errors_scwrl{suffix}.csv`` instead of aborting the run,
and a missing binary raises ``ScwrlNotFoundError``.
"""
from __future__ import annotations

import shutil
import subprocess
import tempfile
import typing as t
from pathlib import Path

from ..structure.pdb import Structure, parse_pdb_string


class ScwrlNotFoundError(RuntimeError):
    pass


def find_scwrl(scwrl_path: t.Optional[Path] = None) -> Path:
    if scwrl_path and Path(scwrl_path).exists():
        return Path(scwrl_path)
    found = shutil.which("Scwrl4") or shutil.which("scwrl4")
    if not found:
        raise ScwrlNotFoundError(
            "SCWRL4 binary not found. Install it and pass scwrl_path= or put "
            "Scwrl4 on PATH (it is an external licensed tool)."
        )
    return Path(found)


def parse_scwrl_score(stdout: str) -> float:
    """Extract the total minimal energy score from SCWRL4 stdout."""
    for line in stdout.splitlines():
        if "Total minimal energy of the graph" in line:
            return float(line.split("=")[-1].strip())
    raise ChildProcessError("SCWRL failed to run (no score in output).")


def pack_side_chains_scwrl(
    structure: Structure,
    sequences: t.Sequence[str],
    scwrl_path: t.Optional[Path] = None,
    rigid_rotamer_model: bool = False,
    hydrogens: bool = False,
) -> tuple[Structure, float]:
    """Pack ``sequences`` (one per chain) onto the backbone with SCWRL4.

    Returns (packed structure, scwrl score): the structure's PDB text and
    the sequence file go to the binary, its output PDB and score come back.

    The sequence file is written VERBATIM, concatenated across chains with
    no case change: SCWRL4 reads LOWER-case letters as "keep this side chain
    fixed in its input conformation", so lower-casing a designed sequence
    would make SCWRL skip the repack and score the unmodified input.
    ``hydrogens=False`` passes ``-h`` (omit hydrogens).
    """
    exe = find_scwrl(scwrl_path)
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        in_pdb = td / "in.pdb"
        seq_file = td / "seq.txt"
        out_pdb = td / "out.pdb"
        in_pdb.write_text(structure.to_pdb())
        seq_file.write_text("".join(sequences))
        cmd = [str(exe), "-i", str(in_pdb), "-o", str(out_pdb), "-s", str(seq_file)]
        if rigid_rotamer_model:
            cmd.append("-v")
        if not hydrogens:
            cmd.append("-h")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        score = parse_scwrl_score(proc.stdout)
        if not out_pdb.exists():
            raise ChildProcessError(f"SCWRL produced no output: {proc.stdout[-500:]}")
        packed = parse_pdb_string(out_pdb.read_text(), name=structure.name)[0]
    return packed, score


def analyse_with_scwrl(
    pdb_to_seq: dict[str, str],
    pdb_to_assembly: dict[str, Structure],
    output_path: Path,
    suffix: str,
    scwrl_path: t.Optional[Path] = None,
) -> tuple[dict[str, float], dict[str, str]]:
    """Pack every sequence of ``pdb_to_seq``; per-structure failures are
    collected into ``errors_scwrl{suffix}.csv`` instead of aborting the
    run."""
    output_path = Path(output_path)
    pdb_to_scores: dict[str, float] = {}
    pdb_to_errors: dict[str, str] = {}
    for pdb, seq in pdb_to_seq.items():
        out_pdb = output_path / f"{pdb}_{suffix}.pdb"
        if out_pdb.exists():
            pdb_to_errors[pdb] = f"PDB {pdb} at {out_pdb} already exists."
            continue
        assembly = pdb_to_assembly.get(pdb[:4])
        if assembly is None:
            pdb_to_errors[pdb] = f"Error with structure {pdb}. Assembly not found."
            continue
        n_chains = len(assembly.chains)
        seqs = [seq] * n_chains if n_chains > 1 else [seq]
        try:
            packed, score = pack_side_chains_scwrl(assembly, seqs, scwrl_path)
            pdb_to_scores[pdb] = score
            out_pdb.write_text(packed.to_pdb())
        except (ValueError, KeyError) as e:
            pdb_to_errors[pdb] = f"Attempted packing on structure {pdb}, but got {e}"
        except (ChildProcessError, ScwrlNotFoundError) as e:
            pdb_to_errors[pdb] = f"SCWRL failed on structure {pdb}: {e}"
    err_path = output_path / f"errors_scwrl{suffix}.csv"
    with open(err_path, "w") as f:
        for pdb, err in pdb_to_errors.items():
            f.write(f"{pdb},{err}\n")
    print(
        f"Got {len(pdb_to_errors)} errors packing {len(pdb_to_seq)} sequences; "
        f"errors saved to {err_path}"
    )
    return pdb_to_scores, pdb_to_errors
