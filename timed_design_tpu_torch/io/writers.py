"""Writers of the sampling path, byte-equal to the JAX package's: the port's
copy of what ``td-sample`` and its inputs use of
``timed_design_tpu/io/writers.py``.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def save_dict_to_fasta(
    pdb_to_sequence: dict[str, str], model_name: str, path_to_output: Path = Path.cwd()
) -> Path:
    """``>{pdb}\\n{seq}`` records in ``{model_name}.fasta``."""
    path = Path(path_to_output) / f"{model_name}.fasta"
    with open(path, "w") as f:
        for pdb, seq in pdb_to_sequence.items():
            f.write(f">{pdb}\n{seq}\n")
    return path


def save_prediction_csv(
    probs: np.ndarray, model_name: str, path_to_output: Path = Path.cwd(),
    rotamer: bool = False,
) -> Path:
    """Append a probability block to ``{model}.csv`` (``{model}_rot.csv``
    for a rotamer head), cast to float16 first as the reference does."""
    path = Path(path_to_output) / f"{model_name}{'_rot.csv' if rotamer else '.csv'}"
    with open(path, "ab") as f:
        np.savetxt(f, np.asarray(probs).astype(np.float16), delimiter=",")
    return path


def save_sampled(
    pdb_to_sampled: dict[str, list[tuple]],
    filename: str,
    mode: str = "all",
) -> list[str]:
    """Sampled sequences to ``{filename}.json`` and/or ``{filename}.fasta``
    (``mode``: all, json or fasta), and always the metrics CSV
    ``{filename}_metrics.csv``. ``pdb_to_sampled`` maps pdb -> [(sequence,
    charge, iso_ph, mw, ext), ...]."""
    output_paths = []
    if mode != "fasta":
        path = f"{filename}.json"
        output_paths.append(path)
        with open(path, "w") as f:
            json.dump(
                {pdb: [list(s) for s in seqs] for pdb, seqs in pdb_to_sampled.items()},
                f,
            )
    if mode != "json":
        path = f"{filename}.fasta"
        output_paths.append(path)
        with open(path, "w") as f:
            for pdb, seq_list in pdb_to_sampled.items():
                for i, seq in enumerate(seq_list):
                    f.write(f">{pdb}_{i}\n{seq[0]}\n")
    path = f"{filename}_metrics.csv"
    output_paths.append(path)
    with open(path, "w") as f:
        f.write(
            "pdb,sequence,charge,isoelectric_point,molecular_weight,molar_extinction\n"
        )
        for pdb, seq_list in pdb_to_sampled.items():
            for seq in seq_list:
                f.write(f"{pdb},{seq[0]},{seq[1]},{seq[2]},{seq[3]},{seq[4]}\n")
    return output_paths


def load_prediction_matrix(path: Path, dtype=np.float64) -> np.ndarray:
    """Load a probability CSV back."""
    return np.loadtxt(Path(path), delimiter=",", dtype=dtype, ndmin=2)
