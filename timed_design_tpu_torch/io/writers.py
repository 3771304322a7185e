"""Writers of ``td-predict`` and ``td-sample``, byte-equal to the JAX
package's: the port's copy of what they use of
``timed_design_tpu/io/writers.py``.

The float16 CSV is a gather from a byte table of every float16 value's
``%.18e`` text; full-precision rows go through the native formatter
(``fast_fmt.py``, ``csrc/fmt_csv.cpp``) where it takes them, else
``np.savetxt``: the same bytes either way.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .datasetmap import SRB_HEADER
from .fast_fmt import write_e18_csv


def save_dict_to_fasta(
    pdb_to_sequence: dict[str, str], model_name: str, path_to_output: Path = Path.cwd()
) -> Path:
    """``>{pdb}\\n{seq}`` records in ``{model_name}.fasta``."""
    path = Path(path_to_output) / f"{model_name}.fasta"
    with open(path, "w") as f:
        for pdb, seq in pdb_to_sequence.items():
            f.write(f">{pdb}\n{seq}\n")
    return path


_F16_CSV_TABLE: np.ndarray | None = None


def _f16_csv_table() -> np.ndarray:
    """(65536, 25) uint8: ``'%.18e' % v`` and a comma for every float16 bit
    pattern. Finite non-negative values only; the other rows stay empty and
    make ``write_float16_csv`` fall back. Every such string is 24 bytes, so
    a CSV row is a fixed-width gather. Built once, on first use."""
    global _F16_CSV_TABLE
    if _F16_CSV_TABLE is None:
        vals = np.arange(65536, dtype=np.uint16).view(np.float16)
        # signbit, not >= 0: -0.0 formats as 25 bytes
        ok = np.isfinite(vals) & ~np.signbit(vals)
        tab = np.zeros((65536, 25), dtype=np.uint8)
        f64 = vals.astype(np.float64)
        for i in np.nonzero(ok)[0]:
            s = b"%.18e" % f64[i]
            assert len(s) == 24, s
            tab[i, :24] = np.frombuffer(s, np.uint8)
        tab[:, 24] = ord(",")
        _F16_CSV_TABLE = tab
    return _F16_CSV_TABLE


def write_float16_csv(f, data: np.ndarray, rows_per_chunk: int | None = None) -> bool:
    """Write ``data`` as float16 CSV rows to the BINARY file ``f``,
    byte-equal to ``np.savetxt(f, data.astype(float16), delimiter=',')``.
    Returns False, having written nothing, when the data holds a negative
    or non-finite value (the caller then falls back to ``np.savetxt``)."""
    a = np.ascontiguousarray(np.asarray(data), np.float16)
    if a.ndim != 2 or a.size == 0:
        return False
    with np.errstate(invalid="ignore"):
        if not bool(np.isfinite(a).all()) or bool(np.signbit(a).any()):
            return False
    # chunked gather: the transient buffer stays near 32 MB
    table = _f16_csv_table()
    codes = a.view(np.uint16)
    if rows_per_chunk is None:
        rows_per_chunk = max(1, (32 << 20) // (a.shape[1] * 25))
    for start in range(0, a.shape[0], rows_per_chunk):
        buf = table[codes[start : start + rows_per_chunk]]
        buf[:, -1, 24] = ord("\n")
        f.write(buf)
    return True


def write_prediction_rows(f, rows: np.ndarray, float16: bool) -> None:
    """One probability block to an open BINARY CSV file: float16 through the
    byte table, full precision through the native formatter, where each
    takes the rows; else ``np.savetxt``."""
    if float16 and write_float16_csv(f, rows):
        return
    if not float16 and write_e18_csv(f, rows):
        return
    data = np.asarray(rows)
    if float16:
        data = data.astype(np.float16)
    np.savetxt(f, data, delimiter=",")


def write_int_csv(f, data: np.ndarray) -> bool:
    """Single-digit integer CSV rows to the BINARY file ``f``, byte-equal to
    ``np.savetxt(f, data, delimiter=',', fmt='%i')``. Returns False, having
    written nothing, for a non-integer dtype or a value outside 0..9."""
    a = np.asarray(data)
    if a.ndim != 2 or a.size == 0 or not np.issubdtype(a.dtype, np.integer):
        return False
    if int(a.min()) < 0 or int(a.max()) > 9:
        return False
    rows_per_chunk = max(1, (32 << 20) // (a.shape[1] * 2))
    for start in range(0, a.shape[0], rows_per_chunk):
        block = a[start : start + rows_per_chunk]
        buf = np.empty(block.shape + (2,), np.uint8)
        buf[..., 0] = block.astype(np.uint8) + ord("0")
        buf[..., 1] = ord(",")
        buf[:, -1, 1] = ord("\n")
        f.write(buf)
    return True


def save_encoded_labels(
    y_true: np.ndarray, path_to_output: Path = Path.cwd(), append: bool = True
) -> Path:
    """``encoded_labels.csv``: integer one-hot rows."""
    path = Path(path_to_output) / "encoded_labels.csv"
    y = np.asarray(y_true)
    with open(path, "ab" if append else "wb") as f:
        if not write_int_csv(f, y):
            np.savetxt(f, y, delimiter=",", fmt="%i")
    return path


def save_consensus_probs(
    pdb_to_consensus_prob: dict[str, np.ndarray],
    model_name: str,
    path_to_output: Path = Path.cwd(),
) -> tuple[Path, Path]:
    """SRB-format consensus outputs: ``{model}_consensus.txt`` (the count
    header) and ``{model}_consensus.csv`` (the stacked probabilities), both
    written whole from the complete consensus, so truncated first."""
    path_txt = Path(path_to_output) / f"{model_name}_consensus.txt"
    path_csv = Path(path_to_output) / f"{model_name}_consensus.csv"
    with open(path_txt, "w") as d, open(path_csv, "w") as p:
        d.write(SRB_HEADER)
        for pdb, predictions in pdb_to_consensus_prob.items():
            d.write(f"{pdb} {len(predictions)}\n")
            np.savetxt(p, np.asarray(predictions), delimiter=",")
    return path_txt, path_csv


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
