"""NetSolP solubility/usability adapter (an optional external tool): the
port of ``timed_design_tpu/analyse/netsolp.py``.

NetSolP-1.0 is an external ESM-based predictor. This adapter runs its
``predict.py`` over sampled fastas when a checkout is given, and joins the
per-sequence scores onto the sampler's metrics CSV.
"""
from __future__ import annotations

import csv
import subprocess
import tempfile
import typing as t
from pathlib import Path


class NetSolPNotFoundError(RuntimeError):
    pass


def run_netsolp(
    fasta_path: Path,
    netsolp_dir: Path,
    models_dir: Path | None = None,
    model_type: str = "ESM12",
    prediction_type: str = "S",  # S = solubility, U = usability, SU = both
    python_exe: str = "python",
) -> dict[str, dict[str, float]]:
    """Run NetSolP over a fasta; returns {seq_id: {metric: score}}.

    The invocation is ``predict.py --FASTA_PATH ... --OUTPUT_PATH ...
    --MODEL_TYPE ESM12 --PREDICTION_TYPE S``.
    """
    netsolp_dir = Path(netsolp_dir)
    predict_py = netsolp_dir / "predict.py"
    if not predict_py.exists():
        raise NetSolPNotFoundError(
            f"NetSolP predict.py not found under {netsolp_dir}. Download "
            "NetSolP-1.0 (https://services.healthtech.dtu.dk/services/NetSolP-1.0/)"
        )
    with tempfile.TemporaryDirectory() as td:
        out_csv = Path(td) / "preds.csv"
        cmd = [
            python_exe, str(predict_py),
            "--FASTA_PATH", str(fasta_path),
            "--OUTPUT_PATH", str(out_csv),
            "--MODEL_TYPE", model_type,
            "--PREDICTION_TYPE", prediction_type,
        ]
        if models_dir is not None:
            cmd += ["--MODELS_PATH", str(models_dir)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0 or not out_csv.exists():
            raise ChildProcessError(
                f"NetSolP failed ({proc.returncode}): {proc.stderr[-500:]}"
            )
        results: dict[str, dict[str, float]] = {}
        with open(out_csv) as f:
            for row in csv.DictReader(f):
                sid = row.get("sid") or row.get("id") or row.get("name")
                results[sid] = {
                    k: float(v)
                    for k, v in row.items()
                    if k not in ("sid", "id", "name", "fasta", "sequence")
                    and _is_float(v)
                }
        return results


def _is_float(v: t.Any) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def annotate_samples_with_netsolp(
    samples_fasta: Path, metrics_csv: Path, netsolp_dir: Path, **kw
) -> Path:
    """Join NetSolP scores onto a sampler metrics CSV (adds columns)."""
    scores = run_netsolp(samples_fasta, netsolp_dir, **kw)
    metrics_csv = Path(metrics_csv)
    rows = list(csv.DictReader(open(metrics_csv)))
    metric_keys = sorted({k for s in scores.values() for k in s})
    out_path = metrics_csv.with_name(metrics_csv.stem + "_netsolp.csv")
    with open(out_path, "w", newline="") as f:
        writer = csv.DictWriter(
            f, fieldnames=list(rows[0].keys()) + metric_keys if rows else metric_keys
        )
        writer.writeheader()
        # fasta ids are {pdb}_{i} with i counting per pdb (io/writers.py
        # save_sampled), while the metrics CSV repeats the bare pdb per
        # sample row: rebuild per-pdb sample indices for the join
        per_pdb_counter: dict[str, int] = {}
        for row in rows:
            i = per_pdb_counter.get(row["pdb"], 0)
            per_pdb_counter[row["pdb"]] = i + 1
            row.update(scores.get(f"{row['pdb']}_{i}", {}))
            writer.writerow(row)
    return out_path
