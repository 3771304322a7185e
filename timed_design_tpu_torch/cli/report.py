"""``td-report`` on PyTorch: the port of ``timed_design_tpu/cli/report.py``.

    python -m timed_design_tpu_torch.cli.report \\
        --path_to_pred_matrix out/TIMED.csv --path_to_datasetmap out/datasetmap.txt

Rebuilds the static HTML design report (``report.py``) from a run's saved
probability CSV and datasetmap, so no model and no device is needed (and
there is no ``--device``). It draws with matplotlib: where matplotlib is
missing it exits with a message that names it, before reading any file.
"""
from __future__ import annotations

import argparse
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Render a self-contained HTML report from saved predictions"
    )
    p.add_argument("--path_to_pred_matrix", type=str, required=True,
                   help="{model}.csv or {model}_rot.csv from td-predict")
    p.add_argument("--path_to_datasetmap", type=str, default="datasetmap.txt")
    p.add_argument("--path_to_output", type=str, default=".")
    p.add_argument("--predict_rotamers", action="store_true",
                   help="Matrix is 338-class (auto-detected from width; "
                        "flag kept for sample-CLI symmetry)")
    p.add_argument("--is_structure_nmr", action="store_true",
                   help="Decode an NMR multi-state consensus section")
    p.add_argument("--support_old_datasetmap", action="store_true",
                   help="Datasetmap is the per-residue (old) format")
    p.add_argument("--model_name", type=str, default=None,
                   help="Report title/filename stem (default: matrix stem)")
    return p


def main(argv=None) -> Path:
    """Run td-report; returns the report's path."""
    args = build_parser().parse_args(argv)
    from ..analyse.plots import require_pyplot

    require_pyplot("td-report")
    from ..constants import ROTAMER_CATEGORIES
    from ..io import extract_sequences, load_datasetmap, load_prediction_matrix
    from ..report import write_design_report

    matrix_path = Path(args.path_to_pred_matrix)
    P = load_prediction_matrix(matrix_path)
    if args.predict_rotamers and P.shape[1] != 338:
        # 338 categories on 20-class argmax indices would decode garbage
        raise SystemExit(
            f"--predict_rotamers given but {matrix_path.name} has "
            f"{P.shape[1]} columns (a rotamer matrix has 338)"
        )
    rotamer = P.shape[1] == 338
    dmap = load_datasetmap(Path(args.path_to_datasetmap), is_old=args.support_old_datasetmap)
    decoded = extract_sequences(
        dmap, P,
        rotamer_categories=ROTAMER_CATEGORIES if rotamer else None,
        is_consensus=args.is_structure_nmr,
    )
    name = args.model_name or matrix_path.stem.removesuffix("_rot")
    out = write_design_report(
        decoded.pdb_to_sequence,
        decoded.pdb_to_real_sequence,
        decoded.pdb_to_probability,
        Path(args.path_to_output),
        model_name=name,
        pdb_to_consensus=decoded.pdb_to_consensus,
    )
    print(f"Design report written to {out}")
    return out


if __name__ == "__main__":
    main()
