"""Partition sampled fastas and write AlphaFold2 SLURM scripts (80 fastas a
job): the port of ``scripts/make_af2_jobs.py``. Host only; ``--device`` is
accepted for the scripts' common interface and checked.

    python -m timed_design_tpu_torch.scripts.make_af2_jobs SAMPLES.fasta JOBS_DIR

Prints one ``sbatch`` line a job.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from . import check_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Partition fastas into AlphaFold2 jobs")
    ap.add_argument("fasta", type=Path)
    ap.add_argument("jobs_dir", type=Path)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu only when named)")
    return ap


def main(argv=None) -> list[Path]:
    from ..analyse import make_af2_slurm_script, partition_fastas

    args = build_parser().parse_args(argv)
    check_device(args.device)
    folders = partition_fastas(args.fasta, args.jobs_dir, per_folder=80)
    scripts = []
    for folder in folders:
        scripts.append(make_af2_slurm_script(folder, args.jobs_dir))
        print(f"sbatch {scripts[-1]}")
    return scripts


if __name__ == "__main__":
    main()
