"""Evaluate AlphaFold2 refolds against the design target (CA-RMSD, GDT and
mean pLDDT): the port of ``scripts/analyse_af2_results.py``. Host only;
``--device`` is accepted for the scripts' common interface and checked.

    python -m timed_design_tpu_torch.scripts.analyse_af2_results TARGET.pdb AF2_OUTPUT_DIR

Prints a CSV: ``design,rmsd,gdt1,gdt2,gdt4,gdt8,mean_plddt``.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from . import check_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Score AlphaFold2 refolds against a target")
    ap.add_argument("target", type=Path)
    ap.add_argument("af2_dir", type=Path)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu only when named)")
    return ap


def main(argv=None) -> list:
    from ..analyse import analyse_af2_folder

    args = build_parser().parse_args(argv)
    check_device(args.device)
    results = analyse_af2_folder(args.target, args.af2_dir)
    print("design,rmsd,gdt1,gdt2,gdt4,gdt8,mean_plddt")
    for r in results:
        gdt = ",".join(f"{r.gdt[c]:.3f}" for c in (1.0, 2.0, 4.0, 8.0))
        print(f"{r.design},{r.rmsd:.3f},{gdt},{r.mean_plddt:.1f}")
    return results


if __name__ == "__main__":
    main()
