"""Temperature-sweep Monte-Carlo sampling over saved predictions: the port of
``scripts/run_sampling.py``. Each temperature samples every structure in
one launch of the batched sampling kernel.

    python -m timed_design_tpu_torch.scripts.run_sampling MODEL.csv MODEL.txt \\
        [SAMPLE_N] [--device cuda]

Prints each temperature (``T=...:``) and the paths it wrote.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from . import check_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Monte-Carlo sampling at each temperature")
    ap.add_argument("pred", type=Path, help="the prediction matrix (MODEL.csv)")
    ap.add_argument("dmap", type=Path, help="its datasetmap (MODEL.txt)")
    ap.add_argument("sample_n", type=int, nargs="?", default=200)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu only when named)")
    return ap


def main(argv=None) -> dict[float, list[str]]:
    from ..analyse import run_temperature_sweep

    args = build_parser().parse_args(argv)
    out = run_temperature_sweep(args.pred, args.dmap, sample_n=args.sample_n,
                                device=check_device(args.device))
    for temp, paths in out.items():
        print(f"T={temp}:", *paths, sep="\n  ")
    return out


if __name__ == "__main__":
    main()
