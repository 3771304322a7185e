"""Monte-Carlo sequence sampling from saved predictions, on PyTorch (the
port of ``td-sample``).

    python -m timed_design_tpu_torch.cli.sample --path_to_pred_matrix TIMED_rot.csv \
        --path_to_datasetmap TIMED.txt --sample_n 100 --temperature 0.5

The flags of ``timed_design_tpu/cli/sample.py`` (``--workers`` is accepted
and ignored), plus ``--device`` (default ``cuda``; without a card it exits
with a message, and runs on the CPU only with ``--device cpu``). Every
structure is sampled in one launch of the batched sampling kernel.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch

from ..sample import SampleConfig, main_sample


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MC-sample sequences from prediction matrix")
    p.add_argument("--path_to_pred_matrix", type=str, required=True)
    p.add_argument("--path_to_datasetmap", type=str, default="datasetmap.txt")
    p.add_argument("--predict_rotamers", action="store_true")
    p.add_argument("--sample_n", type=int, default=100)
    p.add_argument("--save_as", type=str, default="all", choices=["fasta", "json", "all"])
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--support_old_datasetmap", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--workers", type=int, default=0,
                   help="Ignored (sampling runs on the device); kept for CLI parity")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the sampler (default cuda; cpu only when named)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here; "
                         "pass --device cpu to sample on the CPU")
    paths = main_sample(
        SampleConfig(
            path_to_pred_matrix=Path(args.path_to_pred_matrix),
            path_to_datasetmap=Path(args.path_to_datasetmap),
            predict_rotamers=args.predict_rotamers,
            sample_n=args.sample_n,
            save_as=args.save_as,
            temperature=args.temperature,
            support_old_datasetmap=args.support_old_datasetmap,
            seed=args.seed,
            device=args.device,
        )
    )
    print("Wrote:", *paths, sep="\n  ")


if __name__ == "__main__":
    main()
