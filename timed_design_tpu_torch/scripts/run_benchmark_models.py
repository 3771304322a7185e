"""Benchmark the whole model zoo over a frame dataset: the port of
``scripts/run_benchmark_models.py``.

Models resolve to released ``.h5`` weights found in ``--models-dir``;
architectures without weights are skipped unless ``--allow-random-weights``
is given (timing-only runs: recovery from random weights means nothing).
Prints a line for each skipped model, then the metrics of each model as JSON.

    python -m timed_design_tpu_torch.scripts.run_benchmark_models DATASET.hdf5 \\
        [OUTPUT_DIR] [--models-dir models/] [--allow-random-weights] [--device cuda]

Under ``torchrun`` every rank joins the world and each batch is split over
all of them (``parallel.make_mesh()``); process index 0 alone writes and
prints.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from . import check_device

ZOO = ["TIMED", "TIMED_Deep", "ProDCoNN", "DenseNet", "DenseCPD"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Benchmark the model zoo over a frame dataset")
    ap.add_argument("dataset", type=Path)
    ap.add_argument("output", type=Path, nargs="?", default=Path("benchmark_out"))
    ap.add_argument("--models-dir", type=Path, default=Path("models"))
    ap.add_argument("--allow-random-weights", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu only when named)")
    return ap


def main(argv=None) -> dict | None:
    """Run the benchmark; returns the metrics (None on a rank other than
    process index 0 under torchrun)."""
    from ..analyse import run_model_benchmark
    from ..parallel.distributed import process_index
    from ..parallel.mesh import launched_mesh

    args = build_parser().parse_args(argv)
    check_device(args.device)
    with launched_mesh(args.device) as mesh:
        writer = process_index() == 0
        models: list[str] = []
        for name in ZOO:
            h5 = args.models_dir / f"{name}.h5"
            if h5.exists():
                models.append(str(h5))
            elif args.allow_random_weights:
                models.append(name)
            elif writer:
                print(f"skipping {name}: no {h5} "
                      "(pass --allow-random-weights for timing-only runs)")
        results = run_model_benchmark(
            models, args.dataset, args.output, batch_size=512,
            allow_random_weights=args.allow_random_weights, device=args.device, mesh=mesh,
        )
    if writer:
        print(json.dumps(results, indent=2, default=float))
    return results


if __name__ == "__main__":
    main()
