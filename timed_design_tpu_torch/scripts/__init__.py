"""The analysis scripts of the repository's ``scripts/`` on the port's side,
one module each, with the same arguments and output plus ``--device``:

    python -m timed_design_tpu_torch.scripts.run_benchmark_models DATASET.hdf5 [OUT]
    python -m timed_design_tpu_torch.scripts.run_sampling MODEL.csv MODEL.txt [SAMPLE_N]
    python -m timed_design_tpu_torch.scripts.make_af2_jobs SAMPLES.fasta JOBS_DIR
    python -m timed_design_tpu_torch.scripts.analyse_af2_results TARGET.pdb AF2_DIR

They run on the card by default; ``--device cpu`` names the CPU.
"""
from __future__ import annotations

import torch


def check_device(device: str) -> str:
    """``device``, or exit with a message where it names a card this machine
    does not have (nothing falls back to the CPU by itself)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {device}: no CUDA device here; pass --device cpu "
                         "to run on the CPU")
    return device
