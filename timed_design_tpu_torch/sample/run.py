"""The sampling flow, ``td-sample``: the port of
``timed_design_tpu/sample/run.py``.

Prediction CSV + datasetmap -> temperature on the float64 matrix ->
per-structure probabilities -> every structure sampled in one launch of the
batched kernel -> fasta/json/metrics CSV.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from ..constants import ROTAMER_CATEGORIES
from ..io import extract_sequences, load_datasetmap, load_prediction_matrix, save_sampled
from .sampler import apply_temperature, sample_all_structures


@dataclasses.dataclass
class SampleConfig:
    path_to_pred_matrix: Path
    path_to_datasetmap: Path = Path("datasetmap.txt")
    predict_rotamers: bool = False
    sample_n: int = 100
    save_as: str = "all"  # fasta | json | all
    temperature: float = 1.0
    support_old_datasetmap: bool = False
    seed: int = 42
    device: str | None = None  # None: the CUDA device


def main_sample(cfg: SampleConfig) -> list[str]:
    """Run the sampling pipeline; returns written output paths."""
    pred_path = Path(cfg.path_to_pred_matrix)
    map_path = Path(cfg.path_to_datasetmap)
    if not pred_path.exists():
        raise FileNotFoundError(f"Prediction matrix {pred_path} does not exist")
    if not map_path.exists():
        raise FileNotFoundError(f"Dataset map {map_path} does not exist")

    prediction_matrix = load_prediction_matrix(pred_path, dtype=np.float64)
    dmap = load_datasetmap(map_path, is_old=cfg.support_old_datasetmap)

    # the class count identifies the head: 20 residues or 338 rotamers
    n_classes = prediction_matrix.shape[1]
    if n_classes == 338 and not cfg.predict_rotamers:
        print("338-class matrix detected: enabling rotamer decoding.")
        cfg = dataclasses.replace(cfg, predict_rotamers=True)
    elif n_classes == 20 and cfg.predict_rotamers:
        raise ValueError(
            f"{pred_path} has 20 classes but --predict_rotamers was given — "
            "pass the {model}_rot.csv matrix for rotamer sampling."
        )
    elif n_classes not in (20, 338):
        raise ValueError(
            f"{pred_path} has {n_classes} classes; expected 20 or 338."
        )

    if cfg.temperature != 1:
        prediction_matrix = apply_temperature(prediction_matrix, cfg.temperature)

    decoded = extract_sequences(
        dmap,
        prediction_matrix,
        rotamer_categories=ROTAMER_CATEGORIES if cfg.predict_rotamers else None,
    )
    pdb_codes = list(decoded.pdb_to_probability.keys())
    print(
        f"Sampling {cfg.sample_n} sequences for each of {len(pdb_codes)} "
        f"structures from {pred_path.stem} (T={cfg.temperature}, seed={cfg.seed})."
    )
    pdb_to_sample = sample_all_structures(
        decoded.pdb_to_probability,
        cfg.sample_n,
        seed=cfg.seed,
        rotamer_mode=cfg.predict_rotamers,
        device=cfg.device,
    )
    filename = (
        f"{pred_path.stem}_temp_{cfg.temperature}_n_{cfg.sample_n}_{pdb_codes[0]}"
    )
    return save_sampled(pdb_to_sample, filename=filename, mode=cfg.save_as)
