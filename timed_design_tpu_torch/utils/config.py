"""Typed configuration of ``td-predict``: the port's copy of
``PredictConfig`` from ``timed_design_tpu/utils/config.py``. The CLI builds
it from its flags; ``validate`` checks the paths and the batch size."""
from __future__ import annotations

import dataclasses
from pathlib import Path


@dataclasses.dataclass
class PredictConfig:
    path_to_dataset: Path
    path_to_model: list[str]  # registry names or Name@checkpoint.npz
    path_to_datasetmap: Path = Path("datasetmap.txt")
    path_to_output: Path = Path(".")
    path_to_blacklist: Path | None = None
    batch_size: int = 512
    start_batch: int = 0
    predict_rotamers: bool = False
    is_structure_nmr: bool = False

    def validate(self) -> "PredictConfig":
        if not Path(self.path_to_dataset).exists():
            raise FileNotFoundError(f"Dataset {self.path_to_dataset} does not exist")
        if self.path_to_blacklist and not Path(self.path_to_blacklist).exists():
            raise FileNotFoundError(f"Blacklist {self.path_to_blacklist} does not exist")
        if self.batch_size <= 0:
            raise ValueError(f"Batch size must be > 0, got {self.batch_size}")
        return self
