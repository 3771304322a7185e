"""Typed configuration of ``td-predict`` and ``td-voxelize``: the port's
copies of ``PredictConfig`` and ``VoxelizeConfig`` from
``timed_design_tpu/utils/config.py``. The CLIs build them from their flags;
``PredictConfig.validate`` checks the paths and the batch size."""
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


@dataclasses.dataclass
class VoxelizeConfig:
    structure_paths: list[Path]
    output_path: Path = Path("dataset.hdf5")
    codec: str = "CNOCACB"
    voxels_per_side: int = 21
    frame_edge_length: float = 21.0
    gaussian: bool = True
    encode_cb: bool = True
    voxelise_all_states: bool = False
