"""Model zoo registry: name -> PyTorch constructor + default codec.

The port of ``timed_design_tpu/models/registry.py``. All eight TIMED names
build; ProDCoNN, DenseNet and DenseCPD are listed but not ported yet, and
Keras ``.h5`` weights wait for the port of the Keras importer (ROADMAP,
Queue 1).
"""
from __future__ import annotations

import dataclasses
import typing as t
from pathlib import Path

from ..voxel.codec import Codec
from .timed import (
    timed,
    timed_deep,
    timed_rotamer,
    timed_rotamer_deep,
    timed_rotamer_not_so_deep,
)


def _not_ported(name: str) -> t.Callable:
    def build(**_kw):
        raise NotImplementedError(
            f"{name} is not ported to PyTorch yet (ROADMAP, Queue 1: "
            "ProDCoNN/DenseNet/DenseCPD)"
        )

    return build


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    constructor: t.Callable
    n_classes: int
    codec: str  # default input codec string
    rotamer: bool = False

    def build(self, **kw):
        kw.setdefault("in_channels", Codec.from_string(self.codec).n_channels)
        return self.constructor(**kw)


MODEL_REGISTRY: dict[str, ModelSpec] = {
    "TIMED": ModelSpec("TIMED", timed, 20, "CNOCACB"),
    "TIMED_Deep": ModelSpec("TIMED_Deep", timed_deep, 20, "CNOCACB"),
    "TIMED_Charge": ModelSpec("TIMED_Charge", timed, 20, "CNOCACBQ"),
    "TIMED_Polar": ModelSpec("TIMED_Polar", timed, 20, "CNOCACBP"),
    "TIMED_rotamer": ModelSpec("TIMED_rotamer", timed_rotamer, 338, "CNOCACB", True),
    "TIMED_rotamer_balanced": ModelSpec(
        "TIMED_rotamer_balanced", timed_rotamer, 338, "CNOCACB", True
    ),
    "TIMED_rotamer_not_so_deep": ModelSpec(
        "TIMED_rotamer_not_so_deep", timed_rotamer_not_so_deep, 338, "CNOCACB", True
    ),
    "TIMED_rotamer_deep": ModelSpec(
        "TIMED_rotamer_deep", timed_rotamer_deep, 338, "CNOCACB", True
    ),
    "ProDCoNN": ModelSpec("ProDCoNN", _not_ported("ProDCoNN"), 20, "CNOCACB"),
    "DenseNet": ModelSpec("DenseNet", _not_ported("DenseNet"), 20, "CNOCACB"),
    "DenseCPD": ModelSpec("DenseCPD", _not_ported("DenseCPD"), 20, "CNOCACB"),
}


def get_model_spec(name: str) -> ModelSpec:
    for key, spec in MODEL_REGISTRY.items():  # case-insensitive lookup
        if key.lower() == name.lower():
            return spec
    raise KeyError(f"Unknown model {name!r}. Known: {', '.join(MODEL_REGISTRY)}")


def load_model(path_or_name: t.Union[str, Path]) -> ModelSpec:
    """Resolve a registry name. Keras ``.h5``/``.hdf5`` paths raise until
    the Keras importer is ported."""
    if Path(path_or_name).suffix.lower() in (".h5", ".hdf5"):
        raise NotImplementedError(
            f"{path_or_name}: Keras .h5 weights are not supported by the "
            "PyTorch port yet (ROADMAP, Queue 1: models/keras_import.py); "
            "use 'Name@checkpoint.npz'"
        )
    return get_model_spec(str(path_or_name))
