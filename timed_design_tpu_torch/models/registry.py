"""Model zoo registry: name -> PyTorch constructor, default codec and the
converter of its Flax weights.

The port of ``timed_design_tpu/models/registry.py``: every name builds,
and ``load_model`` resolves a Keras ``.h5`` release file to the graph it
stores (``models/keras_import.py``).
"""
from __future__ import annotations

import dataclasses
import typing as t
from pathlib import Path

import torch

from ..voxel.codec import Codec
from .convert import (
    densenet_variables_to_state_dict,
    flax_variables_to_state_dict,
    prodconn_variables_to_state_dict,
)
from .densenet import densecpd, densenet
from .prodconn import prodconn
from .timed import (
    timed,
    timed_deep,
    timed_rotamer,
    timed_rotamer_deep,
    timed_rotamer_not_so_deep,
)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    constructor: t.Callable
    n_classes: int
    codec: str  # default input codec string
    rotamer: bool = False
    # Flax variables {"params", "batch_stats"} -> the module's state_dict
    convert: t.Callable = flax_variables_to_state_dict

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
    "ProDCoNN": ModelSpec("ProDCoNN", prodconn, 20, "CNOCACB",
                          convert=prodconn_variables_to_state_dict),
    "DenseNet": ModelSpec("DenseNet", densenet, 20, "CNOCACB",
                          convert=densenet_variables_to_state_dict),
    "DenseCPD": ModelSpec("DenseCPD", densecpd, 20, "CNOCACB",
                          convert=densenet_variables_to_state_dict),
}


def get_model_spec(name: str) -> ModelSpec:
    for key, spec in MODEL_REGISTRY.items():  # case-insensitive lookup
        if key.lower() == name.lower():
            return spec
    raise KeyError(f"Unknown model {name!r}. Known: {', '.join(MODEL_REGISTRY)}")


def load_model(path_or_name: t.Union[str, Path], compute_dtype=None):
    """Resolve a model: a ``.h5``/``.hdf5`` path -> the imported Keras graph
    (``KerasH5Model``, float32 unless ``compute_dtype`` says otherwise); a
    name -> its ``ModelSpec``. A Keras path that does not exist raises
    ``FileNotFoundError``, not the registry's 'Unknown model' ``KeyError``."""
    p = Path(path_or_name)
    if p.suffix.lower() in (".h5", ".hdf5"):
        if not p.exists():
            raise FileNotFoundError(f"model weights file not found: {p}")
        from .keras_import import load_keras_model

        return load_keras_model(p, compute_dtype=compute_dtype or torch.float32)
    return get_model_spec(str(path_or_name))
