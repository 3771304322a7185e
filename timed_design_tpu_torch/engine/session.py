"""DesignSession: one model loaded once, designing structure after structure.

The port of ``timed_design_tpu/engine/session.py``: the model, its weights
and the voxelizer live on one device (or each rank of a mesh voxelizes the
structure and predicts its rows); bfloat16 is the default compute dtype.
"""
from __future__ import annotations

import time
import typing as t
from pathlib import Path

import numpy as np
import torch

from ..constants import AA1, compress_rotamer_probs
from ..models import MODEL_REGISTRY
from ..structure import Structure, load_pdb
from ..voxel import Codec, structure_to_frame_atoms, voxelize_frame_atoms
from .predictor import Predictor, _resolve_model


class DesignSession:
    def __init__(
        self,
        model: t.Union[str, Path, torch.nn.Module],
        codec: t.Union[str, Codec, None] = None,
        batch_size: int = 512,
        device: torch.device | str | None = None,
        gaussian: bool = True,
        compute_dtype: t.Union[str, torch.dtype] = "bfloat16",
        allow_random_weights: bool = False,
        quantize: str | None = None,
        mesh=None,
        predictor_cls: t.Callable[..., Predictor] = Predictor,
    ):
        """``quantize``: None, or the mode of ``models/quantize.py`` that
        every forward runs in ('int8', 'int8-fake', 'w8'). ``mesh``
        (``parallel.make_mesh``): the predictor runs each rank's rows of
        every batch over its data axis (``Predictor``). ``predictor_cls``
        builds the predictor from the Predictor's arguments (the rank-0
        front end's, ``parallel/frontend.py``, sends the other ranks their
        rows)."""
        if isinstance(compute_dtype, str):
            compute_dtype = getattr(torch, compute_dtype)
        resolved, self.model_name = _resolve_model(
            model, compute_dtype=compute_dtype,
            allow_random_weights=allow_random_weights,
        )
        if codec is None:
            spec = MODEL_REGISTRY.get(self.model_name)
            codec = spec.codec if spec else "CNOCACB"
        self.codec = Codec.from_string(codec) if isinstance(codec, str) else codec
        self.gaussian = gaussian
        self.predictor = predictor_cls(resolved, batch_size=batch_size, device=device,
                                       quantize=quantize, mesh=mesh)
        self.last_timings: dict[str, float] = {}

    @property
    def n_classes(self) -> int:
        return self.predictor.n_classes

    @property
    def device(self) -> torch.device:
        return self.predictor.device

    def voxelize(self, structure: Structure):
        """Structure -> (device frames (R, 21, 21, 21, C) float32, FrameAtoms)."""
        fa = structure_to_frame_atoms(structure, self.codec)
        frames = voxelize_frame_atoms(
            fa, self.codec, gaussian=self.gaussian, device=self.device
        )
        return frames, fa

    def design(self, structure: t.Union[Structure, Path, str]):
        """PDB/Structure -> (probs (R, n_classes), FrameAtoms). Wall times
        of voxelisation and prediction land in ``self.last_timings``."""
        if not isinstance(structure, Structure):
            structure = load_pdb(Path(structure))
        t0 = time.perf_counter()
        frames, fa = self.voxelize(structure)
        t1 = time.perf_counter()
        probs = self.predictor.predict_probs(frames)
        self.last_timings = {
            "voxelisation": t1 - t0,
            "prediction": time.perf_counter() - t1,
        }
        return probs, fa

    def design_sequence(self, structure) -> str:
        """Argmax design: PDB/Structure -> one-letter sequence."""
        probs, _ = self.design(structure)
        if probs.shape[1] == 338:
            probs = compress_rotamer_probs(probs)
        return "".join(np.array(list(AA1))[probs.argmax(1)])
