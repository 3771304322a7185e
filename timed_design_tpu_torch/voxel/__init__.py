"""Voxel layer: codecs, residue frames (host numpy), the voxelizer, the HDF5
frame dataset writer of ``td-voxelize`` and the in-memory frame sets of
``td-predict --voxelize``.

The codec and the frames import no torch; the voxelizer and the frame sets
are imported at first use, so that the frame-set workers
(``frame_pool.py``) start without torch."""
import importlib
import sys
import types

from .codec import Codec  # noqa: F401
from .frames import CB_FRAME_OFFSET, FrameAtoms, frame_bases, structure_to_frame_atoms  # noqa: F401

_AT_FIRST_USE = {
    "voxelize_frame_atoms": "voxelize",
    "FrameBatchSource": "dataset",
    "FrameSet": "dataset",
    "create_flat_dataset_map": "dataset",
    "make_frame_dataset": "dataset",
    "make_frame_set": "dataset",
    "voxelize_structure": "dataset",
}


def __getattr__(name: str):
    if name in _AT_FIRST_USE:
        return getattr(importlib.import_module(f".{_AT_FIRST_USE[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def voxelize(*args, **kwargs):
    """``voxelize.voxelize``, the voxelizer's module imported at the first call."""
    from .voxelize import voxelize as voxelize_

    return voxelize_(*args, **kwargs)


class _Package(types.ModuleType):
    def __setattr__(self, name: str, value) -> None:
        # the import of the module ``voxelize`` names it on the package: the
        # name stays the function's, as in the JAX package
        if not (name == "voxelize" and isinstance(value, types.ModuleType)):
            super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Package
