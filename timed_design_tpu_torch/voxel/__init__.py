"""Voxel layer: codecs, residue frames (host numpy), the voxelizer, the HDF5
frame dataset writer of ``td-voxelize`` and the in-memory frame sets of
``td-predict --voxelize``."""
from .codec import Codec  # noqa: F401
from .frames import CB_FRAME_OFFSET, FrameAtoms, frame_bases, structure_to_frame_atoms  # noqa: F401
from .voxelize import voxelize, voxelize_frame_atoms  # noqa: F401
from .dataset import (  # noqa: F401
    FrameBatchSource,
    FrameSet,
    create_flat_dataset_map,
    make_frame_dataset,
    make_frame_set,
    voxelize_structure,
)
