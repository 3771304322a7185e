"""Voxel layer: codecs, residue frames (host numpy) and the voxelizer."""
from .codec import Codec  # noqa: F401
from .frames import FrameAtoms, frame_bases, structure_to_frame_atoms  # noqa: F401
from .voxelize import voxelize_frame_atoms  # noqa: F401
