"""Kernel layer: the voxelizer's matrix products and the sampling kernel."""
from .matmul_voxelize import voxelize_matmul  # noqa: F401
