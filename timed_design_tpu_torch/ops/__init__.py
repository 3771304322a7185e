"""Kernel layer: the voxelizer's matrix products and the sampling kernel."""
