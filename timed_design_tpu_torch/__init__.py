"""timed_design_tpu_torch — the PyTorch/CUDA port of timed_design_tpu.

The same system as the JAX package beside it, on PyTorch, with the TPU's
Pallas kernels rewritten by hand for NVIDIA Hopper. It imports ``torch`` and
never JAX, and nothing of the JAX package: what it needs from there it keeps
as its own copy, under the same module name. Its entry points run on the
CUDA device unless the caller asks for the CPU.

Layering (bottom-up), ported so far:
  constants -> amino-acid tables, the rotamer codec, BLOSUM62
  structure -> PDB parsing (native C++ scanner in csrc/pdbscan.cpp),
             chi angles, rotamer tags, superposition
  voxel   -> codecs, residue frames (host numpy), the voxelizer
  ops     -> the voxelizer's matrix products; the CUDA sampling kernel
             (csrc/sample_inverse_cdf.cu) with its build and its plain version
  models  -> TIMED 3D-CNN zoo, registry, Flax-weight conversion
  engine  -> batched prediction, DesignSession, request coalescing
  parallel -> the (data, model) mesh over torch.distributed, one process
             per card (NCCL on the card, gloo on the CPU); scale-out helpers
  train   -> fit, evaluate, the steps, npz checkpoints; data- and
             tensor-parallel over a mesh
  sample  -> temperature, Monte-Carlo sampling, sequence metrics
  io      -> datasetmaps, decoding, writers (native %.18e formatter in
             csrc/fmt_csv.cpp), the RCSB fetcher
  analyse -> recovery and rotamer metrics (on the device), structure
             analyses, SCWRL4/AlphaFold2/NetSolP adapters, plots, sweeps
  cli     -> td-serve, td-sample, td-predict, td-analyse-rotamers, td-train,
             ... (python -m timed_design_tpu_torch.cli.<name>; td-predict
             and td-train over every rank under torchrun)
  ui      -> the Streamlit design app
             (streamlit run timed_design_tpu_torch/ui.py)
"""

__version__ = "0.1.0"
