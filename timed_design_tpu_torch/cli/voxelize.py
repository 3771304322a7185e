"""``td-voxelize`` on PyTorch: PDB files -> an HDF5 frame dataset, voxelized
on the device (the port of ``timed_design_tpu/cli/voxelize.py``).

    python -m timed_design_tpu_torch.cli.voxelize structures/ -e .pdb1.gz \\
        -n dataset -o out/ [--layout flat --frame-dtype bfloat16]

Writes ``{output}/{name}.hdf5``: the aposteriori schema (``--layout tree``,
gzipped frames) or the flat layout (``voxel/dataset.py::
make_frame_dataset``), through the port's own HDF5 writer. The JAX CLI's
flags plus ``--device`` (default ``cuda``; without a card it exits with a
message, and runs on the CPU only with ``--device cpu``). It prints the time
of each phase: parse, voxelize (the device's work and the copy to the
host), write (gzip and the file).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from ..utils import PhaseTimer, VoxelizeConfig


def _strict_bool(flag: str, value: str) -> bool:
    """aposteriori's 'True'/'False' flag values, strictly: a typo must not
    flip the encoding every downstream model depends on."""
    v = value.strip().lower()
    if v in ("true", "1", "yes"):
        return True
    if v in ("false", "0", "no"):
        return False
    raise SystemExit(f"{flag}: expected True/False, got {value!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Voxelize PDB structures into an HDF5 frame dataset")
    p.add_argument("structures", type=str, help="PDB file or directory")
    p.add_argument("-e", "--extension", type=str, default=".pdb",
                   help="PDB file extension when a directory is given")
    p.add_argument("-n", "--name", type=str, default="dataset")
    p.add_argument("-o", "--output", type=str, default=".")
    p.add_argument("--voxels-per-side", type=int, default=21)
    p.add_argument("--frame-edge-length", type=float, default=21.0)
    p.add_argument("-ae", "--atom-encoder", type=str, default="CNOCACB")
    p.add_argument("-g", "--voxels-as-gaussian", type=str, default="True")
    p.add_argument("-cb", "--encode-cb", type=str, default="True")
    p.add_argument("--voxelise_all_states", action="store_true",
                   help="Keep every NMR state (consensus flow)")
    p.add_argument("--layout", type=str, default="tree", choices=["tree", "flat"],
                   help="'tree' = aposteriori-schema groups (interoperable); "
                        "'flat' = row-chunked fast layout")
    p.add_argument("--frame-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="flat layout only: bfloat16 halves the file and every byte "
                        "after it; equal to the engine's bf16 cast")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu only when named)")
    return p


def main(argv=None) -> tuple[Path, dict[str, float]]:
    """Run td-voxelize; returns the file written and the phases' seconds."""
    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here; "
                         "pass --device cpu to voxelize on the CPU")
    src = Path(args.structures)
    paths = sorted(src.glob(f"**/*{args.extension}")) if src.is_dir() else [src]
    if not paths:
        raise SystemExit(f"No structures matching *{args.extension} under {src}")
    cfg = VoxelizeConfig(
        structure_paths=paths,
        output_path=Path(args.output) / f"{args.name}.hdf5",
        codec=args.atom_encoder,
        voxels_per_side=args.voxels_per_side,
        frame_edge_length=args.frame_edge_length,
        gaussian=_strict_bool("--voxels-as-gaussian", args.voxels_as_gaussian),
        encode_cb=_strict_bool("--encode-cb", args.encode_cb),
        voxelise_all_states=args.voxelise_all_states,
    )
    from ..voxel import make_frame_dataset

    timer = PhaseTimer()
    t0 = time.perf_counter()
    out = make_frame_dataset(
        cfg.structure_paths,
        cfg.output_path,
        codec=cfg.codec,
        voxels_per_side=cfg.voxels_per_side,
        frame_edge_length=cfg.frame_edge_length,
        gaussian=cfg.gaussian,
        encode_cb=cfg.encode_cb,
        voxelise_all_states=cfg.voxelise_all_states,
        layout=args.layout,
        frame_dtype=args.frame_dtype,
        device=args.device,
        timer=timer,
    )
    print(f"Wrote {out} from {len(paths)} structure(s) in {time.perf_counter() - t0:.2f}s")
    for phase, secs in timer.summary().items():
        print(f"  {phase}: {secs:.3f}s")
    return out, timer.summary()


if __name__ == "__main__":
    main()
