"""``td-convert-dataset`` on PyTorch: an aposteriori tree-layout HDF5 frame
dataset -> the flat layout (the port of ``timed_design_tpu/cli/
convert_dataset.py``), on the host, through the port's own HDF5 reader and
writer.

    python -m timed_design_tpu_torch.cli.convert_dataset dataset.hdf5 \\
        [flat.hdf5] [--frame-dtype bfloat16]
"""
from __future__ import annotations

import argparse
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Convert an aposteriori-schema HDF5 frame dataset to the flat "
                    "fast layout (contiguous /frames; the file attributes kept)")
    p.add_argument("src", type=str, help="tree-layout .hdf5 dataset")
    p.add_argument("dst", type=str, nargs="?", default=None,
                   help="output path (default: <src>_flat.hdf5)")
    p.add_argument("--chunk-rows", type=int, default=512,
                   help="kept for compatibility; the flat output is written "
                        "contiguous (memory-mapped by the loader)")
    p.add_argument("--frame-dtype", type=str, default="float32",
                   choices=("float32", "bfloat16"),
                   help="bfloat16 halves the file and every byte after it; equal "
                        "to the engine's bf16 cast")
    return p


def main(argv=None) -> Path:
    args = build_parser().parse_args(argv)
    src = Path(args.src)
    dst = Path(args.dst) if args.dst else src.with_name(src.stem + "_flat.hdf5")
    from ..io import convert_to_flat

    out = convert_to_flat(src, dst, chunk_rows=args.chunk_rows, frame_dtype=args.frame_dtype)
    print(f"Wrote {out}")
    return out


if __name__ == "__main__":
    main()
