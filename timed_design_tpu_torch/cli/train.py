"""``td-train`` on PyTorch: train a zoo model on an HDF5 frame dataset (the
port of ``timed_design_tpu/cli/train.py``).

    python -m timed_design_tpu_torch.cli.train --path_to_dataset frames.hdf5 \\
        --model TIMED --batch_size 256 --epochs 10 --bf16 --output ckpt.npz

The dataset (tree or flat layout) is read by ``io/h5frames.py::
FrameBatchLoader``, shuffled every epoch from ``--seed``, and fed to
``train/train.py::fit``; ``--val_fraction`` holds whole structures out. The
checkpoint is the JAX package's npz: ``MODEL@ckpt.npz`` loads in either
package's ``td-predict``. A Keras ``.h5`` ``--init_from`` (the TIMED
family) warm-starts from a release file (``models/keras_import.py::
import_timed_params``); a ``.h5`` ``--output`` writes one
(``models/keras_export.py``), for the TIMED family only: another model is
refused before training. The JAX CLI's flags plus ``--device`` (default
``cuda``; without a card it exits with a message, and runs on the CPU only
with ``--device cpu``).

Under ``torchrun`` (one process per card) every rank joins the world and
trains data-parallel over all of them (``parallel.make_mesh()``), every
rank reading the same shuffled batches and stepping on its rows; process
index 0 alone writes the checkpoint:

    torchrun --nproc_per_node 4 -m timed_design_tpu_torch.cli.train ...
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch

KERAS_SUFFIXES = (".h5", ".hdf5")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a model on an HDF5 frame dataset")
    p.add_argument("--path_to_dataset", type=str, required=True)
    p.add_argument("--model", type=str, default="TIMED",
                   help="Registry name: TIMED, TIMED_Deep, ProDCoNN, DenseNet, ...")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_shuffle", action="store_true",
                   help="Disable the per-epoch global shuffle of residues")
    p.add_argument("--bn_momentum", type=float, default=0.99,
                   help="BatchNorm running-stat momentum (Keras default 0.99; ~0.9 "
                        "for short runs, so that evaluation-mode statistics converge)")
    p.add_argument("--output", type=str, default="checkpoint.npz")
    p.add_argument("--init_from", type=str, default=None,
                   help="Warm-start weights: a td-train checkpoint .npz, or a Keras "
                        "release .h5 (TIMED family)")
    p.add_argument("--val_fraction", type=float, default=0.0,
                   help="Fraction of STRUCTURES (not residues) held out for "
                        "validation; evaluation-mode metrics print per epoch")
    p.add_argument("--patience", type=int, default=None,
                   help="Stop after this many epochs without val_loss improvement "
                        "and restore the best epoch's weights (needs --val_fraction > 0)")
    p.add_argument("--min_delta", type=float, default=0.0,
                   help="Minimum val_loss improvement that resets patience")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 mixed precision: convolutions in bf16, parameters, "
                        "BatchNorm, softmax and gradients in float32")
    p.add_argument("--class_weight", choices=("none", "balanced"), default="none",
                   help="'balanced': inverse-frequency weighted cross-entropy from the "
                        "train split's labels (20-class heads only)")
    p.add_argument("--lr_schedule", choices=("constant", "cosine"), default="constant")
    p.add_argument("--filters", type=str, default=None,
                   help="Override the conv-stack widths as comma ints, e.g. '8,16' "
                        "(TIMED family)")
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="Linear LR warmup steps before the schedule proper")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu only when named)")
    return p


def _build(spec, args, build_kw: dict):
    """The module, with ``--bn_momentum`` where the architecture takes it."""
    try:
        return spec.build(bn_momentum=args.bn_momentum, **build_kw)
    except TypeError as e:
        # constructors that fix their widths (timed_deep & co pass filters
        # themselves) reject the override with "multiple values"
        if "filters" in str(e) and "multiple values" in str(e):
            raise SystemExit(f"{args.model} fixes its own conv widths and does not "
                             "accept --filters; use TIMED/ProDCoNN-family bases that "
                             "take a filters knob")
        if "bn_momentum" not in str(e):
            raise
    print(f"note: {args.model} has no bn_momentum knob; --bn_momentum ignored")
    try:
        return spec.build(**build_kw)
    except TypeError as e:
        if "filters" in str(e) and ("multiple values" in str(e) or "unexpected" in str(e)):
            raise SystemExit(f"{args.model} fixes its own conv widths and does not "
                             "accept --filters")
        raise


def main(argv=None):
    """Run td-train; returns the final ``TrainState``."""
    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here; "
                         "pass --device cpu to train on the CPU")
    if args.patience is not None and args.val_fraction <= 0:
        raise SystemExit("--patience requires --val_fraction > 0")
    from ..parallel.mesh import launched_mesh

    with launched_mesh(args.device) as mesh:
        return _train(args, mesh)


def _train(args, mesh):
    out = Path(args.output)
    from ..io import (
        FrameBatchLoader,
        FrameDatasetMetadata,
        create_flat_dataset_map,
        split_dataset_map,
    )
    from ..models import TIMED, export_timed_to_h5, get_model_spec
    from ..parallel.distributed import process_index
    from ..train import balanced_class_weights, fit, load_checkpoint_params, save_checkpoint
    from ..train.train import flax_variables

    dataset = Path(args.path_to_dataset)
    spec = get_model_spec(args.model)
    meta = FrameDatasetMetadata.from_file(dataset)
    dmap, _ = create_flat_dataset_map(dataset)
    val_loader = None
    if args.val_fraction > 0:
        train_map, val_map = split_dataset_map(dmap, args.val_fraction, seed=args.seed)
        print(f"validation split: {len(val_map.entries)} residues held out "
              f"({len(train_map.entries)} train) at the structure level")
        if not val_map.entries:
            raise SystemExit(f"--val_fraction {args.val_fraction} holds out 0 structures of "
                             "this dataset — raise it (or drop it to train without validation)")
        val_loader = FrameBatchLoader(dataset, val_map, batch_size=args.batch_size,
                                      device=args.device)
        dmap = train_map
    loader = FrameBatchLoader(dataset, dmap, batch_size=args.batch_size,
                              shuffle=not args.no_shuffle, shuffle_seed=args.seed,
                              device=args.device)
    class_weights = None
    if args.class_weight == "balanced":
        if spec.n_classes != 20:
            raise SystemExit("--class_weight balanced needs 20-class residue labels; "
                             f"{args.model} has a {spec.n_classes}-class head")
        from ..constants import AA3_TO_INT

        labels = [AA3_TO_INT[e[3]] for e in dmap.entries if e[3] in AA3_TO_INT]
        skipped = len(dmap.entries) - len(labels)
        if skipped:
            print(f"class weights: skipped {skipped} residues with nonstandard labels")
        if not labels:
            raise SystemExit("--class_weight balanced: no standard-residue labels in the "
                             "training split")
        class_weights = balanced_class_weights(labels, spec.n_classes)
        lo, hi = float(class_weights[class_weights > 0].min()), float(class_weights.max())
        print(f"balanced class weights from {len(labels)} train labels "
              f"(min {lo:.3f} / max {hi:.3f})")
    init_weights = None
    if args.init_from:
        src = Path(args.init_from)
        if src.suffix.lower() in KERAS_SUFFIXES:
            from ..models import import_timed_params

            init_weights = import_timed_params(src)
            print(f"warm start: imported Keras release weights from {src}")
        else:
            init_weights = load_checkpoint_params(src)
            print(f"warm start: loaded checkpoint weights from {src}")
    build_kw: dict = {}
    if args.bf16:
        build_kw["compute_dtype"] = torch.bfloat16
    if args.filters:
        try:
            build_kw["filters"] = tuple(int(w) for w in args.filters.split(",") if w.strip())
        except ValueError:
            raise SystemExit(f"--filters must be comma ints, got {args.filters!r}")
        if not build_kw["filters"]:
            raise SystemExit("--filters parsed to an empty stack")
        if any(w <= 0 for w in build_kw["filters"]):
            raise SystemExit(f"--filters widths must be positive, got {args.filters!r}")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)  # the initial weights, from --seed as in the JAX CLI
        module = _build(spec, args, build_kw)
    export_h5 = out.suffix.lower() in KERAS_SUFFIXES
    if export_h5 and not isinstance(module, TIMED):  # before training, not after
        raise SystemExit(f"--output {out.name}: Keras .h5 export covers the linear TIMED "
                         f"family only; {args.model} has a different parameter tree — use "
                         "a .npz output and MODEL@ckpt.npz in predict")
    state = fit(
        module,
        loader,
        n_classes=spec.n_classes,
        input_channels=meta.frame_dims[-1],
        learning_rate=args.learning_rate,
        epochs=args.epochs,
        seed=args.seed,
        val_loader=val_loader,
        patience=args.patience,
        min_delta=args.min_delta,
        lr_schedule=args.lr_schedule,
        warmup_steps=args.warmup_steps,
        init_weights=init_weights,
        class_weights=class_weights,
        device=args.device,
        mesh=mesh,
    )
    writer = process_index() == 0
    if export_h5:
        # the release format: loads in the JAX package, TF's Keras and the port
        variables = flax_variables(state.module)
        if not writer:
            return state
        export_timed_to_h5(variables["params"], variables["batch_stats"], out,
                           n_classes=spec.n_classes, input_channels=meta.frame_dims[-1])
        print(f"Exported Keras release-format h5 to {out} after {int(state.step)} steps")
        return state
    # architecture overrides (not runtime knobs like compute_dtype), so that
    # Name@ckpt.npz rebuilds the trained module
    arch_kw = {k: v for k, v in build_kw.items() if k != "compute_dtype"}
    save_checkpoint(state, out, build_kwargs=arch_kw or None)
    if writer:
        print(f"Saved checkpoint to {out} after {int(state.step)} steps")
    return state


if __name__ == "__main__":
    main()
