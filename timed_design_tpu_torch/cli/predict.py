"""Predict sequences on PyTorch (the port of ``td-predict``), from an HDF5
frame dataset or from PDB files:

    python -m timed_design_tpu_torch.cli.predict \\
        --path_to_dataset frames.hdf5 --path_to_model TIMED@ckpt.npz \\
        --path_to_output out/
    python -m timed_design_tpu_torch.cli.predict --voxelize \\
        --path_to_dataset structures/ --path_to_model TIMED.h5 \\
        --path_to_output out/

An ``.hdf5``/``.h5`` dataset (tree or flat layout, as ``td-voxelize``,
``td-convert-dataset`` or aposteriori write it) is read in batches on the
host; PDB file(s) with ``--voxelize`` are parsed and their frames voxelized
on the device batch by batch. A model is a Keras ``.h5`` release file (its
stored graph, ``models/keras_import.py``, named by the file's stem),
``Name@checkpoint.npz``, or a registry name with ``--allow-random-weights``.
Every model runs on each batch, and the run
writes the JAX package's artifacts:
``{model}.csv`` (``{model}_rot.csv`` too with ``--predict_rotamers``),
``{model}.fasta``, the SRB map ``{model}.txt``, ``dataset.fasta``,
``encoded_labels.csv``, the per-residue ``datasetmap.txt``, with
``--is_structure_nmr`` ``{model}_consensus.{fasta,csv,txt}``, and with
``--ensemble`` the same set as ``ensemble``, with ``--report`` the HTML
design report ``{model}_report.html`` (``report.py``), and with
``--output_analysis`` each chain's probability heatmap, mean/variance
histograms and sequence logo. ``--report`` and ``--output_analysis`` draw
with matplotlib: where it is missing they exit with a message that names it
before the models load. ``--voxelize`` writes no HDF5 file.

The flags of ``timed_design_tpu/cli/predict.py`` plus ``--device`` (default
``cuda``; without a card it exits with a message, and runs on the CPU only
with ``--device cpu``). ``--quantize`` runs every convolution in a mode of
``models/quantize.py``.

Under ``torchrun`` (one process per card) every rank joins the world and
each batch is split over all of them (``parallel.make_mesh()``): each rank
runs its rows and gathers the rest, and process index 0 alone writes the
files, the report and the profiler trace:

    torchrun --nproc_per_node 4 -m timed_design_tpu_torch.cli.predict ...
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

import torch

from ..utils import PredictConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Predict sequences with the PyTorch model zoo")
    p.add_argument("--batch_size", type=int, default=512,
                   help="Frames per device step (default: 512)")
    p.add_argument("--path_to_dataset", type=str, required=True,
                   help="An .hdf5 frame dataset, or a PDB file or a directory of "
                        "them with --voxelize")
    p.add_argument("--path_to_datasetmap", type=str, default="datasetmap.txt")
    p.add_argument("--path_to_model", type=str, nargs="+", required=True,
                   help="Model .h5 path(s), Name@checkpoint.npz, or registry name(s): "
                        "TIMED, ProDCoNN, ...")
    p.add_argument("--path_to_blacklist", type=str, default=None,
                   help="Directory of .txt files listing PDB codes to leave out")
    p.add_argument("--path_to_output", type=str, default=".")
    p.add_argument("--predict_rotamers", action="store_true",
                   help="338-rotamer head instead of 20 residues")
    p.add_argument("--is_structure_nmr", action="store_true",
                   help="Build a consensus over NMR states")
    p.add_argument("--start_batch", type=int, default=0,
                   help="Resume from this batch index")
    p.add_argument("--voxelize", action="store_true",
                   help="Input is PDB file(s), voxelized on the device")
    p.add_argument("--codec", type=str, default="CNOCACB")
    p.add_argument("--output_analysis", action="store_true",
                   help="Per-chain graphs (probability heatmap, mean/variance "
                        "histograms, sequence logo); needs matplotlib")
    p.add_argument("--report", action="store_true",
                   help="Also write the HTML design report {model}_report.html "
                        "(named after the last model, or 'ensemble'); needs matplotlib")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="Conv compute dtype (float32 default, for strict CSV parity)")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="Write a torch.profiler trace of the run to DIR "
                        "(chrome trace JSON), and the port's spans beside it "
                        "(td_predict_spans.json)")
    p.add_argument("--ensemble", action="store_true",
                   help="Also average the models' probability matrices and "
                        "emit the full artifact set as 'ensemble' "
                        "(csv/fasta/SRB; needs >=2 models with the same head). "
                        "Every model already runs on the same device batches.")
    p.add_argument("--quantize", type=str, default=None,
                   choices=["int8", "int8-fake", "w8"],
                   help="Run the convolutions quantized (models/quantize.py): int8 = "
                        "int8 codes convolved with int32 sums (a CUDA kernel on the "
                        "card); int8-fake = the same codes, convolved in floating "
                        "point; w8 = weight-only int8")
    p.add_argument("--allow-random-weights", action="store_true",
                   dest="allow_random_weights",
                   help="Permit bare registry names with no weights "
                        "(randomly initialized — benchmarking only). "
                        "Without this flag, a model given as a registry "
                        "name must carry weights via .h5 or Name@ckpt.npz.")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu only when named)")
    return p


def main(argv=None):
    """Run td-predict; returns the engine's PredictionResult (None on a
    rank other than process index 0 under torchrun)."""
    args = build_parser().parse_args(argv)
    dataset_path = Path(args.path_to_dataset)
    is_hdf5 = dataset_path.suffix.lower() in (".hdf5", ".h5")
    if is_hdf5 and args.voxelize:
        raise SystemExit(f"{dataset_path} is an HDF5 frame dataset, read as it is: "
                         "--voxelize takes PDB files")
    if not is_hdf5 and not args.voxelize:
        raise SystemExit("--voxelize is required for PDB input (the frames are voxelized "
                         "on the device), or give an .hdf5 frame dataset")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here; "
                         "pass --device cpu to predict on the CPU")
    from ..analyse.plots import require_pyplot
    from ..parallel.mesh import launched_mesh

    for flag in ("report", "output_analysis"):  # before predicting, not after
        if getattr(args, flag):
            require_pyplot(f"--{flag}")
    with launched_mesh(args.device) as mesh:
        return _predict(args, dataset_path, is_hdf5, mesh)


def _predict(args, dataset_path: Path, is_hdf5: bool, mesh):
    from ..parallel.distributed import process_index

    writer = process_index() == 0
    out = Path(args.path_to_output)
    if writer:
        out.mkdir(parents=True, exist_ok=True)
    cfg = PredictConfig(
        path_to_dataset=dataset_path,
        path_to_model=args.path_to_model,
        path_to_datasetmap=Path(args.path_to_datasetmap),
        path_to_output=out,
        path_to_blacklist=Path(args.path_to_blacklist) if args.path_to_blacklist else None,
        batch_size=args.batch_size,
        start_batch=args.start_batch,
        predict_rotamers=args.predict_rotamers,
        is_structure_nmr=args.is_structure_nmr,
    ).validate()

    from ..engine import load_dataset_and_predict
    from ..utils.timing import chrome_trace, recording
    from ..voxel import make_frame_set

    # --profile: the port's spans too, from the frame set on
    spans = recording() if args.profile and writer else contextlib.nullcontext()
    with spans as rec:
        if is_hdf5:
            dataset = dataset_path
            print(f"Reading frames from {dataset_path}")
        else:
            pdbs = (sorted(dataset_path.glob("**/*.pdb*")) if dataset_path.is_dir()
                    else [dataset_path])
            t0 = time.perf_counter()
            # NMR consensus needs every state as a structure <pdb>_<i>
            dataset = make_frame_set(pdbs, codec=args.codec,
                                     voxelise_all_states=args.is_structure_nmr)
            print(f"Read {len(pdbs)} structure file(s) in {time.perf_counter() - t0:.2f}s; "
                  f"frames are voxelized on {args.device}, batch by batch")

        profile_cm = contextlib.nullcontext()
        if args.profile and writer:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.device(args.device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            profile_cm = profile(activities=acts)
        with profile_cm as prof:
            result = load_dataset_and_predict(
                cfg.path_to_model,
                dataset,
                batch_size=cfg.batch_size,
                start_batch=cfg.start_batch,
                dataset_map_path=cfg.path_to_datasetmap,
                blacklist=cfg.path_to_blacklist,
                predict_rotamers=cfg.predict_rotamers,
                is_consensus=cfg.is_structure_nmr,
                path_to_output=cfg.path_to_output,
                device=args.device,
                compute_dtype=getattr(torch, args.compute_dtype),
                allow_random_weights=args.allow_random_weights,
                ensemble=args.ensemble,
                quantize=args.quantize,
                mesh=mesh,
            )
    if not writer:
        return None
    if args.profile:
        trace = Path(args.profile) / "td_predict_trace.json"
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))
        spans_file = trace.with_name("td_predict_spans.json")
        spans_file.write_text(json.dumps(chrome_trace(rec)))
        print(f"Profiler trace written to {trace}, the port's spans to {spans_file}")
    print(f"Predicted {sum(len(s) for s in result.pdb_to_sequence.values())} residues "
          f"across {len(result.pdb_to_sequence)} chains.")
    for phase, secs in result.timings.items():
        print(f"  {phase}: {secs:.2f}s")
    print(f"  waiting on the loader: {result.loader_wait_s:.2f}s of predict")
    if args.report:
        from ..report import write_design_report

        # the result holds the last model's maps, or the ensemble's
        name = ("ensemble" if args.ensemble
                else Path(str(args.path_to_model[-1])).stem.split("@")[0])
        path = write_design_report(
            result.pdb_to_sequence, result.pdb_to_real_sequence, result.pdb_to_probability,
            out, model_name=name, pdb_to_consensus=result.pdb_to_consensus)
        print(f"Design report written to {path}")
    if args.output_analysis:
        write_analysis_graphs(result.pdb_to_probability, out)
    return result


def write_analysis_graphs(pdb_to_probability: dict, out: Path) -> None:
    """Per chain: its probability heatmap (rotamer probabilities summed to
    the 20 amino acids first), mean/variance histograms and sequence logo."""
    import numpy as np

    from ..analyse import create_sequence_logo, plot_mean_var_probs, plot_sequence_heatmap
    from ..analyse.plots import pyplot
    from ..constants import compress_rotamer_probs

    plt = pyplot("--output_analysis")
    for pdb, probs in pdb_to_probability.items():
        probs = np.asarray(probs)
        heat = compress_rotamer_probs(probs) if probs.shape[1] == 338 else probs
        plot_sequence_heatmap(heat, f"{pdb} probabilities", out)
        plot_mean_var_probs(probs, f"{pdb}", out)
        fig = create_sequence_logo(probs)
        fig.savefig(out / f"{pdb}_logo.png")
        plt.close(fig)  # one live figure per chain otherwise
    print(f"Analysis graphs written to {out}")


if __name__ == "__main__":
    main()
