"""Benchmark orchestration: model sweeps, temperature sweeps and their
plots; the port of ``timed_design_tpu/analyse/sweeps.py``.

Plain functions over the port's engine and sampler: every model over one
frame dataset or set of PDB files (``load_dataset_and_predict``), ``td-sample`` at each
temperature (``main_sample``, one batched kernel launch per temperature),
and box and line plots of the results (matplotlib, imported when a plot is
drawn).
"""
from __future__ import annotations

import dataclasses
import typing as t
from pathlib import Path

import numpy as np
import torch

DEFAULT_TEMPERATURES = (0.1, 0.5, 1.0, 2.0, 5.0)


def run_model_benchmark(
    models: t.Sequence[str],
    dataset_path: Path,
    output_root: Path,
    batch_size: int = 512,
    predict_rotamers: bool = False,
    allow_random_weights: bool = False,
    device: torch.device | str | None = None,
    mesh=None,
) -> dict[str, dict] | None:
    """Run every model over one dataset; per-model output dirs and metrics.

    ``dataset_path``: an HDF5 frame dataset (``.hdf5``/``.h5``, tree or flat
    layout), passed on to ``load_dataset_and_predict`` as the JAX function
    passes it; or a PDB file or a directory of them, made into one frame
    set (``td-predict --voxelize``'s input). Every model predicts on
    ``device`` (default: the CUDA device), over ``mesh``'s data axis when
    one is given (``parallel.make_mesh``). Returns {model_name:
    sequence-recovery metrics dict}; over a mesh, on process index 0 only
    (None elsewhere).
    """
    from ..engine import load_dataset_and_predict
    from ..parallel.distributed import process_index
    from ..voxel import make_frame_set
    from .metrics import calculate_metrics

    dataset = Path(dataset_path)
    if dataset.suffix.lower() not in (".hdf5", ".h5"):
        pdbs = sorted(dataset.glob("**/*.pdb*")) if dataset.is_dir() else [dataset]
        dataset = make_frame_set(pdbs)
    results = {}
    for model in models:
        # a weights path becomes its stem: an absolute path joined onto
        # output_root would replace output_root
        tag = Path(str(model)).stem if str(model).endswith(
            (".h5", ".hdf5")) else str(model)
        out = Path(output_root) / tag
        if process_index() == 0:
            out.mkdir(parents=True, exist_ok=True)
        res = load_dataset_and_predict(
            [model], dataset, batch_size=batch_size,
            path_to_output=out, predict_rotamers=predict_rotamers,
            dataset_map_path=out / "datasetmap.txt",
            allow_random_weights=allow_random_weights, device=device, mesh=mesh,
        )
        if res is None:  # a rank other than process index 0 of a mesh
            continue
        # probabilities give TRUE top-k (20-class heads only; rotamer
        # probabilities are 338-wide and keep the reference's one-hot form)
        probs = None if predict_rotamers else res.pdb_to_probability
        m = calculate_metrics(
            res.pdb_to_sequence, res.pdb_to_real_sequence, probs, device=device
        )
        results[str(model)] = {
            "accuracy_1": m["accuracy_1"],
            "accuracy_3": m["accuracy_3"],
            "precision": m["precision"],
            "recall": m["recall"],
            "timings": res.timings,
        }
    return results if process_index() == 0 else None


def run_temperature_sweep(
    pred_matrix_path: Path,
    datasetmap_path: Path,
    sample_n: int = 200,
    temperatures: t.Sequence[float] = DEFAULT_TEMPERATURES,
    seed: int = 42,
    predict_rotamers: bool = False,
    save_as: str = "all",
    device: torch.device | str | None = None,
) -> dict[float, list[str]]:
    """``td-sample`` at each temperature: {temperature: [output paths]}.
    Each temperature samples every structure in one launch of the batched
    kernel on ``device`` (default: the CUDA device)."""
    from ..sample import SampleConfig, main_sample

    out: dict[float, list[str]] = {}
    for temp in temperatures:
        out[temp] = main_sample(
            SampleConfig(
                path_to_pred_matrix=Path(pred_matrix_path),
                path_to_datasetmap=Path(datasetmap_path),
                predict_rotamers=predict_rotamers,
                sample_n=sample_n,
                temperature=temp,
                seed=seed,
                save_as=save_as,
                device=device,
            )
        )
    return out


@dataclasses.dataclass
class SweepPoint:
    temperature: float
    values: np.ndarray  # per-design metric values at this temperature


def plot_metric_vs_temperature(
    points: t.Sequence[SweepPoint],
    metric_name: str,
    output_path: Path,
    title: str = "",
):
    """Box/strip plot of a per-design metric across temperatures."""
    from .plots import pyplot

    plt = pyplot("plot_metric_vs_temperature")

    points = sorted(points, key=lambda p: p.temperature)
    fig, ax = plt.subplots(figsize=(8, 5))
    data = [np.asarray(p.values)[~np.isnan(np.asarray(p.values, float))] for p in points]
    ax.boxplot(data, tick_labels=[str(p.temperature) for p in points])
    for i, vals in enumerate(data):
        x = np.full(len(vals), i + 1) + np.random.default_rng(0).uniform(
            -0.08, 0.08, len(vals)
        )
        ax.plot(x, vals, ".", alpha=0.3, markersize=3)
    ax.set_xlabel("Sampling temperature")
    ax.set_ylabel(metric_name)
    ax.set_title(title or f"{metric_name} vs temperature")
    fig.tight_layout()
    out = Path(output_path) / f"{metric_name.replace(' ', '_')}_vs_temperature.png"
    fig.savefig(out)
    plt.close(fig)
    return out


def plot_models_comparison(
    model_to_points: dict[str, t.Sequence[SweepPoint]],
    metric_name: str,
    output_path: Path,
):
    """Mean metric against temperature, one line per model."""
    from .plots import pyplot

    plt = pyplot("plot_models_comparison")

    fig, ax = plt.subplots(figsize=(8, 5))
    for model, points in model_to_points.items():
        points = sorted(points, key=lambda p: p.temperature)
        xs = [p.temperature for p in points]
        ys = [float(np.nanmean(np.asarray(p.values, float))) for p in points]
        ax.plot(xs, ys, marker="o", label=model)
    ax.set_xlabel("Sampling temperature")
    ax.set_ylabel(metric_name)
    ax.set_xscale("log")
    ax.legend()
    fig.tight_layout()
    out = Path(output_path) / f"models_{metric_name.replace(' ', '_')}_vs_temp.png"
    fig.savefig(out)
    plt.close(fig)
    return out


def plot_scwrl_scores(
    analysis_dirs: t.Mapping[str, Path],
    output_path: Path,
    filename: str = "scwrl_scores_comparison.png",
) -> Path:
    """Compare SCWRL energy-score distributions across models: reads each
    analysis dir's ``scwrl_scores.csv`` (written by
    ``cli/analyse_rotamers.py``), draws one box per model plus the shared
    wild-type repack scores, and raises unless the PDB sets line up across
    models.
    """
    import csv

    from .plots import pyplot

    plt = pyplot("plot_scwrl_scores")

    labels, series = [], []
    real_scores: list[float] = []
    ref_pdbs: list[str] | None = None
    for model, d in analysis_dirs.items():
        rows = list(csv.DictReader(open(Path(d) / "scwrl_scores.csv")))
        pdbs = [r["pdb"] for r in rows]
        if ref_pdbs is None:
            ref_pdbs = pdbs
            real_scores = [
                float(r["score_real"]) for r in rows
                if r["score_real"] not in ("", "nan")
            ]
        elif pdbs != ref_pdbs:
            raise ValueError(f"PDB mismatch for model {model}: "
                             f"{pdbs} vs {ref_pdbs}")
        labels.append(model)
        series.append([
            float(r["score_pred"]) for r in rows
            if r["score_pred"] not in ("", "nan")
        ])
    fig, ax = plt.subplots(figsize=(2 + 1.2 * (len(labels) + 1), 5))
    ax.boxplot([real_scores] + series, tick_labels=["scwrl_real"] + labels)
    ax.set_ylabel("SCWRL total minimal energy")
    ax.set_title("Side-chain packing energy: repacked WT vs designs")
    plt.setp(ax.get_xticklabels(), rotation=30, ha="right")
    fig.tight_layout()
    out = Path(output_path) / filename
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out
