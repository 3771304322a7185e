"""AlphaFold2 refolding evaluation: the port of
``timed_design_tpu/analyse/af2.py``.

Partition sampled fastas into job folders, emit SLURM job scripts for AF2,
map AF2 outputs back to their designs, compute refold CA-RMSD and GDT
{1,2,4,8} by Kabsch superposition (``structure/geometry.py``), and the
combined per-structure property table (entropy, packing density, pLDDT,
RMSD).
"""
from __future__ import annotations

import dataclasses
import typing as t
from pathlib import Path

import numpy as np
import torch

from ..structure.geometry import superpose
from ..structure.pdb import Structure, load_pdb
from .structure_analysis import (
    calculate_prediction_entropy,
    extract_bfactor_from_structure,
    extract_packdensity_from_structure,
)

GDT_CUTOFFS = (1.0, 2.0, 4.0, 8.0)


def read_fasta(path: Path) -> dict[str, str]:
    out: dict[str, str] = {}
    name = None
    for line in Path(path).read_text().splitlines():
        if line.startswith(">"):
            name = line[1:].strip()
            out[name] = ""
        elif name is not None:
            out[name] += line.strip()
    return out


def partition_fastas(
    fasta_path: Path, output_dir: Path, per_folder: int = 80
) -> list[Path]:
    """Split a multi-record fasta into numbered job folders of single-record
    fastas, ``per_folder`` to a job."""
    records = read_fasta(fasta_path)
    output_dir = Path(output_dir)
    folders = []
    for i, (name, seq) in enumerate(records.items()):
        folder = output_dir / f"job_{i // per_folder}"
        folder.mkdir(parents=True, exist_ok=True)
        if folder not in folders:
            folders.append(folder)
        (folder / f"{name}.fasta").write_text(f">{name}\n{seq}\n")
    return folders


def make_af2_slurm_script(
    job_folder: Path,
    output_path: Path,
    partition: str = "ampere",
    gpus: int = 1,
    cpus: int = 32,
    hours: int = 36,
    af2_cmd: str = "colabfold_batch",
) -> Path:
    """Emit a SLURM batch script for one AF2 job folder."""
    job_folder = Path(job_folder)
    script = f"""#!/bin/bash
#SBATCH --partition={partition}
#SBATCH --gres=gpu:{gpus}
#SBATCH --cpus-per-task={cpus}
#SBATCH --time={hours}:00:00
#SBATCH --job-name=af2_{job_folder.name}

{af2_cmd} {job_folder} {job_folder}/out --num-models 1
"""
    out = Path(output_path) / f"run_af2_{job_folder.name}.sh"
    out.write_text(script)
    return out


def rename_af2_outputs(af2_dir: Path, suffix: str = "_rank_001") -> dict[str, Path]:
    """Map AF2 output pdbs back to their fasta header names.
    Returns {design_name: pdb_path}."""
    out = {}
    for pdb in Path(af2_dir).glob("**/*.pdb"):
        stem = pdb.stem
        if suffix in stem:
            design = stem.split(suffix)[0]
            out[design] = pdb
    return out


@dataclasses.dataclass
class RefoldResult:
    design: str
    rmsd: float
    gdt: dict[float, float]
    mean_plddt: float


def analyse_refold(
    reference_structure: t.Union[Structure, Path],
    refolded_structure: t.Union[Structure, Path],
    design_name: str = "",
) -> RefoldResult:
    """CA-superpose the AF2 refold onto the design target; RMSD + GDT + pLDDT.

    NaN metrics on a length mismatch: degrade, don't abort.
    """
    ref = (
        reference_structure
        if isinstance(reference_structure, Structure)
        else load_pdb(Path(reference_structure))
    )
    fold = (
        refolded_structure
        if isinstance(refolded_structure, Structure)
        else load_pdb(Path(refolded_structure))
    )
    ref_ca = ref.backbone_arrays()["CA"]
    fold_ca = fold.backbone_arrays()["CA"]
    plddts = extract_bfactor_from_structure(fold)
    mean_plddt = float(np.mean([v for chain in plddts for v in chain])) if plddts else float("nan")
    if ref_ca.shape != fold_ca.shape or np.isnan(ref_ca).any() or np.isnan(fold_ca).any():
        return RefoldResult(design_name, float("nan"),
                            {c: float("nan") for c in GDT_CUTOFFS}, mean_plddt)
    # one superposition serves both metrics (the per-cutoff GDT fractions
    # come from the same aligned distance vector as the RMSD)
    aligned, rmsd = superpose(fold_ca, ref_ca)
    dists = np.linalg.norm(aligned - ref_ca, axis=1)
    gdt_scores = {c: float((dists <= c).mean()) for c in GDT_CUTOFFS}
    return RefoldResult(design_name, rmsd, gdt_scores, mean_plddt)


def analyse_af2_folder(
    reference_pdb: Path, af2_dir: Path, suffix: str = "_rank_001"
) -> list[RefoldResult]:
    """Evaluate every refold in a folder against one reference backbone."""
    designs = rename_af2_outputs(af2_dir, suffix)
    ref = load_pdb(Path(reference_pdb))
    return [analyse_refold(ref, path, name) for name, path in sorted(designs.items())]


def combined_property_table(
    prediction_matrix: np.ndarray,
    structure: Structure,
    refold_results: t.Sequence[RefoldResult],
    device: torch.device | str | None = None,
) -> dict[str, t.Any]:
    """Entropy + packing density (on ``device``, default the CUDA device) +
    pLDDT + RMSD summary per design."""
    entropy = calculate_prediction_entropy(prediction_matrix)
    packing = extract_packdensity_from_structure(structure, atom_filter="ca", device=device)
    return {
        "mean_entropy": float(np.mean(entropy)),
        "mean_packing_density": float(np.mean([p for p in packing if p >= 0])),
        "designs": [
            {
                "design": r.design,
                "rmsd": r.rmsd,
                **{f"gdt_{int(c)}": v for c, v in r.gdt.items()},
                "mean_plddt": r.mean_plddt,
            }
            for r in refold_results
        ],
    }


def analyse_cherrypicked(
    reference_pdb: Path,
    af2_models_dir: Path,
    pred_folder: Path | None = None,
    output_dir: Path | None = None,
    ranked_glob: str = "**/*{code}*_ranked_0.pdb",
    device: torch.device | str | None = None,
) -> dict[str, t.Any]:
    """Per-position comparison of one cherry-picked design across models.

    For every model's top-ranked AF2 refold of the design, per position: (1)
    the CA deviation after a Kabsch CA superposition, (2) AF2 pLDDT, (3)
    packing density (on ``device``, default the CUDA device), and (4) with
    ``pred_folder``, the prediction entropy from the model's saved
    ``{model}.csv`` + ``{model}.txt``.

    Returns {"models", "rmsd", "per_position": {metric: (n_models, L)}}.
    When ``output_dir`` is given, writes one line plot per metric (needs
    matplotlib) plus a combined long-format CSV.
    """
    from .structure_analysis import extract_prediction_entropy_to_dict

    reference_pdb = Path(reference_pdb)
    code = reference_pdb.name.split(".")[0]
    paths = sorted(Path(af2_models_dir).glob(ranked_glob.format(code=code)))
    if not paths:
        raise FileNotFoundError(
            f"no {ranked_glob.format(code=code)} under {af2_models_dir}"
        )
    ref = load_pdb(reference_pdb)
    ref_ca = ref.backbone_arrays()["CA"]
    L = ref_ca.shape[0]

    # model label = parent dir name; disambiguate
    # collisions (two ranked files in one dir, or same-named dirs under
    # different parents) with the file stem so no trace is silently dropped
    models: list[str] = []
    seen: dict[str, int] = {}
    for p in paths:
        label = p.parent.name
        if label in seen:
            label = f"{label}/{p.stem}"
        seen[p.parent.name] = seen.get(p.parent.name, 0) + 1
        models.append(label)

    rmsd: dict[str, float] = {}
    per_pos: dict[str, list[np.ndarray]] = {
        "ca_deviation": [], "plddt": [], "packing_density": [],
    }
    for model, p in zip(models, paths):
        s = load_pdb(p)
        ca = s.backbone_arrays()["CA"]
        if ca.shape == ref_ca.shape and not np.isnan(ca).any():
            aligned, r = superpose(ca, ref_ca)
            dists = np.linalg.norm(aligned - ref_ca, axis=1)
        else:  # degrade, don't abort
            r, dists = float("nan"), np.full(L, np.nan)
        rmsd[model] = float(r)
        per_pos["ca_deviation"].append(dists)
        plddt = np.array(
            [v for chain in extract_bfactor_from_structure(s) for v in chain],
            np.float64,
        )
        per_pos["plddt"].append(_fit_length(plddt, L))
        pack = np.array(
            extract_packdensity_from_structure(s, atom_filter="ca", device=device),
            np.float64,
        )
        per_pos["packing_density"].append(_fit_length(pack, L))

    if pred_folder is not None:
        entropies = []
        for model in models:
            csv = Path(pred_folder) / f"{model}.csv"
            txt = Path(pred_folder) / f"{model}.txt"
            if not (csv.exists() and txt.exists()):
                entropies.append(np.full(L, np.nan))
                continue
            by_pdb = extract_prediction_entropy_to_dict(
                csv, txt, rotamer_mode="rot" in model
            )
            hit = next((v for k, v in by_pdb.items() if code in k), None)
            entropies.append(
                _fit_length(np.asarray(hit, np.float64), L)
                if hit is not None else np.full(L, np.nan)
            )
        per_pos["entropy"] = entropies

    result = {
        "models": models,
        "rmsd": rmsd,
        "per_position": {k: np.stack(v) for k, v in per_pos.items()},
    }
    if output_dir is not None:
        _write_cherrypicked_outputs(result, Path(output_dir), code)
    return result


def _fit_length(arr: np.ndarray, L: int) -> np.ndarray:
    """NaN-pad/truncate to the reference length so models stay comparable."""
    out = np.full(L, np.nan)
    n = min(L, len(arr))
    out[:n] = arr[:n]
    return out


def _write_cherrypicked_outputs(result: dict, output_dir: Path, code: str):
    import csv

    from .plots import pyplot

    plt = pyplot("analyse_cherrypicked(output_dir=...)")

    output_dir.mkdir(parents=True, exist_ok=True)
    models = result["models"]
    for metric, mat in result["per_position"].items():
        fig, ax = plt.subplots(figsize=(10, 4.8))
        for name, row in zip(models, mat):
            ax.plot(row, label=name, linewidth=1)
        ax.set_xlabel("Position")
        ax.set_ylabel(metric)
        ax.set_title(f"{metric} — {code}")
        ax.legend(bbox_to_anchor=(1.05, 1), loc=2, borderaxespad=0.0,
                  fontsize=7)
        fig.tight_layout()
        fig.savefig(output_dir / f"{code}_{metric}.png", dpi=120)
        plt.close(fig)
    with open(output_dir / f"{code}_cherrypicked.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["model", "metric", "position", "value"])
        for metric, mat in result["per_position"].items():
            for name, row in zip(models, mat):
                for i, v in enumerate(row):
                    w.writerow([name, metric, i, f"{v:.6g}"])
