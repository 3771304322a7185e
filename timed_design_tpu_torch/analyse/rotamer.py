"""Rotamer evaluation: ground-truth tagging and the 338-class metrics, the
port of ``timed_design_tpu/analyse/rotamer.py``.

Every structure's residues are tagged with their crystal rotamer class by
chi-angle binning (``structure/geometry.py``, host numpy per structure); the
predicted (N, 338) matrix is then scored against the tags on the device:
ROC AUC (one-vs-one and one-vs-rest), top-1..5, macro precision and recall,
bias, and the unweighted and weighted confusion matrices, written as
``results_{suffix}.txt`` byte for byte as the JAX package writes it.
"""
from __future__ import annotations

import typing as t
from pathlib import Path

import numpy as np
import torch

from ..constants import N_ROTAMER_CLASSES, ROTAMER_CATEGORIES
from ..engine.predictor import default_device
from ..structure.geometry import encode_structure_rotamers
from ..structure.pdb import Structure, load_pdb
from .metrics import (
    _count,
    _ovo_macro,
    _ovr_macro,
    _ratio,
    accuracy,
    classification_report,
    confusion,
    pair_rank_counts,
    precision_recall_f1,
    prediction_bias,
    true_class_rank,
)


def resolve_structure_paths(
    codes: t.Iterable[str],
    pdb_dir: Path,
    fetcher: t.Callable[[str], Path] | None = None,
) -> dict[str, t.Optional[Path]]:
    """Map pdb codes to files in a local mirror; optionally fetch misses.

    Search order per code: flat ``{code}.pdb/.pdb1/.pdb1.gz``, then the
    two-character sharded ``<code[1:3]>/{code}.pdb1.gz`` (and ``.pdb1``,
    ``.pdb``, where ``io.fetch.make_fetcher`` puts its downloads). Codes
    still missing go to ``fetcher`` when one is given; a failed fetch maps
    the code to ``None``.
    """
    pdb_dir = Path(pdb_dir)
    out: dict[str, t.Optional[Path]] = {}
    # chain keys ('2xxxA', '2xxxB', ...) collapse to one 4-character code
    # first, so a dead code is fetched once, not once per chain
    for code in dict.fromkeys(key[:4] for key in codes):
        found = None
        for cand in (
            pdb_dir / f"{code}.pdb",
            pdb_dir / f"{code}.pdb1",
            pdb_dir / f"{code}.pdb1.gz",
            pdb_dir / code[1:3] / f"{code}.pdb1.gz",
            pdb_dir / code[1:3] / f"{code}.pdb1",
            pdb_dir / code[1:3] / f"{code}.pdb",
        ):
            if cand.exists():
                found = cand
                break
        if found is None and fetcher is not None:
            try:
                found = fetcher(code)
            except Exception as e:  # noqa: BLE001 - per-code isolation
                print(f"Could not fetch {code}: {e}")
        out[code] = found
    return out


def tag_structures_with_rotamers(
    pdb_paths: dict[str, t.Optional[Path]],
    fetcher: t.Callable[[str], Path] | None = None,
) -> tuple[dict[str, list[float]], dict[str, Structure]]:
    """{pdb_code: path} -> ({pdb_code + chain: rotamer codes}, {code: Structure}).

    A ``None`` path is fetched when ``fetcher`` (a ``code -> Path``
    callable, ``io/fetch.py``) is given, else skipped with a message.
    """
    result: dict[str, list[float]] = {}
    assemblies: dict[str, Structure] = {}
    for pdb_code, path in pdb_paths.items():
        if path is None and fetcher is not None:
            try:
                path = fetcher(pdb_code[:4])
            except Exception as e:  # noqa: BLE001 - per-code isolation
                print(f"Could not fetch {pdb_code}: {e}")
        if path is None:
            print(f"Could not find {pdb_code}")
            continue
        s = load_pdb(Path(path))
        assemblies[pdb_code[:4]] = s
        for chain in s.chains:
            sub = s.select_chain(chain.chain_id)
            result[f"{pdb_code[:4]}{chain.chain_id}"] = encode_structure_rotamers(sub)
    return result, assemblies


def renormalize_float16_rows(y_pred) -> torch.Tensor:
    """Spread each row's float16 rounding residual uniformly so that it sums
    to 1: a float64 tensor, on ``y_pred``'s device (the CPU for numpy).

    The row sums of float16 values (up to 512 columns) are exact in any
    order, so these rows equal the JAX package's bit for bit; other float64
    rows may differ from numpy's pairwise sums in the last bit.
    """
    y = (y_pred if isinstance(y_pred, torch.Tensor) else torch.as_tensor(np.asarray(y_pred)))
    y = y.to(torch.float64, copy=True)
    sums = y.sum(1)
    off = ~torch.isclose(torch.ones_like(sums), sums)
    if bool(off.any()):
        y[off] += ((1.0 - sums[off]) / y.shape[1])[:, None]
        if not bool(torch.isclose(torch.ones_like(sums), y.sum(1)).all()):
            raise ValueError("rows do not sum to 1 after spreading the residual")
    return y


def calculate_rotamer_metrics(
    pdb_to_probability: dict[str, np.ndarray],
    pdb_to_rotamer: dict[str, t.Sequence[float]],
    rot_categories: t.Sequence[str] = ROTAMER_CATEGORIES,
    suffix: str = "",
    output_path: Path | None = None,
    plot_confusion: bool = False,
    device: torch.device | str | None = None,
) -> dict:
    """Rotamer metric bundle, optional results file and confusion plots;
    the (N, 338) passes on ``device`` (default: the CUDA device).

    Residues whose ground-truth rotamer is NaN (untaggable) are dropped;
    length-mismatched structures are skipped with a message.
    """
    device = torch.device(device) if device is not None else default_device()
    if plot_confusion:
        from .plots import pyplot

        pyplot("--plot_confusion")  # fail before the metrics, not after
    y_pred_parts, y_true_parts = [], []
    for pdb, prob in pdb_to_probability.items():
        if pdb not in pdb_to_rotamer:
            print(f"Error with pdb code {pdb}")
            continue
        rot = np.asarray(pdb_to_rotamer[pdb], float)
        if len(prob) != len(rot):
            print(f"Error with pdb code {pdb} - Length Mismatch")
            continue
        y_pred_parts.append(np.asarray(prob))
        y_true_parts.append(rot)
    if not y_pred_parts:
        raise ValueError(
            "No structure overlaps between predictions and rotamer tags — "
            "every structure was missing or length-mismatched."
        )
    y_pred = np.concatenate(y_pred_parts).reshape(-1, N_ROTAMER_CLASSES)
    y_true = np.concatenate(y_true_parts).ravel()
    keep = ~np.isnan(y_true)
    y_pred = torch.from_numpy(np.ascontiguousarray(y_pred[keep])).to(device)
    y_true = torch.from_numpy(y_true[keep].astype(np.int64)).to(device)
    y_pred = renormalize_float16_rows(y_pred)
    y_argmax = y_pred.argmax(1)

    n = len(rot_categories)
    labels = list(rot_categories)
    prec, rec = precision_recall_f1(y_true, y_argmax, n)[:2]
    rank = true_class_rank(y_true, y_pred)
    # one pass of pair counts serves both AUCs
    twice_u = pair_rank_counts(y_true, y_pred).cpu().numpy()
    n_true = torch.bincount(y_true, minlength=n).cpu().numpy()
    metrics = {
        "auc_ovo": _ovo_macro(twice_u, n_true),
        "auc_ovr": _ovr_macro(twice_u, n_true),
        "report": classification_report(y_true, y_argmax, labels),
        "accuracy": accuracy(y_true, y_argmax),
        **{f"accuracy_{k}": _ratio(_count(rank < k), rank.numel()) for k in (2, 3, 4, 5)},
        "precision": float(prec.mean()),
        "recall": float(rec.mean()),
        "bias": prediction_bias(y_true, y_argmax, labels),
    }
    unweighted_cm = confusion(y_true, y_argmax, n, normalize="all")
    # "weighted" is weighted BY class frequency (count / total), the
    # reference's own definition behind its published panels
    weights = n_true.astype(float)
    weights /= max(weights.sum(), 1e-12)
    weighted_cm = confusion(
        y_true, y_argmax, n, normalize="all",
        sample_weight=torch.from_numpy(weights).to(device)[y_true],
    )
    metrics["unweighted_cm"] = unweighted_cm
    metrics["weighted_cm"] = weighted_cm

    if output_path is not None:
        output_path = Path(output_path)
        with open(output_path / f"results_{suffix}.txt", "w") as f:
            f.write(f"Metrics AUC_OVR: {metrics['auc_ovr']}\n")
            f.write(f"Metrics AUC_OVO: {metrics['auc_ovo']}\n")
            f.write(f"Metrics Macro-Precision: {metrics['precision']}\n")
            f.write(f"Metrics Macro-Recall: {metrics['recall']}\n")
            f.write(
                f"Accuracy: {metrics['accuracy']}\n"
                + "".join(
                    f"accuracy_{k}: {metrics[f'accuracy_{k}']}\n" for k in (2, 3, 4, 5)
                )
            )
            f.write(f"Report:\n{metrics['report']}\n")
            f.write(f"Bias:\n{metrics['bias']}\n")
        if plot_confusion:
            from .plots import create_rot_cm

            create_rot_cm(unweighted_cm, labels, f"{suffix}_unweighted", output_path)
            create_rot_cm(weighted_cm, labels, f"{suffix}_weighted", output_path)
    return metrics
