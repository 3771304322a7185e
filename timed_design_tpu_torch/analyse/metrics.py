"""Classification metrics of sequence and rotamer recovery: the port of
``timed_design_tpu/analyse/metrics.py``.

The passes over the N labels and the (N, C) score matrix are tensor code on
the device of the tensors given (a numpy array is host data and stays on the
CPU): labels counted with ``bincount``, each row's rank of its true class
for top-k, and the Mann-Whitney pair counts behind both ROC AUCs from one
sort and two ``searchsorted`` per block of columns. They produce integers,
so the card and the CPU agree exactly. What is class-sized (per-class
ratios, their means, the AUC of each class pair) is finished in numpy in
the JAX package's own order, so every value is bit-equal to its.

Labels are ``(y_true, y_pred)`` in that order throughout. Scores hold no
NaN (the rotamer path renormalizes rows that sum to 1 first).
"""
from __future__ import annotations

import typing as t

import numpy as np
import torch

from ..constants import AA1, AA1_TO_INT
from ..engine.predictor import default_device


def _device(*xs) -> torch.device:
    """The device of the first tensor among ``xs``; the CPU for numpy data."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def _count(mask: torch.Tensor) -> int:
    return int(mask.sum().item())


def _ratio(count: int, total: int) -> float:
    """count / total as numpy's mean of a boolean array gives it: the exact
    count divided once, correctly rounded (NaN for no rows)."""
    return count / total if total else float("nan")


def accuracy(y_true, y_pred) -> float:
    dev = _device(y_true, y_pred)
    yt, yp = _tensor(y_true, torch.int64, dev), _tensor(y_pred, torch.int64, dev)
    return _ratio(_count(yt == yp), yt.numel())


def true_class_rank(y_true, scores) -> torch.Tensor:
    """(N,) int64: the place of each row's true class in its ranking, 0
    first, on ``scores``' device. The order is sklearn's
    ``top_k_accuracy_score``'s, a stable ascending argsort reversed: higher
    scores first and, among equal scores, higher class indices first. Tied
    scores are common in float16-quantized rows, where this decides the
    number. Counting the classes ranked above the true one gives that place
    without sorting."""
    dev = _device(scores, y_true)
    s = _tensor(scores, torch.float64, dev)
    yt = _tensor(y_true, torch.int64, dev)[:, None]
    st = s.gather(1, yt)
    later = torch.arange(s.shape[1], device=dev)[None, :] > yt
    return ((s > st) | ((s == st) & later)).sum(1)


def top_k_accuracy(y_true, scores, k: int) -> float:
    """Fraction of rows whose true label is among the k highest scores,
    ties broken as ``true_class_rank`` says."""
    rank = true_class_rank(y_true, scores)
    return _ratio(_count(rank < k), rank.numel())


def _cell_counts(y_true, y_pred, n_classes: int, sample_weight=None) -> np.ndarray:
    """(n, n) float64 host array: the (weighted) count of rows of true class
    i predicted j. Counted on the labels' device; without weights the counts
    are exact, with them the sum of each cell's weights (in row order on the
    CPU, as numpy's ``add.at``; in the card's atomic order there)."""
    dev = _device(y_true, y_pred, sample_weight)
    yt, yp = _tensor(y_true, torch.int64, dev), _tensor(y_pred, torch.int64, dev)
    w = None if sample_weight is None else _tensor(sample_weight, torch.float64, dev)
    flat = torch.bincount(yt * n_classes + yp, weights=w, minlength=n_classes * n_classes)
    return flat.to(torch.float64).reshape(n_classes, n_classes).cpu().numpy()


def confusion(
    y_true, y_pred, n_classes: int,
    normalize: str | None = "all", sample_weight=None,
) -> np.ndarray:
    """Confusion matrix C[i, j] = (weighted) count of true i predicted j."""
    cm = _cell_counts(y_true, y_pred, n_classes, sample_weight)
    if normalize == "all":
        cm = cm / max(cm.sum(), 1e-12)
    elif normalize == "true":
        cm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1e-12)
    elif normalize == "pred":
        cm = cm / np.maximum(cm.sum(axis=0, keepdims=True), 1e-12)
    return cm


def precision_recall_f1(
    y_true, y_pred, n_classes: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-class (precision, recall, f1, support) with zero_division=0."""
    cm = confusion(y_true, y_pred, n_classes, normalize=None)
    tp = np.diag(cm)
    pred_tot = cm.sum(axis=0)
    true_tot = cm.sum(axis=1)
    prec = np.where(pred_tot > 0, tp / np.maximum(pred_tot, 1e-12), 0.0)
    rec = np.where(true_tot > 0, tp / np.maximum(true_tot, 1e-12), 0.0)
    f1 = np.where(prec + rec > 0, 2 * prec * rec / np.maximum(prec + rec, 1e-12), 0.0)
    return prec, rec, f1, true_tot


def classification_report(y_true, y_pred, target_names: t.Sequence[str]) -> dict:
    """sklearn-shaped report dict: per-class P/R/F1/support + averages."""
    n = len(target_names)
    prec, rec, f1, support = precision_recall_f1(y_true, y_pred, n)
    report = {
        name: {
            "precision": float(prec[i]),
            "recall": float(rec[i]),
            "f1-score": float(f1[i]),
            "support": float(support[i]),
        }
        for i, name in enumerate(target_names)
    }
    report["accuracy"] = accuracy(y_true, y_pred)
    total = support.sum()
    report["macro avg"] = {
        "precision": float(prec.mean()),
        "recall": float(rec.mean()),
        "f1-score": float(f1.mean()),
        "support": float(total),
    }
    wts = support / max(total, 1e-12)
    report["weighted avg"] = {
        "precision": float((prec * wts).sum()),
        "recall": float((rec * wts).sum()),
        "f1-score": float((f1 * wts).sum()),
        "support": float(total),
    }
    return report


def prediction_bias(y_true, y_pred, labels: t.Sequence[str]) -> dict[str, float]:
    """Per-class (predicted fraction - true fraction)."""
    n = len(labels)
    dev = _device(y_true, y_pred)
    yt, yp = _tensor(y_true, torch.int64, dev), _tensor(y_pred, torch.int64, dev)
    total = yt.numel()
    c_true = torch.bincount(yt, minlength=n).cpu().numpy() / max(total, 1)
    c_pred = torch.bincount(yp, minlength=n).cpu().numpy() / max(total, 1)
    return {labels[i]: float(c_pred[i] - c_true[i]) for i in range(n)}


def pair_rank_counts(y_true, scores, max_elements: int = 1 << 25) -> torch.Tensor:
    """(C, C) int64 on ``scores``' device: entry [a, b] is twice the
    Mann-Whitney U of class a's rows against class b's rows on score column
    a, i.e. over every such pair of rows 2 where the a-row scores higher, 1
    where they tie.

    Per block of columns: each column sorted once for the dense rank of its
    values (ties share one); the keys (column, label, rank) sorted into one
    int64 array; then for every row and every class b, ``searchsorted`` left
    and right of the row's own key within (its class's column, b) count b's
    rows below it and level with it. A block holds about ``max_elements``
    (row, column) pairs.
    """
    dev = _device(scores, y_true)
    s = _tensor(scores, torch.float64, dev)
    y = _tensor(y_true, torch.int64, dev)
    N, C = s.shape
    n_b = torch.bincount(y, minlength=C)
    seg_start = torch.cumsum(n_b, 0) - n_b  # where label b's rows start in a column
    labels = torch.arange(C, device=dev)
    out = torch.zeros((C, C), dtype=torch.int64, device=dev)
    width = max(1, max_elements // max(N, 1))
    for c0 in range(0, C, width):
        w = min(width, C - c0)
        vals, perm = torch.sort(s[:, c0:c0 + w], dim=0)
        step = torch.zeros_like(perm)
        step[1:] = vals[1:] != vals[:-1]
        rank = torch.empty_like(perm).scatter_(0, perm, step.cumsum(0))
        col = torch.arange(w, device=dev)[None, :]
        keys = ((col * C + y[:, None]) * (N + 1) + rank).T.reshape(-1)
        keys = torch.sort(keys).values
        rows = torch.nonzero((y >= c0) & (y < c0 + w)).squeeze(1)
        a = y[rows]
        own = rank[rows, a - c0]
        q = (((a - c0) * C)[:, None] + labels[None, :]) * (N + 1) + own[:, None]
        start = (a - c0)[:, None] * N + seg_start[None, :]
        twice = (torch.searchsorted(keys, q) + torch.searchsorted(keys, q, right=True)
                 - 2 * start)
        out.index_add_(0, a, twice)
    return out


def _pair_aucs(twice_u: np.ndarray, n: np.ndarray, a, b) -> np.ndarray:
    """AUC of class a's score telling class-a rows from class-b rows:
    U / (n_a n_b), with U exact, so each value is bit-equal to the rank-sum
    form's."""
    return (twice_u[a, b] / 2) / (n[a] * n[b]).astype(np.float64)


def _ovo_macro(twice_u: np.ndarray, n: np.ndarray) -> float:
    """Hand & Till's macro one-vs-one AUC over the classes present, pairs in
    the JAX package's order (a < b, row by row)."""
    present = np.nonzero(n > 0)[0]
    ia, ib = np.triu_indices(len(present), k=1)
    if not len(ia):
        return float("nan")
    a, b = present[ia], present[ib]
    pair = (_pair_aucs(twice_u, n, a, b) + _pair_aucs(twice_u, n, b, a)) / 2
    return float(np.mean(pair))


def _ovr_macro(twice_u: np.ndarray, n: np.ndarray) -> float:
    total = int(n.sum())
    if (n == 0).any() or (n == total).any():
        return float("nan")
    u = (twice_u.sum(axis=1) - np.diag(twice_u)) / 2
    aucs = [float(u[c] / (n[c] * (total - n[c]))) for c in range(len(n))]
    return float(np.mean(aucs))


def _auc_inputs(y_true, scores) -> tuple[np.ndarray, np.ndarray]:
    twice_u = pair_rank_counts(y_true, scores)
    n = torch.bincount(_tensor(y_true, torch.int64, twice_u.device),
                       minlength=twice_u.shape[0])
    return twice_u.cpu().numpy(), n.cpu().numpy()


def roc_auc_ovo_macro(y_true, scores) -> float:
    """Macro one-vs-one multiclass ROC AUC: for each pair of classes (a, b)
    present in y_true, the mean of class a's AUC against b on score a and
    b's against a on score b (Hand & Till, 2001); the mean over pairs."""
    return _ovo_macro(*_auc_inputs(y_true, scores))


def roc_auc_ovr_macro(y_true, scores) -> float:
    """Macro one-vs-rest ROC AUC; NaN if any class is absent (or is every
    row)."""
    return _ovr_macro(*_auc_inputs(y_true, scores))


def sequences_to_labels(
    pdb_to_sequence: dict[str, str], pdb_to_real_sequence: dict[str, str]
) -> tuple[np.ndarray, np.ndarray]:
    """Paired (y_true, y_pred) int arrays over all shared structures."""
    yt, yp = [], []
    for pdb, pred_seq in pdb_to_sequence.items():
        if pdb not in pdb_to_real_sequence:
            print(f"Error with pdb code {pdb}")
            continue
        for r_true, r_pred in zip(pdb_to_real_sequence[pdb], pred_seq):
            if r_true in AA1_TO_INT and r_pred in AA1_TO_INT:
                yt.append(AA1_TO_INT[r_true])
                yp.append(AA1_TO_INT[r_pred])
    return np.array(yt, int), np.array(yp, int)


def calculate_metrics(
    pdb_to_sequence: dict[str, str],
    pdb_to_real_sequence: dict[str, str],
    pdb_to_probability: dict[str, np.ndarray] | None = None,
    device: torch.device | str | None = None,
) -> dict:
    """Sequence-recovery metric bundle, its (N, 20) passes on ``device``
    (default: the CUDA device).

    Without ``pdb_to_probability``, accuracy_2..5 rank one-hot argmax rows,
    as the reference does: beyond rank 1 that is sklearn's tie-break over 19
    zero scores (highest class index first). Pass the (R, 20) probability
    rows for true top-k accuracy.
    """
    device = torch.device(device) if device is not None else default_device()
    y_true, y_pred = sequences_to_labels(pdb_to_sequence, pdb_to_real_sequence)
    if pdb_to_probability is None:
        scores = np.eye(20)[y_pred]
    else:
        # the rows of sequences_to_labels: shared pdbs, standard letters only
        rows = []
        for pdb, pred_seq in pdb_to_sequence.items():
            if pdb not in pdb_to_real_sequence:
                continue
            probs = pdb_to_probability.get(pdb)
            if probs is None:
                raise ValueError(
                    f"pdb_to_probability is missing an entry for {pdb!r}, "
                    f"which is present in both sequence dicts; pass "
                    f"probability rows for every scored structure or pass "
                    f"pdb_to_probability=None for one-hot scoring"
                )
            P = np.asarray(probs)
            if P.shape[0] < len(pred_seq):
                raise ValueError(
                    f"{pdb}: {P.shape[0]} probability rows do not align "
                    f"with a {len(pred_seq)}-residue sequence"
                )
            for i, (r_true, r_pred) in enumerate(
                zip(pdb_to_real_sequence[pdb], pred_seq)
            ):
                if r_true in AA1_TO_INT and r_pred in AA1_TO_INT:
                    rows.append(P[i])
        scores = np.asarray(rows)
        if scores.shape != (len(y_true), 20):
            raise ValueError(
                f"probability rows {scores.shape} do not align with the "
                f"{len(y_true)} scored residues (20 classes required)"
            )
    yt = _tensor(y_true, torch.int64, device)
    yp = _tensor(y_pred, torch.int64, device)
    rank = true_class_rank(yt, _tensor(scores, torch.float64, device))
    labels = list(AA1)
    prec, rec = precision_recall_f1(yt, yp, 20)[:2]
    metrics = {
        "report": classification_report(yt, yp, labels),
        "accuracy_1": accuracy(yt, yp),
        **{f"accuracy_{k}": _ratio(_count(rank < k), len(y_true)) for k in (2, 3, 4, 5)},
        "precision": float(prec.mean()),
        "recall": float(rec.mean()),
        "count_labels": dict(zip(*np.unique(y_true, return_counts=True))),
        "count_pred": dict(zip(*np.unique(y_pred, return_counts=True))),
        "bias": prediction_bias(yt, yp, labels),
        "unweighted_cm": confusion(yt, yp, 20, normalize="all"),
    }
    return metrics
