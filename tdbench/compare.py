"""The comparison that decides ``correct``: the plain reference run again on
what the timed path was given, and the numbers that measure how far the
program's answers lie from it. Each number is held to a limit of its own
from ``limits/<cell>.json``."""
from __future__ import annotations

import sys

import numpy as np

from .harness import Check
from .reference import frames as ref_frames
from .reference import model as ref_model


def reference_probs(texts: dict, wanted: list, weights: dict, device,
                    block: int = 256) -> np.ndarray:
    """Reference probabilities (float32, float64 on the host) of the frames
    ``wanted`` [(structure name, chain, residue id)], made from the PDB
    ``texts`` {structure name: text}; rows in ``wanted``'s order."""
    import torch

    ref_model.no_tf32()
    by_name: dict[str, list[int]] = {}
    for i, (name, _, _) in enumerate(wanted):
        by_name.setdefault(name, []).append(i)
    out = np.zeros((len(wanted), weights["head.bias"].shape[0]))
    for name, idx in by_name.items():
        fa = ref_frames.frame_atoms(ref_frames.parse_backbone(texts[name]))
        row_of = {k: r for r, k in enumerate(fa["keys"])}
        rows = np.array([row_of[wanted[i][1:]] for i in idx])
        for s in range(0, len(rows), block):
            x = ref_frames.voxelize(fa, rows[s : s + block], device)
            out[idx[s : s + block]] = ref_model.probabilities(weights, x).double().cpu().numpy()
            del x
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def answer_gaps(got: np.ndarray, want: np.ndarray) -> dict:
    """How far probability rows ``got`` (the program's) lie from ``want``
    (the reference's): ``prob_err``, the largest absolute difference;
    ``kl``, the mean over rows of KL(want || got); ``logit_err``, the
    error of the log probabilities relative to their own spread, each
    weighted by the reference's probability and centred on its row's
    weighted mean (the square root of the summed squared errors over the
    summed squared spreads); ``argmax_gap``, the widest gap in log
    probability by which the class the program ranks first lies below the
    reference's first."""
    if not len(want):
        return {}
    got = np.asarray(got, np.float64)
    tiny = 1e-30
    log_want, log_got = np.log(want + tiny), np.log(np.maximum(got, 0) + tiny)
    kl = (want * (log_want - log_got)).sum(1)
    delta = log_got - log_want

    def spread(v):
        return (want * (v - (want * v).sum(1, keepdims=True)) ** 2).sum()

    rows = np.arange(len(want))
    gap = log_want.max(1) - log_want[rows, got.argmax(1)]
    return {"prob_err": float(np.abs(got - want).max()), "kl": float(kl.mean()),
            "logit_err": float(np.sqrt(spread(delta) / spread(log_want))),
            "argmax_gap": float(gap.max())}


def checks(readings: dict, limits: dict) -> list[Check]:
    """A Check for each number that the cell's limits name; a number that
    no run produced reads NaN, which fails. The readings that no limit
    names go to standard error, for the record."""
    for name in sorted(set(readings) - set(limits)):
        print(f"reading {name}: {readings[name]!r} (not compared)", file=sys.stderr)
    return [Check(name, float(readings.get(name, float("nan"))), float(limit))
            for name, limit in limits.items()]
