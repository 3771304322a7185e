"""Sequence metrics from residue counts: charge, pI, MW, molar extinction.

The port of ``timed_design_tpu/sample/metrics.py``. All four metrics are
functions of the per-class residue counts, so a batch of sampled sequences
reduces to a (B, 20) count matrix and every metric is (B, 20) arithmetic on
the device. On the serving path the counts come from the sampling kernel
(``ops.sample.sample_inverse_cdf``); ``counts_from_codes`` is the masked
one-hot sum for codes from elsewhere. Henderson–Hasselbalch charge with the
EMBOSS pKa set; the two termini are two more titratable groups, counted once
per sequence.

The isoelectric point narrows [0, 14] by 2**-60 as the JAX package's
60-step bisection does, but 6 steps at a time: each of 10 rounds evaluates
the charge at 64 points of the bracket at once. A request then costs ~150
small device operations instead of ~700; each operation takes and releases
the interpreter lock, which concurrent request threads contend for.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import (
    AA1_TO_INT,
    EXT280_ARR,
    MW_ARR,
    PKA_NEGATIVE,
    PKA_POSITIVE,
    PKA_SIDECHAIN_ARR,
    PKA_SIGN_ARR,
    WATER_MASS,
)

# 20 side chains, then the N and C termini
_PKA = np.append(np.nan_to_num(PKA_SIDECHAIN_ARR, nan=0.0),
                 [PKA_POSITIVE["Nterm"], PKA_NEGATIVE["Cterm"]])
_SIGN = np.append(PKA_SIGN_ARR, [1, -1])


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> tuple[torch.Tensor, ...]:
    """pKa, sign, MW and ext280 tables on ``device``, copied there once."""
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in (_PKA, _SIGN, MW_ARR, EXT280_ARR))


def counts_from_codes(codes: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """(..., L) integer codes -> (..., 20) float32 per-class counts (masked)."""
    onehot = F.one_hot(codes.long(), 20).to(torch.float32)
    if mask is not None:
        onehot = onehot * mask[..., None]
    return onehot.sum(dim=-2)


def _charge(signed_counts, pka, sign, ph):
    """Net charge at pH ``ph`` (B, K) of (B, 22) sign-weighted group counts
    -> (B, K)."""
    return (signed_counts[:, None, :]
            / (1.0 + 10.0 ** (sign * (ph[..., None] - pka)))).sum(dim=-1)


_GRID = 64  # points per round of the pI search
_ROUNDS = 10  # 64**10 == 2**60


def batched_metrics_from_counts(counts: torch.Tensor, ph: float = 7.4) -> dict[str, torch.Tensor]:
    """(B, 20) counts -> dict of (B,) metrics: charge, pI, MW, ext280."""
    pka, sign, mw, ext = _tables(counts.device)
    B = counts.shape[0]
    signed = torch.cat([counts, counts.new_ones((B, 2))], dim=1) * sign
    charge = _charge(signed, pka, sign, counts.new_full((B, 1), ph))[:, 0]
    # charge falls with pH; keep the bracket (lo, lo + width] around its root.
    # A root past pH 14 (a sequence of arginines) reads as 14, the top of the
    # JAX package's bisection bracket
    steps = torch.arange(1, _GRID + 1, device=counts.device, dtype=counts.dtype) / _GRID
    lo, width = counts.new_zeros((B, 1)), 14.0
    for _ in range(_ROUNDS):
        positive = _charge(signed, pka, sign, lo + width * steps) > 0
        lo = lo + width * positive.sum(dim=-1, keepdim=True) / _GRID
        width /= _GRID
    return {
        "charge": charge,
        "isoelectric_point": (lo + width / 2).clamp(max=14.0)[:, 0],
        "molecular_weight": counts @ mw + WATER_MASS,
        "molar_extinction_280": counts @ ext,
    }


def sequence_metrics(seq: str, ph: float = 7.4) -> tuple[float, float, float, float]:
    """One sequence -> (charge, pI, MW, ext280). Letters outside the 20-AA
    alphabet are skipped; an all-unknown or empty sequence gives NaNs."""
    known = [AA1_TO_INT[c] for c in seq if c in AA1_TO_INT]
    if not known:
        return (float("nan"),) * 4
    counts = counts_from_codes(torch.tensor([known]))
    m = batched_metrics_from_counts(counts, ph=ph)
    return tuple(float(m[k][0]) for k in (
        "charge", "isoelectric_point", "molecular_weight", "molar_extinction_280"))


# The names of the reference's ampal functions, one metric each.
def sequence_charge(seq: str, ph: float = 7.4) -> float:
    return sequence_metrics(seq, ph)[0]


def sequence_isoelectric_point(seq: str) -> float:
    return sequence_metrics(seq)[1]


def sequence_molecular_weight(seq: str) -> float:
    return sequence_metrics(seq)[2]


def sequence_molar_extinction_280(seq: str) -> float:
    return sequence_metrics(seq)[3]


def calculate_seq_metrics(seq: str) -> tuple[float, float, float, float]:
    """(charge, pI, MW, ext280), as ``sequence_metrics``."""
    return sequence_metrics(seq)
