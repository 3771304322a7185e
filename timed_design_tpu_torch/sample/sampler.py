"""Monte-Carlo sequence sampling on the device.

The port of ``apply_temperature``, ``sample_sequences_with_metrics`` and
``sample_structure`` (timed_design_tpu/sample/sampler.py). From the
tempered probabilities to per-sample codes and residue counts is one call of
``ops.sample.sample_inverse_cdf``: on a CUDA device one launch of its kernel
(CDF, draws, rotamer -> amino-acid map and counts) at every length, on the
CPU its plain version on the same Philox uniforms. Draws are a pure
function of (seed, shape). ``sample_all_structures`` (the ``td-sample``
path) is not ported yet.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import AA1, ROTAMER_TO_AA
from ..engine.predictor import default_device
from ..ops.sample import sample_inverse_cdf
from .metrics import batched_metrics_from_counts

_AA_ASCII = np.frombuffer("".join(AA1).encode("ascii"), np.uint8)
_METRICS = ("charge", "isoelectric_point", "molecular_weight", "molar_extinction_280")


@functools.lru_cache(maxsize=None)
def _rotamer_to_aa(device: torch.device) -> torch.Tensor:
    """The (338,) uint8 rotamer -> amino-acid table on ``device``, copied once."""
    return torch.as_tensor(ROTAMER_TO_AA.astype(np.uint8), device=device)


def apply_temperature(probs: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """``probs ** (1/T)`` renormalized row-wise (the reference's power form,
    not logit scaling). T=0 is the one-hot of the row's argmax."""
    p = torch.as_tensor(probs)
    if temperature == 0:
        return torch.eye(p.shape[-1], dtype=p.dtype, device=p.device)[p.argmax(dim=-1)]
    # rescale by the row max first: the same after renormalization, but
    # immune to the underflow of p ** (1/T) at low T
    p = p / p.amax(dim=-1, keepdim=True)
    p = p ** (1.0 / temperature)
    return p / p.sum(dim=-1, keepdim=True)


def sample_sequences_with_metrics(
    probs: torch.Tensor,
    n_samples: int,
    seed: int,
    rotamer_mode: bool = False,
    ph: float = 7.4,
):
    """Draws + rotamer->residue collapse + metrics, on ``probs``' device.

    ``probs``: (L, C) float32 tensor. Returns (codes (n_samples, L) uint8
    amino-acid indices, dict of (n_samples,) metrics)."""
    class_map = _rotamer_to_aa(probs.device) if rotamer_mode else None
    codes, counts = sample_inverse_cdf(probs, n_samples, seed, class_map)
    return codes, batched_metrics_from_counts(counts.float(), ph=ph)


def sample_structure(
    probs,
    n_samples: int,
    seed: int,
    rotamer_mode: bool = False,
    temperature: float = 1.0,
    device: torch.device | str | None = None,
) -> list[tuple]:
    """Sample one structure -> [(seq, charge, pI, MW, ext), ...].

    ``probs``: (L, C) numpy array or tensor; sampling runs on ``device``
    (default: a tensor's own device; for numpy, the CUDA device)."""
    if device is None and not isinstance(probs, torch.Tensor):
        device = default_device()
    p = torch.as_tensor(probs, dtype=torch.float32, device=device)
    if temperature != 1.0:
        p = apply_temperature(p, temperature)
    codes, metrics = sample_sequences_with_metrics(p, n_samples, seed, rotamer_mode)
    ascii_rows = _AA_ASCII[codes.cpu().numpy()]
    m = torch.stack([metrics[k] for k in _METRICS], dim=1).cpu().numpy()
    return [
        (ascii_rows[i].tobytes().decode("ascii"), *map(float, m[i]))
        for i in range(n_samples)
    ]
