"""Monte-Carlo sequence sampling on the device.

The port of ``apply_temperature``, ``sample_sequences_with_metrics``,
``sample_structure`` and ``sample_all_structures``
(timed_design_tpu/sample/sampler.py). From the tempered probabilities to
per-sample codes and residue counts is one call of
``ops.sample.sample_inverse_cdf`` (one structure, the serving path) or of
``sample_inverse_cdf_batched`` (every structure of a ``td-sample`` run): on a
CUDA device one launch of the kernel (CDF, draws, rotamer -> amino-acid map
and counts), on the CPU its plain version on the same Philox uniforms.
Draws are a pure function of (seed, structure index, sample, position).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import AA1, ROTAMER_TO_AA
from ..engine.predictor import default_device
from ..ops.sample import N_COUNTED, sample_inverse_cdf, sample_inverse_cdf_batched
from .metrics import batched_metrics_from_counts

_AA_ASCII = np.frombuffer("".join(AA1).encode("ascii"), np.uint8)
_METRICS = ("charge", "isoelectric_point", "molecular_weight", "molar_extinction_280")


@functools.lru_cache(maxsize=None)
def _rotamer_to_aa(device: torch.device) -> torch.Tensor:
    """The (338,) uint8 rotamer -> amino-acid table on ``device``, copied once."""
    return torch.as_tensor(ROTAMER_TO_AA.astype(np.uint8), device=device)


def apply_temperature(probs, temperature: float = 1.0):
    """``probs ** (1/T)`` renormalized row-wise (the reference's power form,
    not logit scaling). T=0 is the one-hot of the row's argmax.

    A numpy array is scaled with numpy, in its own dtype (``td-sample``
    scales the float64 matrix, bit for bit as the JAX package does); anything
    else as a tensor, on its device."""
    if isinstance(probs, np.ndarray):
        if temperature == 0:
            return np.eye(probs.shape[-1], dtype=probs.dtype)[probs.argmax(axis=-1)]
        p = probs / probs.max(axis=-1, keepdims=True)
        p = p ** (1.0 / temperature)
        return p / p.sum(axis=-1, keepdims=True)
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


def sample_all_structures(
    pdb_to_probability: dict[str, np.ndarray],
    n_samples: int,
    seed: int = 42,
    rotamer_mode: bool = False,
    temperature: float = 1.0,
    device: torch.device | str | None = None,
) -> dict[str, list[tuple]]:
    """Sample every structure -> {pdb: [(seq, charge, pI, MW, ext), ...]},
    in the input's order.

    The JAX package zero-pads the structures into length buckets (its
    ``pad_to``) and runs one program per bucket. The port packs them with no
    padding, (sum L, C), and draws all of them in one launch of
    ``sample_inverse_cdf_batched`` on ``device`` (default: the CUDA
    device), so it has no ``pad_to``; a matrix has one class count, so there
    is one bucket. Structure b's draws are those of counter (l, s, b, 0):
    a sequence is a pure function of (seed, structure index, sample).
    ``temperature`` is applied on the host, in float32, per structure.
    """
    items = list(pdb_to_probability.items())
    if not items:
        return {}
    device = torch.device(device) if device is not None else default_device()
    arrays = []
    for _, probs in items:
        arr = np.asarray(probs, np.float32)
        if temperature != 1.0:
            arr = apply_temperature(arr, temperature)
        arrays.append(arr)
    if len({a.shape[1] for a in arrays}) != 1:
        raise ValueError("every structure needs the same class count, got "
                         f"{sorted({a.shape[1] for a in arrays})}")
    lengths = [a.shape[0] for a in arrays]
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    packed = torch.from_numpy(np.concatenate(arrays)).to(device)
    class_map = _rotamer_to_aa(device) if rotamer_mode else None
    codes, counts = sample_inverse_cdf_batched(packed, offsets, n_samples, seed, class_map)
    metrics = batched_metrics_from_counts(counts.reshape(-1, N_COUNTED).float())
    m = torch.stack([metrics[k] for k in _METRICS], dim=1).reshape(len(items), n_samples, 4)
    m = m.cpu().numpy()
    ascii_mat = _AA_ASCII[codes.cpu().numpy()]  # (n, sum L): every sequence at once
    out: dict[str, list[tuple]] = {}
    for b, ((pdb, _), start, length) in enumerate(zip(items, offsets[:-1], lengths)):
        rows = np.ascontiguousarray(ascii_mat[:, start:start + length]).tobytes()
        out[pdb] = [
            (rows[s * length:(s + 1) * length].decode("ascii"), *map(float, m[b, s]))
            for s in range(n_samples)
        ]
    return out
