"""Seeded protein backbones as PDB text: copies of ubiquitin's chain
(``data/1ubq_chain.pdb``, 76 residues) laid side by side 50 A apart along
x, chains A, B, ..., every atom moved by Gaussian noise, the last chain cut
to the length asked for. The same seed gives the same text."""
from __future__ import annotations

from pathlib import Path

import numpy as np

CHAIN = Path(__file__).resolve().parent / "data" / "1ubq_chain.pdb"
RESIDUES_PER_CHAIN = 76


def chain_atoms() -> tuple[list[str], np.ndarray, np.ndarray]:
    """The chain's ATOM lines, their coordinates (A, 3) and residue numbers."""
    lines = [l for l in CHAIN.read_text().splitlines() if l.startswith("ATOM")]
    xyz = np.array([[float(l[30:38]), float(l[38:46]), float(l[46:54])] for l in lines])
    return lines, xyz, np.array([int(l[22:26]) for l in lines])


def backbone_text(rng: np.random.Generator, length: int, noise: float = 0.2,
                  spacing: float = 50.0, chain=None) -> str:
    """PDB text of ``length`` residues: whole copies of the chain, then the
    first residues of one more, each copy ``spacing`` A further along x,
    with N(0, ``noise``^2) added to every coordinate, drawn from ``rng``."""
    lines, xyz, resnum = chain or chain_atoms()
    out = []
    for k in range(-(-length // RESIDUES_PER_CHAIN)):
        keep = resnum <= length - k * RESIDUES_PER_CHAIN
        moved = xyz[keep] + rng.normal(0.0, noise, (int(keep.sum()), 3))
        moved[:, 0] += spacing * k
        cid = chr(ord("A") + k)
        out += [f"{l[:21]}{cid}{l[22:30]}{x:8.3f}{y:8.3f}{z:8.3f}{l[54:]}"
                for l, (x, y, z) in zip((l for l, f in zip(lines, keep) if f), moved)]
        out.append("TER")
    return "\n".join(out + ["END"]) + "\n"


def balanced(rng: np.random.Generator, values, n: int) -> np.ndarray:
    """``n`` values cycling through ``values``, in an order drawn from
    ``rng``: every seed gets the same multiset."""
    values = np.asarray(values)
    return rng.permutation(np.resize(values, n))


def lognormal_lengths(rng: np.random.Generator, n: int, median: float, sigma: float,
                      lo: int, hi: int) -> np.ndarray:
    """``n`` lengths at the mid-quantiles of a log-normal law (``median``,
    ``sigma``), clipped to [lo, hi], in an order drawn from ``rng``: every
    seed gets the same multiset of sizes."""
    from statistics import NormalDist

    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    lengths = np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(int)
    return rng.permutation(lengths)


def exponential_gaps(rng: np.random.Generator, n: int, rate: float) -> np.ndarray:
    """``n`` gaps (s) at the mid-quantiles of an exponential law of ``rate``
    per second, in an order drawn from ``rng``: Poisson arrivals whose gaps
    are the same multiset for every seed."""
    q = (np.arange(n) + 0.5) / n
    return rng.permutation(-np.log1p(-q) / rate)
