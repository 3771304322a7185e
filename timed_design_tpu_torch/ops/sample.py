"""Categorical sampling by inverse CDF: the CUDA kernel and its plain version.

``sample_inverse_cdf`` is the wrapper of ``csrc/sample_inverse_cdf.cu``, the
port of the TPU kernel ``timed_design_tpu/ops/pallas_sample.py``
(``pallas_sample_class_indices``). For a CUDA tensor it launches the kernel
or raises; for a CPU tensor it runs the plain version below, which draws the
same uniforms (``philox_uniforms``) and so gives the same indices.

Uniforms: Philox4x32-10 (Salmon et al., SC'11) keyed on the 64-bit seed,
counter ``(position, sample, 0, 0)``; the top 24 bits of the first output
word give ``u = (x >> 8) * 2**-24``, exact in float32.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_TILE_L = 32  # positions per block; must match kTileL in the CUDA source
_TILE_SMEM = 48 * 1024  # a block's shared memory without raising its limit


def _seed_key(seed: int) -> tuple[int, int]:
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return s & _MASK32, s >> 32


def philox4x32_10(counter, key) -> tuple[np.ndarray, ...]:
    """Philox4x32-10 on numpy ``uint64`` arrays that hold 32-bit words.

    ``counter``: four word arrays (broadcastable); ``key``: two words.
    Products of two 32-bit words fit in 64 bits, so nothing overflows.
    """
    c0, c1, c2, c3 = (np.asarray(c, np.uint64) for c in counter)
    k0, k1 = (np.uint64(k) for k in key)
    m = np.uint64(_MASK32)
    s32 = np.uint64(32)
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(_W0)) & m
            k1 = (k1 + np.uint64(_W1)) & m
        p0 = c0 * np.uint64(_M0)
        p1 = c2 * np.uint64(_M1)
        c0, c1, c2, c3 = (p1 >> s32) ^ c1 ^ k0, p1 & m, (p0 >> s32) ^ c3 ^ k1, p0 & m
    return c0, c1, c2, c3


def philox_uniforms(seed: int, n: int, L: int) -> np.ndarray:
    """(n, L) float32 uniforms in [0, 1): the kernel's draw for (s, l)."""
    s = np.arange(n, dtype=np.uint64)[:, None]
    pos = np.arange(L, dtype=np.uint64)[None, :]
    zero = np.zeros((), np.uint64)
    x0 = philox4x32_10((pos, s, zero, zero), _seed_key(seed))[0]
    x0 = np.broadcast_to(x0, (n, L))
    return (x0 >> np.uint64(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))


def sample_class_indices_plain(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(n, L) int32 indices: the count of CDF entries <= u, 0 where the
    count reaches C (u past the row's mass). ``cdf``: (L, C); ``u``: (n, L).
    """
    count = (cdf[None, :, :] <= u[:, :, None]).sum(-1, dtype=torch.int32)
    return torch.where(count >= cdf.shape[-1], 0, count)


def sample_inverse_cdf(cdf: torch.Tensor, n_samples: int, seed: int) -> torch.Tensor:
    """(n_samples, L) int32 class indices drawn from the rows of ``cdf``.

    ``cdf``: (L, C) float32, each row non-decreasing (a cumulative sum of
    non-negative probabilities). On a CUDA tensor this launches the kernel
    and adds one to ``sample_inverse_cdf.launches``; on a CPU tensor it runs
    the plain version on the same uniforms.
    """
    if cdf.ndim != 2 or cdf.dtype != torch.float32:
        raise ValueError(f"cdf must be (L, C) float32, got {tuple(cdf.shape)} {cdf.dtype}")
    L, C = cdf.shape
    n = int(n_samples)
    if n < 0 or C < 1:
        raise ValueError(f"need n_samples >= 0 and C >= 1, got {n}, {C}")
    if cdf.device.type == "cpu":
        u = torch.from_numpy(philox_uniforms(seed, n, L))
        return sample_class_indices_plain(cdf, u)
    if cdf.device.type != "cuda":
        raise ValueError(f"no sampling kernel for device {cdf.device}")
    if _TILE_L * C * 4 > _TILE_SMEM:
        raise ValueError(f"C={C} classes exceed the kernel's 48 KB shared-memory tile")
    if n >= 2**31 or -(-L // _TILE_L) > 65535:
        raise ValueError(f"shape (n={n}, L={L}) exceeds the kernel's grid")
    out = torch.empty((n, L), dtype=torch.int32, device=cdf.device)
    if n == 0 or L == 0:
        return out
    cdf = cdf.contiguous()
    key0, key1 = _seed_key(seed)
    with torch.cuda.device(cdf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            cdf.data_ptr(), out.data_ptr(), L, C, n, key0, key1, stream
        )
    if err != 0:
        raise RuntimeError(f"sample_inverse_cdf launch failed: CUDA error {err}")
    sample_inverse_cdf.launches += 1
    return out


sample_inverse_cdf.launches = 0


@functools.cache
def _kernel():
    from ._build import load

    fn = load("sample_inverse_cdf").sample_inverse_cdf
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p,
    ]
    return fn


def sample_class_indices(probs: torch.Tensor, n_samples: int, seed: int) -> torch.Tensor:
    """(n_samples, L) int32 draws from (L, C) probabilities: the CDF is one
    cumulative sum on the tensor's device, then ``sample_inverse_cdf``."""
    cdf = torch.cumsum(probs.to(torch.float32), dim=-1).contiguous()
    return sample_inverse_cdf(cdf, n_samples, seed)
