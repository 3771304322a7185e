"""Monte-Carlo draws by inverse CDF: the CUDA kernel and its plain version.

``sample_inverse_cdf`` is the wrapper of ``csrc/sample_inverse_cdf.cu``, the
port of the TPU kernel ``timed_design_tpu/ops/pallas_sample.py``
(``pallas_sample_class_indices``) fused with what consumes its indices on
the serving path: from (L, C) probabilities to (n, L) codes and (n, 20)
residue counts in one launch. For a CUDA tensor it launches the kernel or
raises; for a CPU tensor it runs ``sample_codes_plain`` on the same
uniforms (``philox_uniforms``), which gives the same codes and counts.

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
N_COUNTED = 20  # codes counted per sample: the 20 amino acids
_TILE_L = 16  # positions per block; kTileL in the CUDA source
_SMEM_LIMIT = 48 * 1024  # a block's shared memory without raising its limit


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


def code_dtype(C: int, class_map: torch.Tensor | None) -> torch.dtype:
    """uint8 when every code fits (a map, or C <= 256); else int16."""
    return torch.uint8 if class_map is not None or C <= 256 else torch.int16


def sample_class_indices_plain(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(n, L) int32 indices: the count of CDF entries <= u, 0 where the
    count reaches C (u past the row's mass). ``cdf``: (L, C); ``u``: (n, L).
    """
    count = (cdf[None, :, :] <= u[:, :, None]).sum(-1, dtype=torch.int32)
    return torch.where(count >= cdf.shape[-1], 0, count)


def sample_codes_plain(
    probs: torch.Tensor, u: torch.Tensor, class_map: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, given the uniforms.

    ``probs``: (L, C) float32; ``u``: (n, L) float32; ``class_map``: (C,)
    codes or None. Returns (codes (n, L) in ``code_dtype``, counts (n, 20)
    int32 of the codes 0..19). The CDF is accumulated in float64 and rounded
    to float32, as torch.cumsum of float32 does on the CPU.
    """
    cdf = torch.cumsum(probs.to(torch.float64), dim=-1).to(torch.float32)
    idx = sample_class_indices_plain(cdf, u).long()
    codes = idx if class_map is None else class_map.to(idx.device).long()[idx]
    counted = codes < N_COUNTED
    counts = torch.zeros((codes.shape[0], N_COUNTED), dtype=torch.int32, device=codes.device)
    counts.scatter_add_(1, torch.where(counted, codes, 0), counted.to(torch.int32))
    return codes.to(code_dtype(probs.shape[-1], class_map)), counts


def sample_inverse_cdf(
    probs: torch.Tensor, n_samples: int, seed: int, class_map: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes (n_samples, L), counts (n_samples, 20) int32) drawn from the
    rows of ``probs``.

    ``probs``: (L, C) float32, non-negative rows (temperature already
    applied). ``class_map``: optional (C,) uint8 table of codes < 20 on the
    same device, e.g. the rotamer -> amino-acid map. On a CUDA tensor this
    launches the kernel and adds one to ``sample_inverse_cdf.launches``; on
    a CPU tensor it runs ``sample_codes_plain`` on the same uniforms.
    """
    if probs.ndim != 2 or probs.dtype != torch.float32:
        raise ValueError(f"probs must be (L, C) float32, got {tuple(probs.shape)} {probs.dtype}")
    L, C = probs.shape
    n = int(n_samples)
    if n < 0 or C < 1:
        raise ValueError(f"need n_samples >= 0 and C >= 1, got {n}, {C}")
    if class_map is not None and (class_map.shape != (C,) or class_map.dtype != torch.uint8
                                  or class_map.device != probs.device):
        raise ValueError(f"class_map must be ({C},) uint8 on {probs.device}")
    if probs.device.type == "cpu":
        u = torch.from_numpy(philox_uniforms(seed, n, L))
        return sample_codes_plain(probs, u, class_map)
    if probs.device.type != "cuda":
        raise ValueError(f"no sampling kernel for device {probs.device}")
    if _smem_bytes(C) > _SMEM_LIMIT:
        raise ValueError(f"C={C} classes exceed the kernel's 48 KB shared-memory tile")
    if n >= 2**31 or -(-L // _TILE_L) > 65535:
        raise ValueError(f"shape (n={n}, L={L}) exceeds the kernel's grid")
    codes = torch.empty((n, L), dtype=code_dtype(C, class_map), device=probs.device)
    counts = torch.empty((n, N_COUNTED), dtype=torch.int32, device=probs.device)
    if n == 0 or L == 0:
        return codes, counts.zero_()
    if not probs.is_contiguous():
        probs = probs.contiguous()
    key0, key1 = _seed_key(seed)
    dev = probs.device.index
    if dev == torch.cuda.current_device():
        err = _launch(dev, probs, class_map, codes, counts, key0, key1)
    else:
        with torch.cuda.device(dev):
            err = _launch(dev, probs, class_map, codes, counts, key0, key1)
    if err != 0:
        raise RuntimeError(f"sample_inverse_cdf launch failed: CUDA error {err}")
    sample_inverse_cdf.launches += 1
    return codes, counts


sample_inverse_cdf.launches = 0


def _launch(dev, probs, class_map, codes, counts, key0, key1) -> int:
    (n, L), C = codes.shape, probs.shape[1]
    return _lib().sample_inverse_cdf(
        probs.data_ptr(), None if class_map is None else class_map.data_ptr(),
        codes.data_ptr(), counts.data_ptr(), L, C, n, codes.element_size(), key0, key1,
        _num_sms(dev), torch.cuda.current_stream().cuda_stream,
    )


@functools.cache
def _num_sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _smem_bytes(C: int) -> int:
    return _lib().sample_inverse_cdf_smem_bytes(C)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, its functions' argument types set once."""
    from ._build import load

    lib = load("sample_inverse_cdf")
    lib.sample_inverse_cdf.restype = ctypes.c_int
    lib.sample_inverse_cdf.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.sample_inverse_cdf_smem_bytes.restype = ctypes.c_int
    lib.sample_inverse_cdf_smem_bytes.argtypes = [ctypes.c_int]
    return lib
