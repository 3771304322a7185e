"""Monte-Carlo draws by inverse CDF: the CUDA kernel and its plain version.

``sample_inverse_cdf`` is the wrapper of ``csrc/sample_inverse_cdf.cu``, the
port of the TPU kernel ``timed_design_tpu/ops/pallas_sample.py``
(``pallas_sample_class_indices``) fused with what consumes its indices on
the serving path: from (L, C) probabilities to (n, L) codes and (n, 20)
residue counts in one launch. ``sample_inverse_cdf_batched`` is the same
kernel over B structures packed with no padding, one launch for all of
them (``td-sample``). For a CUDA tensor each launches the kernel or raises;
for a CPU tensor it runs its plain version (``sample_codes_plain``,
``sample_codes_plain_batched``) on the same uniforms (``philox_uniforms``,
``philox_uniforms_batched``), which gives the same codes and counts.

Uniforms: Philox4x32-10 (Salmon et al., SC'11) keyed on the 64-bit seed,
counter ``(position, sample, structure, 0)``; the top 24 bits of the first
output word give ``u = (x >> 8) * 2**-24``, exact in float32. The single
entry draws as structure 0.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._build import launch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
N_COUNTED = 20  # codes counted per sample: the 20 amino acids


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


def _uniforms(seed: int, n: int, pos: np.ndarray, structure: np.ndarray) -> np.ndarray:
    """(n, len(pos)) float32: the draw of counter (pos[j], s, structure[j], 0)."""
    s = np.arange(n, dtype=np.uint64)[:, None]
    zero = np.zeros((), np.uint64)
    x0 = philox4x32_10((pos.astype(np.uint64)[None, :], s, structure.astype(np.uint64)[None, :],
                        zero), _seed_key(seed))[0]
    x0 = np.broadcast_to(x0, (n, pos.shape[0]))
    return (x0 >> np.uint64(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))


def philox_uniforms(seed: int, n: int, L: int, structure: int = 0) -> np.ndarray:
    """(n, L) float32 uniforms in [0, 1): the kernel's draw for (s, l) of
    ``structure``."""
    return _uniforms(seed, n, np.arange(L), np.full(L, structure))


def philox_uniforms_batched(seed: int, n: int, offsets) -> np.ndarray:
    """(n, sum L) float32: structure b's columns ``offsets[b]:offsets[b+1]``
    hold ``philox_uniforms(seed, n, L_b, b)``."""
    offs = np.asarray(offsets, np.int64)
    which = np.repeat(np.arange(offs.shape[0] - 1), np.diff(offs))
    return _uniforms(seed, n, np.arange(offs[-1]) - offs[which], which)


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


def sample_codes_plain_batched(
    probs: torch.Tensor, offsets, u: torch.Tensor, class_map: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The batched kernel's function in plain PyTorch: ``sample_codes_plain``
    on each structure's rows and uniforms.

    ``probs``: (sum L, C) float32, B structures packed; ``offsets``: (B+1,)
    ints where each starts; ``u``: (n, sum L) float32. Returns (codes (n,
    sum L), structure b at columns ``offsets[b]:offsets[b+1]``; counts (B,
    n, 20) int32).
    """
    offs = _host_offsets(offsets, probs.shape[0])
    n = u.shape[0]
    codes = torch.empty((n, probs.shape[0]), dtype=code_dtype(probs.shape[1], class_map),
                        device=probs.device)
    counts = torch.empty((offs.shape[0] - 1, n, N_COUNTED), dtype=torch.int32,
                         device=probs.device)
    for b, (a, e) in enumerate(zip(offs[:-1].tolist(), offs[1:].tolist())):
        codes[:, a:e], counts[b] = sample_codes_plain(probs[a:e], u[:, a:e], class_map)
    return codes, counts


def _host_offsets(offsets, total: int) -> np.ndarray:
    """(B+1,) int64 offsets of B structures packed in ``total`` rows,
    checked: they start at 0, never fall, and end at ``total``."""
    if isinstance(offsets, torch.Tensor):
        offsets = offsets.cpu().numpy()
    offs = np.asarray(offsets)
    if (offs.ndim != 1 or offs.shape[0] < 1 or not np.issubdtype(offs.dtype, np.integer)
            or offs[0] != 0 or offs[-1] != total or (np.diff(offs) < 0).any()):
        raise ValueError(f"offsets must be (B+1,) integers from 0 to {total}, never falling; "
                         f"got {offsets!r}")
    return offs.astype(np.int64)


def _check(probs: torch.Tensor, n_samples: int,
           class_map: torch.Tensor | None) -> tuple[int, int]:
    """(n, rows of the kernel's tile; 0 on the CPU), or raises on what the
    kernel does not take."""
    if probs.ndim != 2 or probs.dtype != torch.float32:
        raise ValueError(f"probs must be (L, C) float32, got {tuple(probs.shape)} {probs.dtype}")
    C = probs.shape[1]
    n = int(n_samples)
    if n < 0 or C < 1:
        raise ValueError(f"need n_samples >= 0 and C >= 1, got {n}, {C}")
    if class_map is not None and (class_map.shape != (C,) or class_map.dtype != torch.uint8
                                  or class_map.device != probs.device):
        raise ValueError(f"class_map must be ({C},) uint8 on {probs.device}")
    if probs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no sampling kernel for device {probs.device}")
    if probs.device.type == "cpu":
        return n, 0
    if n >= 2**31:
        raise ValueError(f"n={n} exceeds the kernel's grid")
    rows = _tile_rows(C, _device_index(probs.device))
    if rows == 0:
        raise ValueError(
            f"C={C} classes exceed the sampling kernel's limit of "
            f"{max_classes(probs.device)} on this card: a block holds at least one "
            "float64 row of the CDF in its shared memory")
    return n, rows


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
    n, rows = _check(probs, n_samples, class_map)
    L, C = probs.shape
    if probs.device.type == "cpu":
        u = torch.from_numpy(philox_uniforms(seed, n, L))
        return sample_codes_plain(probs, u, class_map)
    if -(-L // rows) > 65535:
        raise ValueError(f"L={L} exceeds the kernel's grid at {rows} row(s) a block")
    codes = torch.empty((n, L), dtype=code_dtype(C, class_map), device=probs.device)
    counts = torch.empty((n, N_COUNTED), dtype=torch.int32, device=probs.device)
    if n == 0 or L == 0:
        return codes, counts.zero_()
    probs = probs.contiguous()
    key0, key1 = _seed_key(seed)
    launch(probs.device.index, "sample_inverse_cdf", lambda sms, stream: (
        _lib().sample_inverse_cdf(
            probs.data_ptr(), _ptr(class_map), codes.data_ptr(), counts.data_ptr(), L, C, n,
            codes.element_size(), rows, key0, key1, sms, stream)))
    sample_inverse_cdf.launches += 1
    return codes, counts


sample_inverse_cdf.launches = 0


def sample_inverse_cdf_batched(
    probs: torch.Tensor, offsets, n_samples: int, seed: int,
    class_map: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes (n_samples, sum L), counts (B, n_samples, 20) int32) drawn from
    B structures in one launch.

    ``probs``: (sum L, C) float32, every structure's rows packed with no
    padding. ``offsets``: (B+1,) integers where each structure starts
    (``offsets[0] = 0``, ``offsets[B] = sum L``), read on the host (a
    sequence, an array or a tensor) and checked before any launch.
    Structure b's codes are the columns ``offsets[b]:offsets[b+1]``, and its
    draws are those of counter (l, s, b, 0): structure 0 draws what
    ``sample_inverse_cdf`` draws. On a CUDA tensor this launches the kernel
    once, whatever B is, and adds one to
    ``sample_inverse_cdf_batched.launches``; on a CPU tensor it runs
    ``sample_codes_plain_batched`` on the same uniforms.
    """
    n, rows = _check(probs, n_samples, class_map)
    offs = _host_offsets(offsets, probs.shape[0])
    if probs.device.type == "cpu":
        u = torch.from_numpy(philox_uniforms_batched(seed, n, offs))
        return sample_codes_plain_batched(probs, offs, u, class_map)
    dev_offsets = torch.from_numpy(offs.astype(np.int32)).to(probs.device)
    return _launch_batched(probs, dev_offsets, n, seed, class_map, rows)


sample_inverse_cdf_batched.launches = 0


def _launch_batched(
    probs: torch.Tensor, dev_offsets: torch.Tensor, n: int, seed: int,
    class_map: torch.Tensor | None, rows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The batched kernel's launch on CUDA ``probs``, given (B+1,) int32
    ``dev_offsets`` on its device that ``_host_offsets`` has checked, and
    the tile's rows from ``_check``; the kernel sizes its grid from
    ``probs``' rows and indexes by the offsets, so unchecked offsets would
    read and write out of bounds."""
    total, C = probs.shape
    B = dev_offsets.shape[0] - 1
    if B + -(-total // rows) > 65535:
        raise ValueError(f"B={B} structures of {total} rows exceed the kernel's grid")
    codes = torch.empty((n, total), dtype=code_dtype(C, class_map), device=probs.device)
    counts = torch.empty((B, n, N_COUNTED), dtype=torch.int32, device=probs.device)
    if n == 0 or total == 0:
        return codes, counts.zero_()
    probs, dev_offsets = probs.contiguous(), dev_offsets.contiguous()
    key0, key1 = _seed_key(seed)
    launch(probs.device.index, "sample_inverse_cdf", lambda sms, stream: (
        _lib().sample_inverse_cdf_batched(
            probs.data_ptr(), dev_offsets.data_ptr(), B, _ptr(class_map), codes.data_ptr(),
            counts.data_ptr(), total, C, n, codes.element_size(), rows, key0, key1, sms,
            stream)))
    sample_inverse_cdf_batched.launches += 1
    return codes, counts


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _device_index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


@functools.cache
def _smem_optin(device: int) -> int:
    """Bytes of shared memory a block of ``device`` may opt into."""
    optin = _lib().sample_inverse_cdf_smem_optin(device)
    if optin < 0:
        raise RuntimeError(f"cannot read the shared memory of CUDA device {device}")
    return optin


@functools.cache
def _tile_rows(C: int, device: int) -> int:
    """Rows of the kernel's tile for C classes on ``device``: 16 while they
    fit in a block's shared memory, fewer as C grows, 0 past the limit."""
    return _lib().sample_inverse_cdf_tile_rows(C, _smem_optin(device))


def max_classes(device: torch.device | str = "cuda") -> int:
    """The largest C the kernel takes on the CUDA ``device``: one float64
    row of the CDF, the counts and the class map in a block's shared memory
    (25,257 on an H100)."""
    dev = _device_index(torch.device(device))
    lo, hi = 1, _smem_optin(dev) // 8  # _tile_rows(lo) >= 1 > _tile_rows(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if _tile_rows(mid, dev) else (lo, mid)
    return lo


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, its functions' argument types set once."""
    from ._build import load

    lib = load("sample_inverse_cdf")
    lib.sample_inverse_cdf.restype = ctypes.c_int
    lib.sample_inverse_cdf.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.sample_inverse_cdf_batched.restype = ctypes.c_int
    lib.sample_inverse_cdf_batched.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.sample_inverse_cdf_smem_optin.restype = ctypes.c_int
    lib.sample_inverse_cdf_smem_optin.argtypes = [ctypes.c_int]
    lib.sample_inverse_cdf_tile_rows.restype = ctypes.c_int
    lib.sample_inverse_cdf_tile_rows.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib
