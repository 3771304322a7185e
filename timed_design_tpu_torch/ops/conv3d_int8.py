"""Int8 3D convolution with int32 accumulation: the CUDA kernel and its
plain version.

``conv3d_int8`` is the wrapper of ``csrc/conv3d_int8.cu``, the card's
counterpart of the integer convolution of the JAX package's ``int8``
quantize mode (``timed_design_tpu/models/quantize.py``, XLA's
``conv_general_dilated`` on int8 operands with int32 accumulation). Codes
are channels last: ``xq`` (B, D, H, W, C) int8, ``wq`` (N, k, k, k, C) int8,
the sums (B, D', H', W', N) int32, stride 1, ``padding`` 0 ('valid') or
(k - 1) / 2 ('same'). For a CUDA tensor it launches the kernel or raises;
for a CPU tensor it runs ``conv3d_int8_plain``, which gives the same sums.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

_ACC_LIMIT = 2 ** 31  # every |sum| <= k^3 C 127^2 must fit an int32
_PLAIN_TAPS = 2 ** 27  # unfolded float64 taps per chunk of the plain version


def conv3d_int8_plain(xq: torch.Tensor, wq: torch.Tensor, padding: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``F.conv3d`` in float64 on
    the codes, cast to int32. Exact: every product and partial sum is an
    integer below 2^31, far inside float64's 2^53. Frames go through in
    chunks of at most ``_PLAIN_TAPS`` unfolded taps (1 GiB of float64), or
    one frame, since the CPU's float64 convolution unfolds its input (k^3 C
    values per output position)."""
    k = wq.shape[1]
    per_frame = k ** 3 * wq.shape[-1] * math.prod(s + 2 * padding - k + 1 for s in xq.shape[1:4])
    step = max(1, _PLAIN_TAPS // per_frame)
    w = wq.permute(0, 4, 1, 2, 3).to(torch.float64)
    out = [F.conv3d(xq[i:i + step].permute(0, 4, 1, 2, 3).to(torch.float64), w, padding=padding)
           .permute(0, 2, 3, 4, 1).to(torch.int32) for i in range(0, xq.shape[0], step)]
    return torch.cat(out).contiguous()


def _check(xq: torch.Tensor, wq: torch.Tensor, padding: int) -> tuple[int, ...]:
    """(B, D, H, W, C, N, k) of a convolution the kernel takes; raises on
    anything else."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or xq.ndim != 5 or wq.ndim != 5:
        raise ValueError(f"need int8 xq (B, D, H, W, C) and wq (N, k, k, k, C); got "
                         f"{xq.dtype} {tuple(xq.shape)} and {wq.dtype} {tuple(wq.shape)}")
    B, D, H, W, C = xq.shape
    N, k = wq.shape[0], wq.shape[1]
    if tuple(wq.shape[1:]) != (k, k, k, C):
        raise ValueError(f"wq must be (N, k, k, k, {C}), got {tuple(wq.shape)}")
    if padding not in (0, (k - 1) // 2) or (padding and k % 2 == 0):
        raise ValueError(f"padding must be 0 or (k - 1) / 2 for odd k; got {padding} for k={k}")
    if min(D, H, W) + 2 * padding < k or min(B, C, N) < 1:
        raise ValueError(f"empty convolution: xq {tuple(xq.shape)}, wq {tuple(wq.shape)}")
    if k ** 3 * C * 127 ** 2 >= _ACC_LIMIT:
        raise ValueError(f"k^3 C 127^2 = {k ** 3 * C * 127 ** 2} may overflow the int32 sums")
    if xq.device != wq.device or xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"xq and wq must lie on one CPU or CUDA device; got {xq.device}, "
                         f"{wq.device}")
    return B, D, H, W, C, N, k


def conv3d_int8(xq: torch.Tensor, wq: torch.Tensor, padding: int = 0) -> torch.Tensor:
    """(B, D', H', W', N) int32 sums of the int8 convolution of ``xq`` (B,
    D, H, W, C) with ``wq`` (N, k, k, k, C), D' = D + 2 padding - k + 1.

    On a CUDA tensor this launches the kernel on the current stream and adds
    one to ``conv3d_int8.launches``; on a CPU tensor it runs
    ``conv3d_int8_plain``."""
    B, D, H, W, C, N, k = _check(xq, wq, padding)
    if xq.device.type == "cpu":
        return conv3d_int8_plain(xq, wq, padding)
    xq, wq = xq.contiguous(), wq.contiguous()
    shape = (B, *(s + 2 * padding - k + 1 for s in (D, H, W)), N)
    out = torch.empty(shape, dtype=torch.int32, device=xq.device)
    with torch.cuda.device(xq.device):
        err = _lib().conv3d_int8(xq.data_ptr(), wq.data_ptr(), out.data_ptr(), B, D, H, W, C, N,
                                 k, padding, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3d_int8 launch failed: CUDA error {err}")
    conv3d_int8.launches += 1
    return out


conv3d_int8.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("conv3d_int8")
    lib.conv3d_int8.restype = ctypes.c_int
    lib.conv3d_int8.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib
