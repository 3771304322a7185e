"""Int8 3D convolution with int32 accumulation, and its rescale, bias and
cast fused into the same launch: the CUDA kernel and its plain version.

``conv3d_int8`` is the wrapper of ``csrc/conv3d_int8.cu``, the card's
counterpart of the integer convolution of the JAX package's ``int8``
quantize mode (``timed_design_tpu/models/quantize.py``, XLA's
``conv_general_dilated`` on int8 operands with int32 accumulation, then
``(acc.astype(f32) * scale).astype(dtype)`` and the bias). Codes are
channels last: ``xq`` (B, D, H, W, C) int8, ``wq`` (N, k, k, k, C) int8, the
output (B, D', H', W', N), stride 1, ``padding`` 0 ('valid') or (k - 1) / 2
('same'). Without ``scale`` it is the int32 sums; with an (N,) float32
``scale`` and ``out_dtype`` float32, bfloat16 or float16 it is
``acc.to(float32).mul_(scale).to(out_dtype)``, plus ``bias`` (N,) in
``out_dtype`` when given, bit for bit. For a CUDA tensor it launches the
kernel or raises; for a CPU tensor it runs ``conv3d_int8_plain``, which gives
the same values.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

_ACC_LIMIT = 2 ** 31  # every |sum| <= k^3 C 127^2 must fit an int32
_PLAIN_TAPS = 2 ** 27  # unfolded float64 taps per chunk of the plain version
# the output dtypes the kernel's epilogue writes, and the code it takes for each
OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_OUT_KIND = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}
# the output-channel widths the kernel is instantiated for (csrc/conv3d_int8.cu)
TILE_WIDTHS = (16, 24, 32, 48, 64, 128, 176)
_SLICE = 128  # bytes of K the kernel copies per stage


def conv3d_int8_plain(xq: torch.Tensor, wq: torch.Tensor, padding: int = 0,
                      scale: torch.Tensor | None = None, bias: torch.Tensor | None = None,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``F.conv3d`` in float64 on
    the codes, cast to int32. Exact: every product and partial sum is an
    integer below 2^31, far inside float64's 2^53. Frames go through in
    chunks of at most ``_PLAIN_TAPS`` unfolded taps (1 GiB of float64), or
    one frame, since the CPU's float64 convolution unfolds its input (k^3 C
    values per output position). With ``scale``, the sums then go through
    ``.to(float32).mul_(scale).to(out_dtype)`` and ``+ bias``: the PyTorch
    epilogue the kernel fuses (``out_dtype`` None: float32)."""
    k = wq.shape[1]
    per_frame = k ** 3 * wq.shape[-1] * math.prod(s + 2 * padding - k + 1 for s in xq.shape[1:4])
    step = max(1, _PLAIN_TAPS // per_frame)
    w = wq.permute(0, 4, 1, 2, 3).to(torch.float64)
    out = [F.conv3d(xq[i:i + step].permute(0, 4, 1, 2, 3).to(torch.float64), w, padding=padding)
           .permute(0, 2, 3, 4, 1).to(torch.int32) for i in range(0, xq.shape[0], step)]
    acc = torch.cat(out).contiguous()
    if scale is None:
        return acc
    out = acc.to(torch.float32).mul_(scale).to(out_dtype or torch.float32)
    return out if bias is None else out + bias


def padded_channels(C: int) -> int:
    """The channel count the kernel takes for C input channels: C when a
    multiple of 4 (its copies are then 4, 8 or 16 bytes), else the next
    multiple of 8 (5 -> 8)."""
    return C if C % 4 == 0 else -(-C // 8) * 8


def pad_channels(xq: torch.Tensor, wq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``xq`` and ``wq`` with zero codes appended to their channels up to
    ``padded_channels(C)``: zero inputs times zero weights, the same sums."""
    pad = padded_channels(xq.shape[-1]) - xq.shape[-1]
    if pad == 0:
        return xq, wq
    return F.pad(xq, (0, pad)), F.pad(wq, (0, pad))


def tile_n(N: int) -> tuple[int, int]:
    """(width, blocks) of the kernel's output-channel tiles for N channels:
    the fewest channels computed, then the fewest blocks (20 -> (24, 1),
    256 -> (128, 2), 338 -> (176, 2))."""
    return min(((w, -(-N // w)) for w in TILE_WIDTHS), key=lambda t: (t[0] * t[1], t[1]))


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


def _check_epilogue(device: torch.device, N: int, scale: torch.Tensor | None,
                    bias: torch.Tensor | None, out_dtype: torch.dtype | None) -> torch.dtype:
    """The output dtype of a call; raises on an epilogue the kernel does not
    write."""
    if scale is None:
        if bias is not None or out_dtype not in (None, torch.int32):
            raise ValueError("a bias or a floating-point out_dtype needs a scale; without one "
                             "the output is the int32 sums")
        return torch.int32
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {OUT_DTYPES} with a scale, got {out_dtype}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (N,) or scale.device != device:
        raise ValueError(f"scale must be ({N},) float32 on {device}; got {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}")
    if bias is not None and (bias.dtype != out_dtype or tuple(bias.shape) != (N,)
                             or bias.device != device):
        raise ValueError(f"bias must be ({N},) {out_dtype} on {device}; got {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device}")
    return out_dtype


def conv3d_int8(xq: torch.Tensor, wq: torch.Tensor, padding: int = 0,
                scale: torch.Tensor | None = None, bias: torch.Tensor | None = None,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The int8 convolution of ``xq`` (B, D, H, W, C) with ``wq`` (N, k, k,
    k, C), (B, D', H', W', N) with D' = D + 2 padding - k + 1: the int32
    sums, or with ``scale`` (N,) float32 the sums rescaled, cast to
    ``out_dtype`` (float32, bfloat16 or float16; None: float32) and plus
    ``bias`` (N,) in ``out_dtype`` when given.

    On a CUDA tensor this launches the kernel on the current stream and adds
    one to ``conv3d_int8.launches``; on a CPU tensor it runs
    ``conv3d_int8_plain``."""
    B, D, H, W, C, N, k = _check(xq, wq, padding)
    out_dtype = _check_epilogue(xq.device, N, scale, bias, out_dtype)
    if xq.device.type == "cpu":
        return conv3d_int8_plain(xq, wq, padding, scale, bias, out_dtype)
    xq, wq = pad_channels(xq.contiguous(), wq.contiguous())
    C = xq.shape[-1]
    bn, blocks = tile_n(N)
    K = k ** 3 * C
    Kp = -(-K // _SLICE) * _SLICE
    # the weights as (N, K) rows, zero past N and K up to the kernel's tiles
    w = torch.zeros((bn * blocks, Kp), dtype=torch.int8, device=xq.device)
    w[:N, :K] = wq.reshape(N, K)
    shape = (B, *(s + 2 * padding - k + 1 for s in (D, H, W)), N)
    out = torch.empty(shape, dtype=out_dtype, device=xq.device)
    scale = None if scale is None else scale.contiguous()
    bias = None if bias is None else bias.contiguous()
    with torch.cuda.device(xq.device):
        err = _lib().conv3d_int8(
            xq.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if scale is None else scale.data_ptr(), None if bias is None else bias.data_ptr(),
            _OUT_KIND[out_dtype], B, D, H, W, C, N, k, padding, bn, Kp,
            torch.cuda.current_stream().cuda_stream)
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
    lib.conv3d_int8.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    return lib
