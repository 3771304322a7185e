"""DenseNet's dense blocks in evaluation: the CUDA kernels and their plain
versions.

Wrappers of ``csrc/dense_block.cu``, which replaces no TPU kernel (the JAX
package leaves these passes to XLA): they keep a DenseNet forward's
element-wise passes at one read and one write of what they touch, where
PyTorch operations cast, normalise, clamp, cast back and concatenate in
passes of their own (``models/densenet.py``). Tensors are channels last, a
row one voxel's channels:

- ``bn_relu``: evaluation-mode BatchNorm and ReLU of the first ``channels``
  channels of ``x`` (B, D, H, W, C_total), optionally after adding the
  bias of the convolution that produced ``x``; a new contiguous (B, D, H,
  W, channels) tensor in ``x``'s dtype or float32.
- ``bias_store``: ``h`` (B, D, H, W, N) plus a bias, stored into channels
  ``[channel, channel + N)`` of the block buffer ``out``.
- ``pool_bias_store``: the 2^3 average pool of ``h`` (edges floored) plus a
  bias, stored into channels ``[channel, channel + N)`` of ``out`` (B, D//2,
  H//2, W//2, C_total).

Storage is bfloat16 or float32 (``DTYPES``), arithmetic float32, each step
rounded on its own, as the plain versions (``*_plain``) compute it. For a
CPU tensor each wrapper runs its plain version; for a CUDA tensor it
launches the kernel, adds one to its ``launches``, or raises. The launch
picks the vector width from the shapes (8, 4, 2 or 1 values, at most 16
bytes).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import launch, load

DTYPES = (torch.bfloat16, torch.float32)
_KIND = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHANNELS = 4096  # the kernel's per-channel tables in 48 KB of shared memory (kMaxChannels)


def bn_relu_plain(x: torch.Tensor, channels: int, mean: torch.Tensor, var: torch.Tensor,
                  weight: torch.Tensor, bias: torch.Tensor, eps: float,
                  conv_bias: torch.Tensor | None = None,
                  out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``bn_relu``'s function in plain PyTorch: scale = weight / sqrt(var +
    eps), shift = bias - mean * scale, relu(((x + conv_bias) * scale) +
    shift) in float32 on the first ``channels`` channels, rounded to
    ``out_dtype`` (default ``x``'s) and contiguous."""
    scale = weight / torch.sqrt(var + eps)
    shift = bias - mean * scale
    v = x[..., :channels].float()
    if conv_bias is not None:
        v = v + conv_bias
    return torch.relu(v * scale + shift).to(out_dtype or x.dtype).contiguous()


def bias_store_plain(h: torch.Tensor, bias: torch.Tensor | None, out: torch.Tensor,
                     channel: int) -> None:
    """``bias_store``'s function in plain PyTorch: ``out[..., channel:channel
    + N] = h + bias``, the sum in float32 rounded to ``out``'s dtype."""
    v = h.float() if bias is None else h.float() + bias
    out[..., channel:channel + h.shape[-1]] = v


def pool_bias_store_plain(h: torch.Tensor, bias: torch.Tensor | None, out: torch.Tensor,
                          channel: int = 0) -> None:
    """``pool_bias_store``'s function in plain PyTorch: the eight values of
    each 2^3 cell summed in float32 in (d, h, w) order, times 1/8, plus
    ``bias``, rounded into ``out[..., channel:channel + N]``."""
    _, D, H, W, N = h.shape
    v, s = h.float(), None
    for dd in range(2):
        for hh in range(2):
            for ww in range(2):
                t = v[:, dd:D - D % 2:2, hh:H - H % 2:2, ww:W - W % 2:2]
                s = t if s is None else s + t
    s = s * 0.125
    out[..., channel:channel + N] = s if bias is None else s + bias


def _params(device: torch.device, n: int, *tensors: torch.Tensor | None) -> list:
    """Each of ``tensors`` as (n,) float32 contiguous on ``device`` (None
    stays None); raises on another length or device."""
    out = []
    for t in tensors:
        if t is not None:
            if t.shape != (n,) or t.device != device:
                raise ValueError(f"need ({n},) per-channel parameters on {device}, got "
                                 f"{tuple(t.shape)} on {t.device}")
            t = t.to(torch.float32).contiguous()
        out.append(t)
    return out


def _rows(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` (B, D, H, W, C) in a dtype of ``DTYPES``, contiguous (a copy
    where it is not)."""
    if x.ndim != 5 or x.dtype not in DTYPES:
        raise ValueError(f"{name} must be (B, D, H, W, C) of {DTYPES}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no dense-block kernel for device {x.device}")
    return x.contiguous()


def _vector(elt_bytes: int, counts: tuple[int, ...], pointers: tuple[int, ...]) -> int:
    """The widest vector of 8, 4, 2 or 1 values, of at most 16 bytes, that
    divides every count and to whose bytes every pointer is aligned."""
    for v in (8, 4, 2, 1):
        if (v * elt_bytes <= 16 and all(n % v == 0 for n in counts)
                and all(p % (v * elt_bytes) == 0 for p in pointers)):
            return v
    return 1


def bn_relu(x: torch.Tensor, channels: int, mean: torch.Tensor, var: torch.Tensor,
            weight: torch.Tensor, bias: torch.Tensor, eps: float,
            conv_bias: torch.Tensor | None = None,
            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """(B, D, H, W, ``channels``) contiguous: evaluation-mode BatchNorm
    (running ``mean`` and ``var``, ``weight``, ``bias``, ``eps``) and ReLU of
    the first ``channels`` channels of ``x`` (B, D, H, W, C_total), after
    adding ``conv_bias`` where given; in ``out_dtype``, ``x``'s dtype or
    (from bfloat16) float32. Parameters are (channels,) float32."""
    x = _rows(x, "x")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (x.dtype, torch.float32) or not 0 < channels <= x.shape[-1]:
        raise ValueError(f"bn_relu of {channels} of {x.shape[-1]} {x.dtype} channels to "
                         f"{out_dtype}: need 0 < channels <= C_total and an out_dtype of "
                         f"{x.dtype} or float32")
    params = _params(x.device, channels, mean, var, weight, bias, conv_bias)
    if x.device.type == "cpu":
        return bn_relu_plain(x, channels, *params[:4], eps, params[4], out_dtype)
    if channels > MAX_CHANNELS:
        raise ValueError(f"bn_relu takes at most {MAX_CHANNELS} channels, got {channels}")
    y = torch.empty((*x.shape[:-1], channels), dtype=out_dtype, device=x.device)
    rows = x.numel() // x.shape[-1]
    if rows == 0:
        return y
    elt = max(x.element_size(), y.element_size())
    vec = _vector(elt, (channels, x.shape[-1]), (x.data_ptr(), y.data_ptr()))
    launch(x.device.index, "dense_bn_relu", lambda sms, stream: _lib().dense_bn_relu_launch(
        x.data_ptr(), rows, x.shape[-1], channels, *(_ptr(p) for p in params[:4]), eps,
        _ptr(params[4]), y.data_ptr(), _KIND[x.dtype], _KIND[out_dtype], vec, sms, stream))
    bn_relu.launches += 1
    return y


bn_relu.launches = 0


def _check_store(h: torch.Tensor, bias: torch.Tensor | None, out: torch.Tensor, channel: int,
                 spatial: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor | None]:
    h = _rows(h, "h")
    N = h.shape[-1]
    if (out.ndim != 5 or out.dtype != h.dtype or out.device != h.device
            or not out.is_contiguous() or tuple(out.shape[:4]) != (h.shape[0], *spatial)
            or not 0 <= channel <= out.shape[-1] - N):
        raise ValueError(f"out must be a contiguous (B, {', '.join(map(str, spatial))}, C) "
                         f"{h.dtype} buffer on {h.device} with channels [{channel}, "
                         f"{channel + N}); got {tuple(out.shape)} {out.dtype} on {out.device}")
    return h, _params(h.device, N, bias)[0]


def bias_store(h: torch.Tensor, bias: torch.Tensor | None, out: torch.Tensor,
               channel: int) -> None:
    """``out[..., channel:channel + N] = h + bias``: ``h`` (B, D, H, W, N), a
    convolution's output; ``bias`` (N,) or None; ``out`` (B, D, H, W,
    C_total) contiguous in ``h``'s dtype. The sum in float32."""
    h, bias = _check_store(h, bias, out, channel, tuple(h.shape[1:4]))
    if h.device.type == "cpu":
        bias_store_plain(h, bias, out, channel)
        return
    _store(False, h, bias, out, channel)
    bias_store.launches += 1


bias_store.launches = 0


def pool_bias_store(h: torch.Tensor, bias: torch.Tensor | None, out: torch.Tensor,
                    channel: int = 0) -> None:
    """``out[..., channel:channel + N]`` = the 2^3 average pool of ``h`` (B,
    D, H, W, N), stride 2, odd edges floored, plus ``bias``; ``out`` (B,
    D//2, H//2, W//2, C_total) contiguous in ``h``'s dtype. Float32 sums."""
    spatial = tuple(s // 2 for s in h.shape[1:4])
    h, bias = _check_store(h, bias, out, channel, spatial)
    if min(spatial) < 1:
        raise ValueError(f"cannot pool {tuple(h.shape)} by 2")
    if h.device.type == "cpu":
        pool_bias_store_plain(h, bias, out, channel)
        return
    _store(True, h, bias, out, channel)
    pool_bias_store.launches += 1


pool_bias_store.launches = 0


def _store(pool: bool, h: torch.Tensor, bias: torch.Tensor | None, out: torch.Tensor,
           channel: int) -> None:
    B, D, H, W, N = h.shape
    if B == 0:
        return
    first = out.data_ptr() + channel * out.element_size()
    vec = _vector(h.element_size(), (N, out.shape[-1]), (h.data_ptr(), first))
    launch(h.device.index, "dense_store", lambda sms, stream: _lib().dense_store_launch(
        int(pool), h.data_ptr(), B, D, H, W, N, _ptr(bias), first, out.shape[-1],
        _KIND[h.dtype], vec, sms, stream))


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library, its functions' argument types set once."""
    lib = load("dense_block")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dense_bn_relu_launch.restype = i32
    lib.dense_bn_relu_launch.argtypes = [ptr, i64, i32, i32, ptr, ptr, ptr, ptr,
                                         ctypes.c_float, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.dense_store_launch.restype = i32
    lib.dense_store_launch.argtypes = [i32, ptr, i32, i32, i32, i32, i32, ptr, ptr, i32, i32,
                                       i32, i32, ptr]
    return lib
