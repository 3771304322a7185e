"""Post-training quantized inference for the conv stacks (PyTorch).

The port of ``timed_design_tpu/models/quantize.py``. Every convolution of
the zoo goes through one helper, ``models/layers.py::conv3d``, which reads
the mode that ``quantized_convs`` set in a context variable when it runs
(the port runs eagerly: no trace bakes a mode in). Dense layers stay
unquantized, as Flax's ``nn.Dense`` does under the JAX package's gate.

Modes:
  * ``"int8"``       weights per output channel, symmetric int8; activations
                     per tensor, symmetric int8, scaled by the whole input of
                     the convolution (every frame of the padded batch, on
                     every data rank of a mesh); the
                     integer convolution with int32 sums (``ops/conv3d_int8``:
                     the hand-written kernel on the card, its plain version on
                     the CPU), rescaled in float32, cast and biased in the
                     same call (float64 finishes in PyTorch).
  * ``"int8-fake"``  the same codes, multiplied back by their scales and
                     convolved in floating point.
  * ``"w8"``         the weights' codes only, multiplied back; activations
                     untouched.
The weight is cast to the compute dtype before it is quantized, as Flax
casts its kernel before the convolution. The bias is added after the
convolution (after the rescale in ``int8``), in the compute dtype, and never
quantized.

Every mode takes a convolution of any geometry: per-axis stride, dilation
and (lo, hi) zero padding (the Keras graph executor's convolutions, 1D and
2D ones as 3D with unit dims). In ``int8`` each is mapped exactly onto the
kernel's contract (cubic k, symmetric padding, stride 1) by
``conv3d_int8_any``; zero codes add nothing to the integer sums.
"""
from __future__ import annotations

import contextlib
import contextvars
import typing as t

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.conv3d_int8 import OUT_DTYPES, conv3d_int8
from ..parallel.mesh import active_mesh, all_reduce

MODES = ("int8", "int8-fake", "w8")

_MODE: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "td_quantize_mode", default=None)
_TINY = torch.finfo(torch.float32).tiny


def check_mode(mode: str | None) -> str | None:
    """``mode`` if it is None or one of ``MODES``; else ValueError."""
    if mode is not None and mode not in MODES:
        raise ValueError(f"quantize mode must be one of {MODES}, got {mode!r}")
    return mode


def current_mode() -> str | None:
    """The mode set by the innermost ``quantized_convs`` of this thread."""
    return _MODE.get()


@contextlib.contextmanager
def quantized_convs(mode: str | None):
    """Convolutions run inside run in ``mode`` (None: unquantized). The mode
    is per thread: enter it on the thread that runs the forward."""
    check_mode(mode)
    if mode is None:
        yield
        return
    token = _MODE.set(mode)
    try:
        yield
    finally:
        _MODE.reset(token)


def quantize_fn(fn: t.Callable, mode: str | None) -> t.Callable:
    """``fn`` wrapped so that every call runs under ``mode``."""
    if check_mode(mode) is None:
        return fn

    def wrapped(*args, **kwargs):
        with quantized_convs(mode):
            return fn(*args, **kwargs)

    return wrapped


def quantize_weight(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes, scales) of an (N, C, k, k, k) kernel in its compute dtype:
    float32 codes in [-127, 127] and (N,) float32 scales, max |w| of each
    output channel over 127, floored at float32's smallest normal."""
    w32 = weight.to(torch.float32)
    s_w = (w32.abs().amax(dim=(1, 2, 3, 4)) / 127.0).clamp_min(_TINY)
    return torch.clamp(torch.round(w32 / s_w.view(-1, 1, 1, 1, 1)), -127, 127), s_w


def quantize_activation(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes, scale) of a whole tensor: float32 codes in [-127, 127] and a
    0-dim float32 scale, max |x| over 127, floored as the weights'. Under a
    mesh (``parallel/mesh.py::batch_over``) ``x`` is this rank's rows of a
    batch split over the data group and the max is the global batch's, as
    JAX's max over a sharded batch reduces over every shard."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax().reshape(1)
    mesh = active_mesh()
    if mesh is not None:
        all_reduce(amax, mesh.data_group, dist.ReduceOp.MAX)
    s_x = (amax[0] / 127.0).clamp_min(_TINY)
    return torch.clamp(torch.round(x32 / s_x), -127, 127), s_x


Padding = t.Union[int, t.Sequence[int], t.Sequence[t.Sequence[int]]]


def triple(v: t.Union[int, t.Sequence[int]]) -> tuple[int, int, int]:
    """An int, or three ints, as three ints (D, H, W)."""
    v = (v,) * 3 if isinstance(v, int) else tuple(int(a) for a in v)
    if len(v) != 3:
        raise ValueError(f"need an int or three ints, got {v}")
    return v


def pad_pairs(padding: Padding) -> tuple[tuple[int, int], ...]:
    """``padding`` (an int, three ints, or three (lo, hi) pairs) as three
    (lo, hi) pairs of zeros around D, H and W."""
    if isinstance(padding, int):
        return ((padding, padding),) * 3
    pairs = tuple((int(p), int(p)) if isinstance(p, int) else (int(p[0]), int(p[1]))
                  for p in padding)
    if len(pairs) != 3:
        raise ValueError(f"need padding for three axes, got {padding}")
    return pairs


def pad_channels_last(x: torch.Tensor, pairs: tuple[tuple[int, int], ...],
                      value: float = 0.0) -> torch.Tensor:
    """``x`` (B, D, H, W, C) padded with ``value`` around D, H and W."""
    (d0, d1), (h0, h1), (w0, w1) = pairs
    return F.pad(x, (0, 0, w0, w1, h0, h1, d0, d1), value=value)


def float_conv3d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                 padding: Padding = 0, stride=1, dilation=1) -> torch.Tensor:
    """``F.conv3d`` of ``x`` (B, C, D, H, W), with asymmetric ``padding``
    applied first as explicit zeros (on the channels-last memory the zoo's
    NCDHW views sit on)."""
    pairs = pad_pairs(padding)
    if any(lo != hi for lo, hi in pairs):
        x = pad_channels_last(x.permute(0, 2, 3, 4, 1), pairs).permute(0, 4, 1, 2, 3)
        pairs = ((0, 0),) * 3
    return F.conv3d(x, weight, bias, stride=triple(stride),
                    padding=tuple(lo for lo, _ in pairs), dilation=triple(dilation))


def conv3d_int8_any(xq: torch.Tensor, wq: torch.Tensor, padding: Padding = 0, stride=1,
                    dilation=1, scale: torch.Tensor | None = None,
                    bias: torch.Tensor | None = None,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``conv3d_int8`` for a convolution of any geometry: codes ``xq`` (B, D,
    H, W, C) and ``wq`` (N, kd, kh, kw, C), per-axis ``stride`` and
    ``dilation``, ``padding`` as in ``pad_pairs``; ``scale``, ``bias`` and
    ``out_dtype`` as ``conv3d_int8`` takes them. The kernel takes a cubic k,
    padding 0 or (k - 1) / 2 and stride 1, so the convolution is rewritten,
    each step exact because zero codes add nothing: the weights zero-dilated;
    zero taps appended up to the largest k, with as many zeros past the
    input's end; the input zero-padded where the padding is not the
    kernel's; the stride-1 result sliced for a stride. One launch, which
    computes every position a stride skips."""
    pairs, s, d = pad_pairs(padding), triple(stride), triple(dilation)
    if d != (1, 1, 1):
        ks = [(k - 1) * a + 1 for k, a in zip(wq.shape[1:4], d)]
        dilated = wq.new_zeros((wq.shape[0], *ks, wq.shape[4]))
        dilated[:, ::d[0], ::d[1], ::d[2]] = wq
        wq = dilated
    ks = tuple(wq.shape[1:4])
    k = max(ks)
    if ks != (k, k, k):
        wq = F.pad(wq, (0, 0, 0, k - ks[2], 0, k - ks[1], 0, k - ks[0]))
        pairs = tuple((lo, hi + k - a) for (lo, hi), a in zip(pairs, ks))
    same = (k - 1) // 2
    if k % 2 and pairs == ((same, same),) * 3:
        kernel_padding = same
    else:
        kernel_padding = 0
        if pairs != ((0, 0),) * 3:
            xq = pad_channels_last(xq, pairs)
    out = conv3d_int8(xq, wq, kernel_padding, scale, bias, out_dtype)
    return out if s == (1, 1, 1) else out[:, ::s[0], ::s[1], ::s[2]]


def quantized_conv3d(
    mode: str, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
    padding: Padding = 0, stride=1, dilation=1, name: str | None = None,
) -> torch.Tensor:
    """``float_conv3d(x, weight, bias, padding, stride, dilation)`` in
    ``mode``: ``x`` (B, C, D, H, W), ``weight`` (N, C, kd, kh, kw) and
    ``bias`` (N,) in the compute dtype, ``x``'s. A convolution the int8
    kernel cannot take raises a ``ValueError`` naming ``name`` (the layer)
    and the shapes; nothing falls back to a floating-point convolution."""
    if not x.is_floating_point():
        raise TypeError(f"a quantized convolution takes a floating-point input, got {x.dtype}")
    geometry = (padding, stride, dilation)
    wq, s_w = quantize_weight(weight)
    dt = x.dtype
    if mode == "w8":
        out = float_conv3d(x, (wq * s_w.view(-1, 1, 1, 1, 1)).to(dt), None, *geometry)
    else:
        xq, s_x = quantize_activation(x)
        if mode == "int8-fake":
            out = float_conv3d((xq * s_x).to(dt), (wq * s_w.view(-1, 1, 1, 1, 1)).to(dt), None,
                               *geometry)
        elif mode == "int8":
            # channels-last codes: x is an NCDHW view of NDHWC memory in the zoo
            codes = (xq.to(torch.int8).permute(0, 2, 3, 4, 1),
                     wq.to(torch.int8).permute(0, 2, 3, 4, 1), *geometry, s_x * s_w)
            try:
                if dt in OUT_DTYPES:  # rescale, cast and bias in the kernel's epilogue
                    b = None if bias is None else bias.to(dt)
                    return conv3d_int8_any(*codes, b, dt).permute(0, 4, 1, 2, 3)
                out = conv3d_int8_any(*codes, out_dtype=torch.float32).permute(0, 4, 1, 2, 3).to(dt)
            except ValueError as e:
                raise ValueError(f"int8 convolution {name or ''} of x {tuple(x.shape)} with "
                                 f"weight {tuple(weight.shape)}, padding {padding}, stride "
                                 f"{stride}, dilation {dilation}: {e}") from e
        else:
            raise ValueError(f"quantize mode must be one of {MODES}, got {mode!r}")
    return out if bias is None else out + bias.to(dt).view(-1, 1, 1, 1)
