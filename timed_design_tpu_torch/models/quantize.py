"""Post-training quantized inference for the conv stacks (PyTorch).

The port of ``timed_design_tpu/models/quantize.py``. Every convolution of
the zoo goes through one helper, ``models/layers.py::conv3d``, which reads
the mode that ``quantized_convs`` set in a context variable when it runs
(the port runs eagerly: no trace bakes a mode in). Dense layers stay
unquantized, as Flax's ``nn.Dense`` does under the JAX package's gate.

Modes:
  * ``"int8"``       weights per output channel, symmetric int8; activations
                     per tensor, symmetric int8, scaled by the whole input of
                     the convolution (every frame of the padded batch); the
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
"""
from __future__ import annotations

import contextlib
import contextvars
import typing as t

import torch
import torch.nn.functional as F

from ..ops.conv3d_int8 import OUT_DTYPES, conv3d_int8

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
    0-dim float32 scale, max |x| over 127, floored as the weights'."""
    x32 = x.to(torch.float32)
    s_x = (x32.abs().amax() / 127.0).clamp_min(_TINY)
    return torch.clamp(torch.round(x32 / s_x), -127, 127), s_x


def quantized_conv3d(
    mode: str, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
    padding: int = 0,
) -> torch.Tensor:
    """``F.conv3d(x, weight, bias, padding=padding)`` in ``mode``: ``x``
    (B, C, D, H, W), ``weight`` (N, C, k, k, k) and ``bias`` (N,) in the
    compute dtype, ``x``'s."""
    if not x.is_floating_point():
        raise TypeError(f"a quantized convolution takes a floating-point input, got {x.dtype}")
    wq, s_w = quantize_weight(weight)
    dt = x.dtype
    if mode == "w8":
        out = F.conv3d(x, (wq * s_w.view(-1, 1, 1, 1, 1)).to(dt), padding=padding)
    else:
        xq, s_x = quantize_activation(x)
        if mode == "int8-fake":
            out = F.conv3d((xq * s_x).to(dt), (wq * s_w.view(-1, 1, 1, 1, 1)).to(dt),
                           padding=padding)
        elif mode == "int8":
            # channels-last codes: x is an NCDHW view of NDHWC memory in the zoo
            codes = (xq.to(torch.int8).permute(0, 2, 3, 4, 1),
                     wq.to(torch.int8).permute(0, 2, 3, 4, 1), padding, s_x * s_w)
            if dt in OUT_DTYPES:  # rescale, cast and bias in the kernel's epilogue
                b = None if bias is None else bias.to(dt)
                return conv3d_int8(*codes, b, dt).permute(0, 4, 1, 2, 3)
            out = conv3d_int8(*codes, out_dtype=torch.float32).permute(0, 4, 1, 2, 3).to(dt)
        else:
            raise ValueError(f"quantize mode must be one of {MODES}, got {mode!r}")
    return out if bias is None else out + bias.to(dt).view(-1, 1, 1, 1)
