"""3D DenseNet and DenseCPD (PyTorch): the port of
``timed_design_tpu/models/densenet.py``.

Dense blocks of [BN -> ReLU -> 1^3 conv (4 x growth) -> BN -> ReLU -> 3^3
SAME conv (growth)] layers, each concatenating its output to its input;
transitions of [BN -> ReLU -> 1^3 conv (half the channels) -> 2^3 average
pooling] between blocks (21^3 -> 10^3 -> 5^3); then BN, ReLU, global average
pooling and the Dense head. BatchNorm (eps 1e-3, the Keras default), ReLU,
the pooling of a transition and the head run in float32; the convolutions
in the compute dtype.

Two paths, chosen by what the forward observes. Where the module is in
evaluation mode, autograd is off (``torch.no_grad``, ``inference_mode``) and
the compute dtype is bfloat16 or float32, each dense block lives in one
channels-last buffer (B, D, H, W, its final width): the stem's output, or the
transition's pooled output, fills its first channels, and each dense layer
stores its growth channels into the next slice, so nothing is concatenated.
The element-wise passes are the kernels of ``ops/dense_block.py`` (their plain
versions on the CPU): a BatchNorm-ReLU reads the channel prefix a layer
takes and writes the next convolution's input; the convolutions run without
their bias (in every quantize mode and under a model-axis shard too), which
the next pass adds in float32. Everywhere else (training, autograd on,
float64 or float16) the forward concatenates with ``torch.cat`` and runs
BatchNorm and ReLU as modules.

While the span recorder (``utils/timing.py``) is on, a forward records the
device spans ``densenet.block`` (id: the block's index), ``densenet.transition``
(id: the transition's index) and ``densenet.head`` (the last BN-ReLU, the
pooling and the Dense head); adds the bytes each dense layer's concatenation
writes to the counter ``densenet.concat_bytes`` (the whole concatenated
tensor, or in a block buffer the new slice alone); and counts each
BatchNorm-ReLU in ``densenet.bn_relu.fused`` (through a block buffer) or
``densenet.bn_relu.plain``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import dense_block
from ..utils import timing
from .layers import (
    BatchNorm3d, at_least_float32, cast_conv, cast_linear, global_average_pool_3d, whole_bias,
)


def _bn(features: int) -> BatchNorm3d:
    # Keras/Flax momentum 0.99 is PyTorch momentum 0.01
    return BatchNorm3d(features, eps=1e-3, momentum=0.01)


def _bn_relu(bn: BatchNorm3d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm and ReLU in float32, back to ``x``'s dtype."""
    return F.relu(bn(at_least_float32(x))).to(x.dtype)


def _fused_bn_relu(bn: BatchNorm3d, x: torch.Tensor, channels: int,
                   conv_bias: torch.Tensor | None = None,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``bn`` and ReLU of the first ``channels`` channels of the
    channels-last ``x``, ``conv_bias`` added first: ``dense_block.bn_relu``."""
    return dense_block.bn_relu(x, channels, bn.running_mean, bn.running_var, bn.weight,
                               bn.bias, bn.eps, conv_bias, out_dtype)


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


def _conv_for_store(conv: nn.Conv3d, x: torch.Tensor, padding: int = 0):
    """(``conv`` of the channels-last ``x`` without its bias, as NDHWC; the
    bias, which the pass after it adds in float32)."""
    return _ndhwc(cast_conv(conv, _ncdhw(x), padding, bias=False)), whole_bias(conv)


class DenseLayer(nn.Module):
    def __init__(self, in_features: int, growth_rate: int):
        super().__init__()
        self.bn0 = _bn(in_features)
        self.conv0 = nn.Conv3d(in_features, 4 * growth_rate, 1)
        self.bn1 = _bn(4 * growth_rate)
        self.conv1 = nn.Conv3d(4 * growth_rate, growth_rate, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = cast_conv(self.conv0, _bn_relu(self.bn0, x))
        h = cast_conv(self.conv1, _bn_relu(self.bn1, h), padding=1)
        out = torch.cat([x, h], dim=1)
        if timing.is_recording():
            timing.count("densenet.bn_relu.plain", 2)
            timing.count("densenet.concat_bytes", out.numel() * out.element_size())
        return out

    def fill(self, buf: torch.Tensor, c: int) -> int:
        """The layer on the first ``c`` channels of the block buffer ``buf``
        (B, D, H, W, C_total), its output stored into the next ``growth``
        channels; returns ``c + growth``."""
        h, bias = _conv_for_store(self.conv0, _fused_bn_relu(self.bn0, buf, c))
        h, bias = _conv_for_store(self.conv1, _fused_bn_relu(self.bn1, h, h.shape[-1], bias),
                                  padding=1)
        dense_block.bias_store(h, bias, buf, c)
        if timing.is_recording():
            timing.count("densenet.bn_relu.fused", 2)
            timing.count("densenet.concat_bytes", h.numel() * buf.element_size())
        return c + h.shape[-1]


class Transition(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.bn = _bn(in_features)
        self.conv = nn.Conv3d(in_features, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = cast_conv(self.conv, _bn_relu(self.bn, x))
        if timing.is_recording():
            timing.count("densenet.bn_relu.plain", 1)
        return F.avg_pool3d(at_least_float32(h), 2, 2).to(x.dtype)

    def fill(self, buf: torch.Tensor, width: int) -> tuple[torch.Tensor, int]:
        """The transition of the block buffer ``buf``, pooled into the first
        channels of the next block's buffer, of ``width`` channels; returns
        (that buffer, the channels filled)."""
        h, bias = _conv_for_store(self.conv, _fused_bn_relu(self.bn, buf, buf.shape[-1]))
        B, D, H, W, _ = buf.shape
        out = buf.new_empty((B, D // 2, H // 2, W // 2, width))
        dense_block.pool_bias_store(h, bias, out)
        if timing.is_recording():
            timing.count("densenet.bn_relu.fused", 1)
        return out, h.shape[-1]


class DenseNet3D(nn.Module):
    def __init__(
        self,
        n_classes: int = 20,
        growth_rate: int = 12,
        block_layers: tuple[int, ...] = (4, 4, 4),
        init_features: int = 24,
        compute_dtype: torch.dtype = torch.float32,
        in_channels: int = 5,
    ):
        super().__init__()
        self.n_classes = n_classes
        self.compute_dtype = compute_dtype
        self.block_layers = tuple(block_layers)
        self.stem = nn.Conv3d(in_channels, init_features, 3, padding=1)
        layers, transitions, c = [], [], init_features
        self.block_widths = []  # the channels of each block's output
        for bi, n_layers in enumerate(self.block_layers):
            for _ in range(n_layers):
                layers.append(DenseLayer(c, growth_rate))
                c += growth_rate
            self.block_widths.append(c)
            if bi != len(self.block_layers) - 1:
                transitions.append(Transition(c, c // 2))
                c //= 2
        self.layers = nn.ModuleList(layers)
        self.transitions = nn.ModuleList(transitions)
        self.bn = _bn(c)
        self.head = nn.Linear(c, n_classes)

    def forward(
        self, x: torch.Tensor, logits: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """(B, 21, 21, 21, C) NDHWC frames -> (B, n_classes) float32.
        ``generator`` is unused (DenseNet has no dropout); it is taken so
        that every family trains through one call."""
        x = x.to(self.compute_dtype)
        if self.training or torch.is_grad_enabled() or x.dtype not in dense_block.DTYPES:
            x = self._logits_concatenated(x.permute(0, 4, 1, 2, 3))  # NCDHW view
        else:
            x = self._logits_buffered(x)
        return x if logits else torch.softmax(x, dim=-1)

    def _logits_concatenated(self, x: torch.Tensor) -> torch.Tensor:
        """Logits of the NCDHW ``x``, each dense layer concatenating."""
        x = cast_conv(self.stem, x, padding=1)
        layers = iter(self.layers)
        for bi, n_layers in enumerate(self.block_layers):
            with timing.device_span("densenet.block", bi, device=x.device):
                for _ in range(n_layers):
                    x = next(layers)(x)
            if bi < len(self.transitions):
                with timing.device_span("densenet.transition", bi, device=x.device):
                    x = self.transitions[bi](x)
        with timing.device_span("densenet.head", device=x.device):
            if timing.is_recording():
                timing.count("densenet.bn_relu.plain", 1)
            x = global_average_pool_3d(F.relu(self.bn(at_least_float32(x))))
            return cast_linear(self.head, x)

    def _logits_buffered(self, x: torch.Tensor) -> torch.Tensor:
        """Logits of the NDHWC ``x``, each dense block in one buffer."""
        h, bias = _conv_for_store(self.stem, x, padding=1)
        buf = h.new_empty((*h.shape[:4], self.block_widths[0]))
        dense_block.bias_store(h, bias, buf, 0)
        c = h.shape[-1]
        layers = iter(self.layers)
        for bi, n_layers in enumerate(self.block_layers):
            with timing.device_span("densenet.block", bi, device=x.device):
                for _ in range(n_layers):
                    c = next(layers).fill(buf, c)
            if bi < len(self.transitions):
                with timing.device_span("densenet.transition", bi, device=x.device):
                    buf, c = self.transitions[bi].fill(buf, self.block_widths[bi + 1])
        with timing.device_span("densenet.head", device=x.device):
            if timing.is_recording():
                timing.count("densenet.bn_relu.fused", 1)
            x = _fused_bn_relu(self.bn, buf, c, out_dtype=torch.float32).mean(dim=(1, 2, 3))
            return cast_linear(self.head, x)


def densenet(n_classes: int = 20, **kw) -> DenseNet3D:
    return DenseNet3D(n_classes=n_classes, **kw)


def densecpd(n_classes: int = 20, **kw) -> DenseNet3D:
    """DenseCPD: the deeper DenseNet configuration."""
    return DenseNet3D(
        n_classes=n_classes, growth_rate=16, block_layers=(6, 6, 6),
        init_features=32, **kw,
    )
