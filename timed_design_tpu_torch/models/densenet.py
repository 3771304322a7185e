"""3D DenseNet and DenseCPD (PyTorch): the port of
``timed_design_tpu/models/densenet.py``.

Dense blocks of [BN -> ReLU -> 1^3 conv (4 x growth) -> BN -> ReLU -> 3^3
SAME conv (growth)] layers, each concatenating its output to its input;
transitions of [BN -> ReLU -> 1^3 conv (half the channels) -> 2^3 average
pooling] between blocks (21^3 -> 10^3 -> 5^3); then BN, ReLU, global average
pooling and the Dense head. BatchNorm (eps 1e-3, the Keras default), ReLU,
the pooling of a transition and the head run in float32; the convolutions
in the compute dtype.

While the span recorder (``utils/timing.py``) is on, a forward records the
device spans ``densenet.block`` (id: the block's index), ``densenet.transition``
(id: the transition's index) and ``densenet.head`` (the last BN-ReLU, the
pooling and the Dense head), and adds the bytes each concatenation writes
to the counter ``densenet.concat_bytes``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import timing
from .layers import BatchNorm3d, at_least_float32, cast_conv, cast_linear, global_average_pool_3d


def _bn(features: int) -> BatchNorm3d:
    # Keras/Flax momentum 0.99 is PyTorch momentum 0.01
    return BatchNorm3d(features, eps=1e-3, momentum=0.01)


def _bn_relu(bn: BatchNorm3d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm and ReLU in float32, back to ``x``'s dtype."""
    return F.relu(bn(at_least_float32(x))).to(x.dtype)


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
            timing.count("densenet.concat_bytes", out.numel() * out.element_size())
        return out


class Transition(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.bn = _bn(in_features)
        self.conv = nn.Conv3d(in_features, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = cast_conv(self.conv, _bn_relu(self.bn, x))
        return F.avg_pool3d(at_least_float32(h), 2, 2).to(x.dtype)


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
        for bi, n_layers in enumerate(self.block_layers):
            for _ in range(n_layers):
                layers.append(DenseLayer(c, growth_rate))
                c += growth_rate
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
        x = x.to(self.compute_dtype).permute(0, 4, 1, 2, 3)  # NCDHW view
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
            x = global_average_pool_3d(F.relu(self.bn(at_least_float32(x))))
            x = cast_linear(self.head, x)
        return x if logits else torch.softmax(x, dim=-1)


def densenet(n_classes: int = 20, **kw) -> DenseNet3D:
    return DenseNet3D(n_classes=n_classes, **kw)


def densecpd(n_classes: int = 20, **kw) -> DenseNet3D:
    """DenseCPD: the deeper DenseNet configuration."""
    return DenseNet3D(
        n_classes=n_classes, growth_rate=16, block_layers=(6, 6, 6),
        init_features=32, **kw,
    )
