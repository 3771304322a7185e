"""TIMED model family (PyTorch).

The port of ``timed_design_tpu/models/timed.py``: [Conv3D -> ELU ->
BatchNorm] blocks, SpatialDropout in training, a 1x1x1 projection to the
class count, global average pooling and softmax over 20 residues or 338
rotamers. Input is cast to the compute dtype; pooling and softmax run in
float32.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import (
    ConvBlock,
    at_least_float32,
    cast_conv,
    global_average_pool_3d,
    spatial_dropout_3d,
)


class TIMED(nn.Module):
    def __init__(
        self,
        n_classes: int = 20,
        filters: tuple[int, ...] = (16, 32, 64, 128),
        dropout_rate: float = 0.1,
        compute_dtype: torch.dtype = torch.float32,
        bn_momentum: float = 0.99,
        in_channels: int = 5,
    ):
        super().__init__()
        self.n_classes = n_classes
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype
        widths = (in_channels, *filters)
        self.blocks = nn.ModuleList(
            ConvBlock(a, b, bn_momentum) for a, b in zip(widths, widths[1:])
        )
        self.head = nn.Conv3d(widths[-1], n_classes, 1)

    def forward(
        self, x: torch.Tensor, logits: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """(B, 21, 21, 21, C) NDHWC frames -> (B, n_classes) float32."""
        dt = self.compute_dtype
        x = x.to(dt).permute(0, 4, 1, 2, 3)  # NCDHW view, channels_last_3d
        for block in self.blocks:
            x = block(x)
        if self.training and self.dropout_rate > 0:
            x = spatial_dropout_3d(
                x.permute(0, 2, 3, 4, 1), self.dropout_rate, True, generator
            ).permute(0, 4, 1, 2, 3)
        x = cast_conv(self.head, x)
        x = global_average_pool_3d(at_least_float32(x))
        return x if logits else torch.softmax(x, dim=-1)


def timed(n_classes: int = 20, **kw) -> TIMED:
    return TIMED(n_classes=n_classes, **kw)


def timed_deep(n_classes: int = 20, **kw) -> TIMED:
    return TIMED(n_classes=n_classes, filters=(32, 64, 128, 128, 256, 256), **kw)


def timed_rotamer(**kw) -> TIMED:
    return TIMED(n_classes=338, **kw)


def timed_rotamer_deep(**kw) -> TIMED:
    return TIMED(n_classes=338, filters=(32, 64, 128, 128, 256, 256), **kw)


def timed_rotamer_not_so_deep(**kw) -> TIMED:
    return TIMED(n_classes=338, filters=(16, 32, 64), **kw)
