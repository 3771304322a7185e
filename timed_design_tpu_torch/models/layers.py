"""Building blocks of the 3D-CNN zoo (PyTorch).

The port of ``timed_design_tpu/models/layers.py``. Modules take NCDHW
tensors; the model's public forward takes the JAX layout NDHWC and views it
as NCDHW without a copy (the channels_last_3d memory format). Parameters
are float32 and are cast to the compute dtype at each call, as Flax's
``dtype``/``param_dtype`` pair does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ConvBlock(nn.Module):
    """[Conv3D 3x3x3 'same' -> ELU -> BatchNorm], BatchNorm in float32."""

    def __init__(self, in_features: int, features: int, bn_momentum: float = 0.99):
        super().__init__()
        self.conv = nn.Conv3d(in_features, features, 3, padding=1)
        # Keras momentum 0.99 is PyTorch momentum 0.01; Keras epsilon 1e-3
        self.bn = nn.BatchNorm3d(features, eps=1e-3, momentum=1.0 - bn_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = F.conv3d(x, self.conv.weight.to(dt), self.conv.bias.to(dt), padding=1)
        x = F.elu(x)
        return self.bn(x.to(torch.float32)).to(dt)


def cast_conv(conv: nn.Conv3d, x: torch.Tensor, padding: int = 0) -> torch.Tensor:
    """``conv`` applied in ``x``'s dtype, its float32 parameters cast."""
    return F.conv3d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), padding=padding)


def spatial_dropout_3d(
    x: torch.Tensor, rate: float, training: bool,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """SpatialDropout3D on NDHWC: drops whole channels (Keras semantics),
    with noise shape (B, 1, 1, 1, C)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(
        (x.shape[0], 1, 1, 1, x.shape[-1]), generator=generator, device=x.device
    ) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def global_average_pool_3d(x: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) -> (B, C) mean over the spatial dims."""
    return x.mean(dim=(2, 3, 4))
