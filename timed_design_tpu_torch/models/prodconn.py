"""ProDCoNN (PyTorch): the port of ``timed_design_tpu/models/prodconn.py``.

Two parallel VALID convolutions (3^3 and 4^3, the 4^3 branch padded by one
on the high side of each spatial axis to match 19^3), concatenated on
channels, a 3^3 VALID conv, 2^3 max pooling (17^3 -> 8^3), a 3^3 VALID conv
to 6^3 x 64, a flatten in the JAX layout's (NDHWC) order, Dense(128),
dropout (rate 0.2) in training and the class head in float32. Convolutions and the first Dense run in the compute
dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import at_least_float32, cast_conv, cast_linear, dropout

_FLAT = 6 ** 3 * 64  # features after the last conv, 21^3 frames


class ProDCoNN(nn.Module):
    def __init__(self, n_classes: int = 20, compute_dtype: torch.dtype = torch.float32,
                 in_channels: int = 5, dropout_rate: float = 0.2):
        super().__init__()
        self.n_classes = n_classes
        self.compute_dtype = compute_dtype
        self.dropout_rate = dropout_rate
        # Flax Conv_0..Conv_3 and Dense_0, Dense_1, in order
        self.convs = nn.ModuleList([
            nn.Conv3d(in_channels, 16, 3), nn.Conv3d(in_channels, 16, 4),
            nn.Conv3d(32, 32, 3), nn.Conv3d(32, 64, 3),
        ])
        self.dense = nn.ModuleList([nn.Linear(_FLAT, 128), nn.Linear(128, n_classes)])

    def forward(
        self, x: torch.Tensor, logits: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """(B, 21, 21, 21, C) NDHWC frames -> (B, n_classes) float32; in
        training, dropout after Dense(128) draws from ``generator``."""
        dt = self.compute_dtype
        x = x.to(dt).permute(0, 4, 1, 2, 3)  # NCDHW view, channels_last_3d
        a = F.relu(cast_conv(self.convs[0], x))
        b = F.pad(F.relu(cast_conv(self.convs[1], x)), (0, 1, 0, 1, 0, 1))
        x = F.relu(cast_conv(self.convs[2], torch.cat([a, b], dim=1)))
        x = F.max_pool3d(x, 2, 2)
        x = F.relu(cast_conv(self.convs[3], x))
        x = x.permute(0, 2, 3, 4, 1).flatten(1)  # NDHWC order, as Flax flattens
        x = F.relu(cast_linear(self.dense[0], x))
        x = dropout(x, self.dropout_rate, self.training, generator)
        x = cast_linear(self.dense[1], at_least_float32(x))
        return x if logits else torch.softmax(x, dim=-1)


def prodconn(n_classes: int = 20, **kw) -> ProDCoNN:
    return ProDCoNN(n_classes=n_classes, **kw)
