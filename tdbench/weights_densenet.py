"""Seeded weights for a DenseNet (``reference/densenet.py``'s key names),
made on the device in one draw, then set to the statistics of real frames
as a trained model's are: ``weights.py`` for this family.

Every floating-point leaf of the state dict takes its slice of one
``torch.randn`` drawn from a ``torch.Generator`` on the device: a
convolution's weight N(0, conv_gain^2 / fan_in), the Dense head's
N(0, head_gain^2 / fan_in); a BatchNorm's scale 1 + N(0, 0.1^2), its
running variance 1 + |N(0, 0.1^2)|; every bias, shift and running mean
N(0, 0.1^2). ``calibrate`` then walks the reference's forward over a batch
of seeded frames, in its own order: each convolution is scaled so that its
output (bias left out) has unit spread, each BatchNorm's running mean and
variance are set to those of its own input (in a dense layer, the
concatenation it normalises), and the Dense head, weight and bias, is
scaled so that a frame's logits spread by ``logit_std``.
"""
from __future__ import annotations

import torch

from .weights import GENERATOR_SEED_BITS


def make_weights(state: dict, seed: int, device, conv_gain: float, head_gain: float) -> dict:
    """A new float32 state dict shaped as ``state`` (a module's), on
    ``device``, drawn from ``seed``; integer leaves copied as they are."""
    floats = {k: v for k, v in state.items() if v.is_floating_point()}
    total = sum(v.numel() for v in floats.values())
    gen = torch.Generator(device=device).manual_seed(seed % (1 << GENERATOR_SEED_BITS))
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for k, v in state.items():
        if not v.is_floating_point():
            out[k] = v.clone().to(device)
            continue
        x = z[offset : offset + v.numel()].view(v.shape)
        offset += v.numel()
        if k.endswith("weight") and v.dim() > 1:
            gain = head_gain if k.startswith("head.") else conv_gain
            out[k] = x * (gain / v[0].numel() ** 0.5)
        elif k.endswith("weight") or k.endswith("running_var"):
            out[k] = 1.0 + 0.1 * (x.abs() if k.endswith("running_var") else x)
        else:
            out[k] = 0.1 * x
    return out


def calibrate(weights: dict, frames, block_layers, logit_std: float) -> dict:
    """``weights`` calibrated over ``frames`` (NDHWC, float32) as the module
    doc says; float32, TF32 off."""
    import torch.nn.functional as F

    from .reference import densenet as ref

    ref.no_tf32()
    out = dict(weights)

    def visit(kind: str, p: str, h: torch.Tensor) -> None:
        if kind == "bn":
            out[p + "running_mean"] = h.mean((0, 2, 3, 4))
            out[p + "running_var"] = h.var((0, 2, 3, 4), unbiased=False)
        elif kind == "conv":
            w = out[p + "weight"]
            out[p + "weight"] = w / F.conv3d(h, w, None, padding=w.shape[-1] // 2).std()
        else:
            spread = F.linear(h, out[p + "weight"], out[p + "bias"]).std(1).mean()
            out[p + "weight"] = out[p + "weight"] * (logit_std / spread)
            out[p + "bias"] = out[p + "bias"] * (logit_std / spread)

    with torch.no_grad():
        ref.logits(out, frames, block_layers, visit)
    return out
