"""Seeded weights for a model, made on the device in one draw, then set
to the statistics of real frames as a trained model's are.

Every floating-point leaf of the state dict takes its slice of one
``torch.randn`` drawn from a ``torch.Generator`` on the device: a
convolution's weight N(0, gain^2 / fan_in) (``conv_gain``; the head's
``head_gain``), its bias N(0, 0.1^2); a BatchNorm's scale 1 + N(0, 0.1^2),
its shift N(0, 0.1^2). ``calibrate`` then, layer after layer over a batch
of seeded frames, scales each block's convolution so that its output has
unit spread (layer-sequential unit variance, Mishkin and Matas, ICLR 2016),
sets each BatchNorm's running mean and variance to those of its input, and
scales the head so that each frame's logits spread by ``logit_std``: every
layer's activations are then normalised, as in a trained model, and not a
small signal on a large offset.
"""
from __future__ import annotations

import torch

GENERATOR_SEED_BITS = 63


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
        n = v.numel()
        x = z[offset : offset + n].view(v.shape)
        offset += n
        if k.endswith("weight") and v.dim() == 5:
            gain = head_gain if k.startswith("head") else conv_gain
            out[k] = x * (gain / (v[0].numel() ** 0.5))
        elif k.endswith("running_var") or (k.endswith("bn.weight")):
            out[k] = 1.0 + 0.1 * (x.abs() if k.endswith("running_var") else x)
        else:
            out[k] = 0.1 * x
    return out


def calibrate(weights: dict, frames, logit_std: float) -> dict:
    """``weights`` with each block's convolution scaled to outputs of unit
    standard deviation over ``frames`` (NDHWC, float32), each BatchNorm's
    running statistics set to the mean and biased variance of its input
    over them, and the head's weight scaled so that the logits of a frame spread by
    ``logit_std`` (their standard deviation over classes, averaged over the
    frames). Float32, TF32 off."""
    import torch.nn.functional as F

    from .reference import model as ref_model

    ref_model.no_tf32()
    out = dict(weights)
    with torch.no_grad():
        h = frames.to(torch.float32).permute(0, 4, 1, 2, 3)
        for i in range(ref_model.n_blocks(out)):
            p = f"blocks.{i}."
            spread = F.conv3d(h, out[p + "conv.weight"], None, padding=1).std()
            out[p + "conv.weight"] = out[p + "conv.weight"] / spread
            h = F.elu(F.conv3d(h, out[p + "conv.weight"], out[p + "conv.bias"], padding=1))
            out[p + "bn.running_mean"] = h.mean((0, 2, 3, 4))
            out[p + "bn.running_var"] = h.var((0, 2, 3, 4), unbiased=False)
            scale = out[p + "bn.weight"] / torch.sqrt(out[p + "bn.running_var"] + ref_model.BN_EPS)
            h = (h - out[p + "bn.running_mean"][None, :, None, None, None]) \
                * scale[None, :, None, None, None] + out[p + "bn.bias"][None, :, None, None, None]
        logits = F.conv3d(h, out["head.weight"], None).mean((2, 3, 4))
        spread = logits.std(1).mean()
        out["head.weight"] = out["head.weight"] * (logit_std / spread)
    return out
