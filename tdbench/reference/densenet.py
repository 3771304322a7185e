"""DenseCPD's network, a 3D DenseNet-BC, in plain PyTorch: the evaluation
forward and softmax, float32 with TF32 off (``model.no_tf32``).

DenseNet-BC (Huang et al., CVPR 2017) as DenseCPD uses it (Qi and Zhang,
J. Chem. Inf. Model. 2020): a 3^3 stem convolution; dense blocks whose
every layer is BatchNorm -> ReLU -> 1^3 convolution to 4 x growth ->
BatchNorm -> ReLU -> 3^3 'same' convolution to growth, its output
concatenated onto its input; between blocks a transition of BatchNorm ->
ReLU -> 1^3 convolution to half the channels -> 2^3 average pooling of
stride 2; then BatchNorm -> ReLU -> the mean over the voxels -> one Dense
layer -> softmax. BatchNorm in its inference form, from running statistics.

Where this departs from the paper's description:

- the input is TIMED-Design's frame, 21^3 voxels of 1 A in five atom
  channels (C, N, O, CA, CB), not the paper's own encoding of the
  environment;
- the widths and depth (a stem of 32, growth 16, three blocks of 6
  layers, compression 0.5, bottlenecks of 4 x growth, 20 classes) are the
  TIMED-Design model zoo's as its JAX reading has them
  (``models/densenet.py`` there), not figures taken from the paper; the
  zoo ships the model only as a release ``.h5``;
- BatchNorm's epsilon is 1e-3 (Keras's default);
- pooling floors odd edges (21 -> 10 -> 5: the last slab of each axis is
  dropped), as Keras's 'valid' average pooling does;
- no dropout (evaluation only), and the weights are drawn from a seed, not
  trained.

The weights are a dict of float32 tensors in the port's key names:
``stem.weight`` (C0, 5, 3, 3, 3) and ``.bias``; per layer ``layers.{i}.bn0``,
``.conv0``, ``.bn1``, ``.conv1``; per transition ``transitions.{j}.bn`` and
``.conv``; the last ``bn``; ``head.weight`` (20, C) and ``head.bias``; each
BatchNorm with ``.weight``, ``.bias``, ``.running_mean``, ``.running_var``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .model import no_tf32

BN_EPS = 1e-3


def _channels(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None, None]


def _bn_relu(w: dict, p: str, h: torch.Tensor, visit) -> torch.Tensor:
    if visit is not None:
        visit("bn", p, h)
    scale = w[p + "weight"] / torch.sqrt(w[p + "running_var"] + BN_EPS)
    return F.relu((h - _channels(w[p + "running_mean"])) * _channels(scale)
                  + _channels(w[p + "bias"]))


def _conv(w: dict, p: str, h: torch.Tensor, visit) -> torch.Tensor:
    if visit is not None:
        visit("conv", p, h)
    return F.conv3d(h, w[p + "weight"], w[p + "bias"], padding=w[p + "weight"].shape[-1] // 2)


def logits(weights: dict, x: torch.Tensor, block_layers, visit=None) -> torch.Tensor:
    """Logits (B, C) of NDHWC frames ``x``, blocks of ``block_layers``
    layers. ``visit(kind, prefix, h)``, where given, is called with the
    input ``h`` of each BatchNorm ("bn"), convolution ("conv") and of the
    Dense head ("head") before the layer reads its weights under
    ``prefix``, in the forward's order; it may set them (the calibration)."""
    h = _conv(weights, "stem.", x.to(torch.float32).permute(0, 4, 1, 2, 3), visit)
    i = 0
    for b, n in enumerate(block_layers):
        for _ in range(n):
            p = f"layers.{i}."
            g = _conv(weights, p + "conv0.", _bn_relu(weights, p + "bn0.", h, visit), visit)
            g = _conv(weights, p + "conv1.", _bn_relu(weights, p + "bn1.", g, visit), visit)
            h = torch.cat([h, g], 1)
            i += 1
        if b < len(block_layers) - 1:
            p = f"transitions.{b}."
            h = _conv(weights, p + "conv.", _bn_relu(weights, p + "bn.", h, visit), visit)
            h = F.avg_pool3d(h, 2, 2)
    h = _bn_relu(weights, "bn.", h, visit).mean((2, 3, 4))
    if visit is not None:
        visit("head", "head.", h)
    return F.linear(h, weights["head.weight"], weights["head.bias"])


def probabilities(weights: dict, x: torch.Tensor, block_layers, block: int = 64):
    """Softmax of NDHWC frames, ``block`` frames at a time, TF32 off."""
    no_tf32()
    with torch.no_grad():
        return torch.cat([torch.softmax(logits(weights, x[s : s + block], block_layers), -1)
                          for s in range(0, len(x), block)])
