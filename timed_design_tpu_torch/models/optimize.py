"""Inference-graph optimization: exact BatchNorm folding for TIMED (PyTorch).

The port of ``timed_design_tpu/models/optimize.py``. TIMED's block is Conv
-> ELU -> BatchNorm, so a BatchNorm cannot fold back into its own
convolution (the ELU sits between), but every BatchNorm output feeds a
linear operation, the next block's convolution or the 1x1x1 head, so it
folds forward:

    BN(e) = a e + b          a = gamma / sqrt(var + eps), b = beta - mean a
    Conv(BN(e)) = Conv'(e) + bias_map
        Conv'    = the kernel scaled by a along its input channels
        bias_map = Conv(b), the constant field b through the original
                   kernel with 'same' padding: it varies near the frame's
                   border, where the padding holds zeros and not b

``fold_timed_bn`` turns a TIMED module (or its ``state_dict``) into those
tensors; ``timed_inference_apply`` runs the BatchNorm-free forward on them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import conv3d


def fold_timed_bn(
    model_or_state, eps: float = 1e-3, spatial: tuple[int, int, int] = (21, 21, 21),
) -> tuple[dict[str, torch.Tensor], int]:
    """A TIMED module or ``state_dict`` -> (folded tensors, block count).

    The tensors lie on the CPU in float32, kernels in PyTorch's (O, I, D,
    H, W) layout: ``kernel_i``, ``bias_i`` per block, ``bias_map_i`` (O, D,
    H, W) from the second block on, ``kernel_head`` and ``bias_head``. The
    scalings are computed in float64 and each ``bias_map_i`` once in
    float32, as the JAX package does."""
    sd = model_or_state.state_dict() if isinstance(model_or_state, nn.Module) else model_or_state
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    n_blocks = 0
    while f"blocks.{n_blocks}.conv.weight" in sd:
        n_blocks += 1
    folded: dict[str, torch.Tensor] = {}
    a_prev = b_prev = None  # the previous block's BatchNorm, a e + b
    for i in range(n_blocks):
        weight = sd[f"blocks.{i}.conv.weight"]
        kernel = weight.double()
        if a_prev is not None:
            kernel = kernel * a_prev.view(1, -1, 1, 1, 1)
            field = b_prev.float().view(1, -1, 1, 1, 1).expand(1, -1, *spatial)
            folded[f"bias_map_{i}"] = F.conv3d(field, weight.float(), padding=1)[0]
        folded[f"kernel_{i}"] = kernel.float()
        folded[f"bias_{i}"] = sd[f"blocks.{i}.conv.bias"].float()
        bn = {k: sd[f"blocks.{i}.bn.{k}"].double()
              for k in ("weight", "bias", "running_mean", "running_var")}
        a_prev = bn["weight"] / torch.sqrt(bn["running_var"] + eps)
        b_prev = bn["bias"] - bn["running_mean"] * a_prev
    head = sd["head.weight"].double()
    # the 1x1x1 head needs no padding: the b field is a constant shift
    folded["kernel_head"] = (head * a_prev.view(1, -1, 1, 1, 1)).float()
    folded["bias_head"] = (sd["head.bias"].double() + head[:, :, 0, 0, 0] @ b_prev).float()
    return folded, n_blocks


def timed_inference_apply(
    folded: dict[str, torch.Tensor], x: torch.Tensor, n_blocks: int,
    compute_dtype: torch.dtype = torch.float32, logits: bool = False,
) -> torch.Tensor:
    """The BatchNorm-free TIMED forward: (B, 21, 21, 21, C) NDHWC frames ->
    (B, n_classes) float32, on ``x``'s device.

    Convolutions, biases and ELU run in ``compute_dtype``; the head takes
    its input and kernel, rounded to ``compute_dtype``, in float32, so its
    sums and the softmax are float32. A float32 forward on the card wants
    cuDNN's TF32 off (``torch.backends.cudnn.allow_tf32``), as ``Predictor``
    sets it."""
    dt = compute_dtype

    def p(name: str) -> torch.Tensor:
        return folded[name].to(x.device, dt)

    x = x.to(dt).permute(0, 4, 1, 2, 3)  # NCDHW view, channels_last_3d
    for i in range(n_blocks):
        bias = p(f"bias_{i}").view(-1, 1, 1, 1)
        if i > 0:
            bias = bias + p(f"bias_map_{i}")
        x = F.elu(conv3d(x, p(f"kernel_{i}"), None, padding=1) + bias)
    x = conv3d(x.float(), p("kernel_head").float(), None)
    x = (x + folded["bias_head"].to(x.device).view(-1, 1, 1, 1)).mean(dim=(2, 3, 4))
    return x if logits else torch.softmax(x, dim=-1)
