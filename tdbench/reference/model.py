"""TIMED in plain PyTorch: the forward, the train step with Adam, and the
rotamer head's 338 -> 20 compression, from the published architecture.

TIMED: four blocks of [Conv3D 3^3 'same' -> ELU -> BatchNorm (eps 1e-3)],
spatial dropout of whole channels before the head in training, a 1^3
convolution to the class count, the mean over the 21^3 voxels and softmax.
Everything runs in float32 with TF32 off, unless ``operand_dtype`` names a
lower precision: the convolutions' inputs and weights are then rounded to
it (float8 e4m3, and the gradients of their outputs to e5m2), each tensor
with one scale as 8-bit training scales them, and the products summed in
float32, as a tensor core of that precision would.

The weights are a dict of float32 tensors keyed as the benchmark makes
them: ``blocks.{i}.conv.weight`` (Cout, Cin, 3, 3, 3), ``.conv.bias``,
``.bn.weight``, ``.bn.bias``, ``.bn.running_mean``, ``.bn.running_var``,
``head.weight`` (C, 128, 1, 1, 1) and ``head.bias``.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3
ADAM = (0.9, 0.999, 1e-8)
CHI = {"ALA": 0, "CYS": 1, "ASP": 2, "GLU": 3, "PHE": 2, "GLY": 0, "HIS": 2, "ILE": 2,
       "LYS": 4, "LEU": 2, "MET": 3, "ASN": 2, "PRO": 2, "GLN": 3, "ARG": 4, "SER": 1,
       "THR": 1, "VAL": 1, "TRP": 2, "TYR": 2}
AA1 = "ACDEFGHIKLMNPQRSTVWY"
# the amino acid of each of the 338 rotamer classes: per amino acid in AA1
# order, one class per chi-bin combination of its chi angles (one for ALA, GLY)
ROTAMER_TO_AA = np.array([i for i, res in enumerate(CHI) for _ in
                          itertools.product((1, 2, 3), repeat=CHI[res])])


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def n_blocks(weights: dict) -> int:
    return sum(1 for k in weights if k.endswith(".conv.weight"))


# the 8-bit float a gradient is kept in beside each forward 8-bit type
GRADIENT_DTYPE = {"float8_e4m3fn": "float8_e5m2"}


def _scaled_round(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` in the 8-bit float ``dtype`` with one scale for the tensor (its
    largest magnitude mapped to the type's largest), back in float32."""
    top = torch.finfo(dtype).max
    scale = t.detach().abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(torch.float32) * scale


def _rounded(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded as ``_scaled_round`` does; the gradient passes through
    the rounding unchanged."""
    return t + (_scaled_round(t.detach(), dtype) - t).detach()


class _GradientRounded(torch.autograd.Function):
    """The identity, whose incoming gradient is rounded as ``_scaled_round``
    does to ``dtype``."""

    @staticmethod
    def forward(ctx, t, dtype):
        ctx.dtype = dtype
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _scaled_round(grad, ctx.dtype), None


def _conv(x, w, b, padding, operand_dtype):
    """A convolution; with ``operand_dtype`` its inputs and weights rounded
    to it and the gradient of its output to its gradient type, the sums in
    float32."""
    if operand_dtype is None:
        return F.conv3d(x, w, b, padding=padding)
    x, w = _rounded(x, operand_dtype), _rounded(w, operand_dtype)
    y = F.conv3d(x, w, b, padding=padding)
    return _GradientRounded.apply(y, getattr(torch, GRADIENT_DTYPE[str(operand_dtype)
                                                                   .split(".")[-1]]))


def forward(weights: dict, x: torch.Tensor, train: bool = False, drop_mask=None,
            dropout_rate: float = 0.1, operand_dtype=None) -> torch.Tensor:
    """Logits (B, C) of NDHWC frames ``x``. In training, batch statistics
    (biased variance) and ``drop_mask`` ((B, 128) booleans, True keeps the
    channel) before the head; in evaluation, the running statistics."""
    h = x.to(torch.promote_types(x.dtype, torch.float32)).permute(0, 4, 1, 2, 3)
    for i in range(n_blocks(weights)):
        p = f"blocks.{i}."
        h = F.elu(_conv(h, weights[p + "conv.weight"], weights[p + "conv.bias"], 1,
                        operand_dtype))
        if train:
            mean = h.mean((0, 2, 3, 4))
            var = ((h - mean[None, :, None, None, None]) ** 2).mean((0, 2, 3, 4))
        else:
            mean, var = weights[p + "bn.running_mean"], weights[p + "bn.running_var"]
        scale = weights[p + "bn.weight"] / torch.sqrt(var + BN_EPS)
        h = (h - mean[None, :, None, None, None]) * scale[None, :, None, None, None] \
            + weights[p + "bn.bias"][None, :, None, None, None]
    if train and drop_mask is not None:
        h = torch.where(drop_mask[:, :, None, None, None], h / (1.0 - dropout_rate), 0.0)
    h = _conv(h, weights["head.weight"], weights["head.bias"], 0, operand_dtype)
    return h.mean((2, 3, 4))


def probabilities(weights: dict, x: torch.Tensor, block: int = 256, operand_dtype=None):
    """Evaluation-mode softmax of NDHWC frames, ``block`` frames at a time."""
    with torch.no_grad():
        return torch.cat([torch.softmax(forward(weights, x[s : s + block],
                                                operand_dtype=operand_dtype), -1)
                          for s in range(0, len(x), block)])


def compress(p338: torch.Tensor) -> torch.Tensor:
    """(N, 338) rotamer probabilities -> (N, 20): each amino acid's summed."""
    index = torch.as_tensor(ROTAMER_TO_AA, device=p338.device)
    out = torch.zeros((p338.shape[0], 20), dtype=p338.dtype, device=p338.device)
    return out.index_add_(1, index, p338)


def train_steps(weights: dict, batches, lr: float = 1e-3, operand_dtype=None) -> dict:
    """Training steps from ``weights`` over ``batches`` of (x, one-hot y,
    drop_mask): the loss of each step (the mean cross-entropy), every
    parameter's gradient at the first step, and the parameters after the
    last. Adam with b1 0.9, b2 0.999, eps 1e-8, written out."""
    b1, b2, eps = ADAM
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()
              if "running" not in k}
    fixed = {k: v for k, v in weights.items() if "running" in k}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grads = [], None
    for t, (x, y, mask) in enumerate(batches, start=1):
        logits = forward({**params, **fixed}, x, train=True, drop_mask=mask,
                         operand_dtype=operand_dtype)
        loss = -(y * F.log_softmax(logits, -1)).sum(-1).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(loss.item())
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in zip(params, grads)}
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[k] / (1 - b1 ** t)
                v_hat = v2[k] / (1 - b2 ** t)
                p.sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))
    return {"losses": losses, "first_grads": first_grads,
            "params": {k: p.detach() for k, p in params.items()}}


def tempered(p: torch.Tensor, temperature: float) -> torch.Tensor:
    """p^(1/T), each row renormalised."""
    q = (p / p.amax(-1, keepdim=True)) ** (1.0 / temperature)
    return q / q.sum(-1, keepdim=True)


# Philox4x32-10 (Salmon, Moraes, Dror, Shaw, SC'11), on numpy uint64 words
_PHILOX_M, _PHILOX_W, _MASK = (0xD2511F53, 0xCD9E8D57), (0x9E3779B9, 0xBB67AE85), 0xFFFFFFFF


def philox_uniforms(seed: int, n_samples: int, length: int) -> np.ndarray:
    """(n, L) float32 uniforms in [0, 1): for sample s at position l the
    first word of Philox4x32-10 with key ``seed`` (64 bits, low word first)
    and counter (l, s, 0, 0), its top 24 bits times 2^-24."""
    m = np.uint64(_MASK)
    k0, k1 = np.uint64(seed & _MASK), np.uint64((seed >> 32) & _MASK)
    c0 = np.broadcast_to(np.arange(length, dtype=np.uint64)[None, :], (n_samples, length))
    c1 = np.broadcast_to(np.arange(n_samples, dtype=np.uint64)[:, None], (n_samples, length))
    c2 = np.zeros_like(c0)
    c3 = np.zeros_like(c0)
    for r in range(10):
        if r:
            k0, k1 = (k0 + np.uint64(_PHILOX_W[0])) & m, (k1 + np.uint64(_PHILOX_W[1])) & m
        p0, p1 = c0 * np.uint64(_PHILOX_M[0]), c2 * np.uint64(_PHILOX_M[1])
        c0, c1, c2, c3 = (p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & m, (p0 >> np.uint64(32)) ^ c3 ^ k1, \
            p0 & m
    return (c0 >> np.uint64(8)).astype(np.float32) * np.float32(2.0 ** -24)


def inverse_cdf_draws(p: torch.Tensor, u: np.ndarray) -> np.ndarray:
    """(n, L) class indices: for each uniform the count of the row's
    cumulative sums (float64) at or below it; past the row's mass, 0."""
    cdf = torch.cumsum(p.double(), -1).cpu().numpy()  # (L, C)
    idx = np.empty(u.shape, np.int64)
    for l in range(cdf.shape[0]):
        idx[:, l] = np.searchsorted(cdf[l], u[:, l].astype(np.float64), side="right")
    return np.where(idx >= cdf.shape[1], 0, idx)


def norm_gap(got: float, want: float, floor: float) -> float:
    """|got - want| over the larger of ``want`` and ``floor``."""
    return abs(got - want) / max(want, floor, 1e-30)


def median(values) -> float:
    return float(np.median(np.asarray(list(values), np.float64)))
