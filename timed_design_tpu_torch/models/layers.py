"""Building blocks of the 3D-CNN zoo (PyTorch).

The port of ``timed_design_tpu/models/layers.py``. Modules take NCDHW
tensors; the model's public forward takes the JAX layout NDHWC and views it
as NCDHW without a copy (the channels_last_3d memory format). Parameters
are float32 and are cast to the compute dtype at each call, as Flax's
``dtype``/``param_dtype`` pair does. BatchNorm, pooling and the heads run in
float32 (``at_least_float32``), or in float64 for a float64 module. Every
convolution of the zoo and of the Keras graph executor
(``models/keras_import.py``) goes through ``conv3d``, which runs the mode of
``models/quantize.py::quantized_convs`` when one is set. Under a mesh
(``parallel/``), training-mode BatchNorm takes its statistics over the
global batch, and a layer ``parallel/tensor_parallel.py`` split over the
model axis runs on its slice and gathers its output.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import active_mesh, all_reduce
from .quantize import Padding, current_mode, float_conv3d, quantized_conv3d


class BatchNorm3d(nn.BatchNorm3d):
    """``nn.BatchNorm3d`` with Flax's training statistics.

    In training the batch is normalised with its biased variance, and the
    running mean and variance move towards the batch mean and that same
    biased variance: ``running = m * running + (1 - m) * batch`` with
    Flax's momentum m (``momentum`` here is ``1 - m``, PyTorch's
    convention). ``nn.BatchNorm3d`` would move ``running_var`` towards the
    unbiased variance, n/(n-1) times larger. On the card the normalising
    kernel also gives the statistics, into buffers of momentum 1 (its
    variance unbiased, rescaled by (n-1)/n): no pass of their own, which
    cost 1.75 ms of a 36 ms bfloat16 step of registry TIMED at batch 256 on
    an H100. On the CPU they take a pass
    of their own (``torch.var_mean``): the CPU kernel's mean is a float32
    running sum, 2e-7 off at 6,000 values a channel, where the running
    statistics are held to 1e-6. In evaluation it is ``nn.BatchNorm3d``
    unchanged.

    Under a mesh (``parallel/mesh.py::batch_over``) the batch is split over
    the data group, and the statistics are the global batch's, as GSPMD
    takes them from a sharded batch (``_GlobalBatchNorm``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mesh = active_mesh()
        if mesh is not None:
            out, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps,
                                                    mesh.data_group)
        elif x.is_cuda:
            mean, var = torch.zeros_like(self.running_mean), torch.zeros_like(self.running_var)
            out = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
            n = x.numel() // x.shape[1]
            var = var * ((n - 1) / n)  # not in place: the backward reads the buffer
        else:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3, 4), correction=0)
            out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return out


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode batch normalisation of this rank's rows of a batch
    split over ``group``, with the global batch's statistics: per channel
    the sum and the sum of squares, summed over the group in float64, over
    the count (every rank holds as many rows, ``shard_batch``), then Flax's
    fast variance ``E[x^2] - E[x]^2`` clipped at 0
    (``flax/linen/normalization.py::_compute_stats``,
    ``use_fast_variance=True``) and Flax's ``(x - mean) * (rsqrt(var + eps)
    * scale) + bias``. Never a mean of per-rank means. Backward sums
    ``sum(dy)`` and ``sum(dy * (x - mean))`` over the group for the input's
    gradient; the scale's and the bias's gradients stay this rank's share,
    summed with every other gradient over the data group after the step's
    backward. Returns (out, mean, biased variance).

    On the card each pass is one of PyTorch's batch-norm kernels (those
    ``nn.SyncBatchNorm`` runs; CUDA only): a rank's sums come from its
    Welford mean and variance, and the normalisation and the two backward
    passes are fused. On the CPU the same arithmetic is plain tensor code,
    its sums accumulated in float64. In plain float32 on an H100, a sum over
    the 2.4 M values a channel of registry TIMED at batch 256 put a
    BatchNorm bias's gradient 2.3e-4 of itself from a float64 step, and the
    plain passes took the bfloat16 step from 34.5 to 67.9 ms."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c, dims = x.shape[1], (0, 2, 3, 4)
        m = x.numel() // c
        n = m * (1 if group is None else dist.get_world_size(group))
        if x.is_cuda:
            x = _fused_layout(x)
            mean, invstd = torch.batch_norm_stats(x, eps)
            mean, var = mean.double(), invstd.double().pow(-2) - eps
            local = torch.cat([mean * m, (var + mean * mean) * m])
        else:
            local = torch.cat([x.sum(dims, dtype=torch.float64),
                               (x * x).sum(dims, dtype=torch.float64)])
        stats = all_reduce(local, group) / n
        mean = stats[:c]
        var = (stats[c:] - mean * mean).clamp_min(0.0)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        invstd = torch.rsqrt(var + eps)
        if x.is_cuda:
            out = torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
        else:
            shape = (1, c, 1, 1, 1)
            out = (x - mean.view(shape)) * (invstd * weight).view(shape) + bias.view(shape)
        ctx.save_for_backward(x, mean, invstd, weight)
        ctx.n, ctx.group = n, group
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, grad, _mean, _var):
        x, mean, invstd, weight = ctx.saved_tensors
        c, dims = x.shape[1], (0, 2, 3, 4)
        if x.is_cuda:
            grad = _fused_layout(grad)
            sum_dy, sum_dy_xmu, d_weight, d_bias = torch.batch_norm_backward_reduce(
                grad, x, mean, invstd, weight, True, True, True)
            sums = all_reduce(torch.cat([sum_dy, sum_dy_xmu]), ctx.group)
            count = torch.full((1,), ctx.n, dtype=torch.int32, device=x.device)
            dx = torch.batch_norm_backward_elemt(grad, x, mean, invstd, weight, sums[:c],
                                                 sums[c:], count)
            return dx, d_weight, d_bias, None, None
        shape = (1, c, 1, 1, 1)
        x_mu = x - mean.view(shape)
        local = torch.cat([grad.sum(dims, dtype=torch.float64),
                           (grad * x_mu).sum(dims, dtype=torch.float64)])
        sums = (all_reduce(local.clone(), ctx.group) / ctx.n).to(x.dtype)
        local = local.to(x.dtype)
        x_hat = x_mu * invstd.view(shape)
        dx = (weight * invstd).view(shape) * (
            grad - sums[:c].view(shape) - x_hat * (sums[c:] * invstd).view(shape))
        return dx, local[c:] * invstd, local[:c], None, None


def _fused_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` in a memory format PyTorch's batch-norm kernels take:
    contiguous or channels-last, as it is, else made contiguous."""
    if t.is_contiguous() or t.is_contiguous(memory_format=torch.channels_last_3d):
        return t
    return t.contiguous()


def at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or kept in float64: the dtype of BatchNorm,
    pooling and the heads, whatever the convolutions' compute dtype."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class ConvBlock(nn.Module):
    """[Conv3D 3x3x3 'same' -> ELU -> BatchNorm], BatchNorm in float32."""

    def __init__(self, in_features: int, features: int, bn_momentum: float = 0.99):
        super().__init__()
        self.conv = nn.Conv3d(in_features, features, 3, padding=1)
        # Keras momentum 0.99 is PyTorch momentum 0.01; Keras epsilon 1e-3
        self.bn = BatchNorm3d(features, eps=1e-3, momentum=1.0 - bn_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.elu(cast_conv(self.conv, x, padding=1))
        return self.bn(at_least_float32(x)).to(x.dtype)


def conv3d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
           padding: Padding = 0, stride=1, dilation=1, name: str | None = None) -> torch.Tensor:
    """The zoo's convolution: ``x`` (B, C, D, H, W) with ``weight`` and
    ``bias`` cast to ``x``'s dtype; quantized when a mode of
    ``quantized_convs`` is set on this thread. ``padding``: an int, three
    ints, or three (lo, hi) pairs (an asymmetric one is padded with zeros
    first); ``stride`` and ``dilation``: an int or three ints. ``name`` (the
    layer) goes into the error of a convolution the int8 kernel cannot
    take."""
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    mode = current_mode()
    if mode is None:
        return float_conv3d(x, w, b, padding, stride, dilation)
    return quantized_conv3d(mode, x, w, b, padding, stride, dilation, name)


def cast_conv(conv: nn.Conv3d, x: torch.Tensor, padding: int = 0,
              bias: bool = True) -> torch.Tensor:
    """``conv`` applied in ``x``'s dtype, its float32 parameters cast; on
    its slice, the output gathered, where the model axis splits it. Without
    ``bias`` the convolution leaves its bias out (``whole_bias`` gives it)."""
    b = conv.bias if bias else None
    shard = getattr(conv, "model_shard", None)
    if shard is None:
        return conv3d(x, conv.weight, b, padding)
    return shard.apply(lambda h: conv3d(h, conv.weight, b, padding), x)


def whole_bias(conv: nn.Conv3d) -> torch.Tensor | None:
    """``conv``'s float32 bias over all its output channels: on a layer the
    model axis splits, its slices gathered over the model group (a
    collective)."""
    shard = getattr(conv, "model_shard", None)
    return conv.bias if shard is None or conv.bias is None else shard.gather(conv.bias)


def cast_linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` applied in ``x``'s dtype, its float32 parameters cast; on
    its slice, the output gathered, where the model axis splits it."""
    def fn(h):
        return F.linear(h, layer.weight.to(h.dtype), layer.bias.to(h.dtype))

    shard = getattr(layer, "model_shard", None)
    return fn(x) if shard is None else shard.apply(fn, x)


def dropout(
    x: torch.Tensor, rate: float, training: bool,
    generator: torch.Generator | None = None, noise_shape: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """Keras/Flax dropout: each element of a mask of ``noise_shape`` (default
    ``x``'s shape, broadcast over ``x``) keeps its values with probability
    1 - ``rate``, scaled by 1 / (1 - ``rate``), and zeroes them otherwise.
    The mask is drawn from ``generator`` (on ``x``'s device)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(noise_shape or x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def spatial_dropout_3d(
    x: torch.Tensor, rate: float, training: bool,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """SpatialDropout3D on NDHWC: drops whole channels (Keras semantics),
    with noise shape (B, 1, 1, 1, C)."""
    return dropout(x, rate, training, generator, (x.shape[0], 1, 1, 1, x.shape[-1]))


def global_average_pool_3d(x: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) -> (B, C) mean over the spatial dims."""
    return x.mean(dim=(2, 3, 4))
