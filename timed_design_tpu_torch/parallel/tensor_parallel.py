"""The mesh's model axis: the layers ``train/train.py::param_shardings``
splits, run split (tensor parallelism in training).

JAX's layout shards the output channels (a kernel's last axis) of every
convolution and dense kernel whose width divides the model axis, and GSPMD
inserts the collectives. Here ``shard_model_axis`` cuts each such
``Conv3d`` or ``Linear`` to this rank's slice of its output channels (torch
dim 0 of the weight, and of the bias), and the layer runs as a column of a
column-parallel pair:

  * its input passes ``_SumGradOverModel``: the identity forward, its
    gradient summed over the model group backward (each rank's slice of
    the weight gives its share of the input's gradient);
  * its output passes ``_GatherChannels``: an ``all_gather`` over the model
    group along channels forward, so every model rank carries the whole
    activation on; backward, this rank's slice of the incoming gradient.
    Every model rank computes the same downstream loss, so the gradient
    that arrives is already the whole one: ``torch.distributed.nn``'s
    ``all_gather``, whose backward sums over ranks, would scale the split
    kernels' gradients by ``n_model``.

``gather_state_dict`` puts the slices back together, so a checkpoint holds
the whole tree.
"""
from __future__ import annotations

import dataclasses
import typing as t

import torch
import torch.distributed as dist
from torch import nn

from .mesh import Mesh


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """A layer's place on the model axis: this rank's slice ``index`` of
    ``n`` equal slices of its output channels, gathered over ``group``."""

    group: t.Any
    index: int
    n: int

    def apply(self, fn: t.Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """``fn`` (the layer on its slice) on ``x``, the output gathered
        along channels (dim 1)."""
        y = fn(_SumGradOverModel.apply(x, self.group))
        return _GatherChannels.apply(y, self)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The slices of ``x`` over the model group, whole along dim 0 (a
        collective; no gradient)."""
        return _gather_slices(x, self)


def _gather_slices(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(shard.n)]
    dist.all_gather(parts, x, group=shard.group)
    return torch.cat(parts, dim=0)


class _SumGradOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, shard):
        ctx.shard = shard
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(shard.n)]
        dist.all_gather(parts, y, group=shard.group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        shard = ctx.shard
        c = grad.shape[1] // shard.n
        return grad.narrow(1, shard.index * c, c), None


def model_sharded(layer: nn.Module, n_model: int) -> bool:
    """Does the layout split ``layer`` over a model axis of ``n_model``? A
    convolution or dense layer whose output width divides it (JAX's rule on
    the Flax ``kernel``'s last axis)."""
    return (n_model > 1 and isinstance(layer, (nn.Conv3d, nn.Linear))
            and layer.weight.shape[0] % n_model == 0)


def shard_model_axis(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut every layer ``model_sharded`` marks to this rank's slice of its
    output channels (new parameters: build the optimizer after this) and
    mark it with its ``ModelShard``; returns ``module``. A no-op on a model
    axis of 1."""
    n = mesh.shape["model"]
    for layer in module.modules():
        if not model_sharded(layer, n):
            continue
        c = layer.weight.shape[0] // n
        lo = mesh.model_index * c
        with torch.no_grad():
            layer.weight = nn.Parameter(layer.weight[lo : lo + c].clone())
            if layer.bias is not None:
                layer.bias = nn.Parameter(layer.bias[lo : lo + c].clone())
        layer.model_shard = ModelShard(mesh.model_group, mesh.model_index, n)
    return module


def gather_state_dict(module: nn.Module, tensors: dict) -> dict:
    """``tensors`` (a state dict of ``module``, or its gradients under the
    same names) with the slices of every split layer gathered whole over
    the model group: a collective, so every rank of the group calls it."""
    out = dict(tensors)
    for name, layer in module.named_modules():
        shard = getattr(layer, "model_shard", None)
        if shard is None:
            continue
        for leaf in ("weight", "bias"):
            key = f"{name}.{leaf}" if name else leaf
            if key not in out:
                continue
            out[key] = _gather_slices(out[key], shard)
    return out
