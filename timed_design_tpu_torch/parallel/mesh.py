"""The (data, model) mesh over a ``torch.distributed`` world: the port of
``timed_design_tpu/parallel/mesh.py``.

The JAX mesh is one controller over many devices; here it is one process
per card. ``make_mesh`` lays ``n_data x n_model`` ranks out row-major, as
``np.array(devices).reshape(n_data, n_model)`` lays out the JAX devices:
the rank at position p is data index ``p // n_model`` and model index
``p % n_model``. Each rank holds two process groups: its model column, the
ranks of its model index (the **data group**: the batch is split over it,
and BatchNorm statistics, gradients and metrics are summed over it), and
its data row, the ranks of its data index (the **model group**: the output
channels of the layers ``param_shardings`` marks are split over it). Every
rank sees the same global batch and takes its own rows (``shard_batch``).

With no world joined, ``make_mesh()`` is a one-rank mesh with no groups and
every reduction over it is the identity.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
import typing as t

import numpy as np
import torch
import torch.distributed as dist

from . import distributed
from .distributed import _world, comm_device, initialize_distributed


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of the mesh: ``shape`` ``{"data": n, "model": m}``,
    the mesh's world ranks in row-major order, this process's rank, the
    device its collectives run on (None with no world) and its groups
    (None with no world)."""

    shape: dict
    ranks: tuple
    rank: int = 0
    device: torch.device | None = None
    data_group: t.Any = None
    model_group: t.Any = None
    group: t.Any = None  # every rank of the mesh

    @property
    def data_index(self) -> int:
        return self.ranks.index(self.rank) // self.shape["model"]

    @property
    def model_index(self) -> int:
        return self.ranks.index(self.rank) % self.shape["model"]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A layout on the mesh: ``spec`` names the mesh axis each array axis is
    split over (``None``: not split; ``()``: replicated), as JAX's
    ``NamedSharding(mesh, PartitionSpec(...))`` does."""

    mesh: Mesh
    spec: tuple


def make_mesh(
    n_data: int | None = None,
    n_model: int = 1,
    devices: t.Sequence[int] | None = None,
    timeout_s: float | None = None,
) -> Mesh:
    """Build a (data, model) mesh over the world's ranks (``devices``: the
    world ranks to lay it over, one card each; default every rank).

    Defaults to every rank on the data axis: the layout for batched frame
    inference and training with replicated weights. Every rank of the world
    calls it (process groups are made collectively); a mesh the world
    cannot hold raises, and so does a rank outside the mesh it asked for.
    ``timeout_s`` bounds every collective of the mesh's groups (default
    the world's ``TIMEOUT_S``, read at the call)."""
    rank, world = _world()
    devices = list(range(world) if devices is None else devices)
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_data * n_model > len(devices):
        # an empty (0, n_model) mesh would crash far away (a division by
        # shape['data'] in fit/evaluate)
        raise ValueError(
            f"mesh ({n_data} data x {n_model} model) needs "
            f"{max(n_data, 1) * n_model} devices; only {len(devices)} "
            f"available"
        )
    use = tuple(int(r) for r in devices[: n_data * n_model])
    shape = {"data": n_data, "model": n_model}
    if not dist.is_initialized():
        return Mesh(shape, use, rank)
    timeout = datetime.timedelta(seconds=distributed.TIMEOUT_S if timeout_s is None else timeout_s)
    grid = np.array(use).reshape(n_data, n_model)
    # new_group is collective over the whole world: every rank makes every
    # group, in the same order, and keeps its own
    data_groups = [dist.new_group(grid[:, m].tolist(), timeout=timeout) for m in range(n_model)]
    model_groups = [dist.new_group(grid[d].tolist(), timeout=timeout) for d in range(n_data)]
    group = dist.new_group(list(use), timeout=timeout)
    if rank not in use:
        raise ValueError(f"rank {rank} is not in the mesh over ranks {list(use)}")
    p = use.index(rank)
    return Mesh(shape, use, rank, comm_device(), data_groups[p % n_model],
                model_groups[p // n_model], group)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding over the data axis (frames/batch)."""
    return NamedSharding(mesh, ("data",))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def shard_batch(x, mesh: Mesh):
    """This rank's rows of a global batch (numpy or torch), split along axis
    0 over the data axis. The batch must divide the data-axis size; the
    engine pads batches to a fixed size, so this holds by construction."""
    n_data = mesh.shape["data"]
    if x.shape[0] % n_data:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split over {n_data} "
                         "data ranks")
    b = x.shape[0] // n_data
    return x[mesh.data_index * b : (mesh.data_index + 1) * b]


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from the mesh's
    first rank, so that every rank holds the same weights; returns
    ``module``."""
    if mesh.group is None:
        return module
    with torch.no_grad():
        for tensor in [*module.parameters(), *module.buffers()]:
            dist.broadcast(tensor.data, src=mesh.ranks[0], group=mesh.group)
    return module


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced in place over ``group`` (a mesh's data or model
    group); the identity where the mesh has no groups. Returns ``x``."""
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


_ACTIVE: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar(
    "td_active_mesh", default=None)


def active_mesh() -> Mesh | None:
    """The mesh set by the innermost ``batch_over`` of this thread: the
    forward in progress runs on this rank's rows of a batch split over its
    data axis."""
    return _ACTIVE.get()


@contextlib.contextmanager
def batch_over(mesh: Mesh | None):
    """Inside, a forward runs on this rank's rows of a batch split over
    ``mesh``'s data axis: training-mode BatchNorm takes its statistics, and
    an ``int8`` convolution its activation scale, over the global batch.
    None: a batch of one device. Per thread, like ``quantized_convs``."""
    token = _ACTIVE.set(mesh)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def launched_mesh(device: torch.device | str):
    """Inside, the mesh over the world ``torchrun`` launched this process
    into (``WORLD_SIZE`` set), every rank on the data axis: the counterpart
    of JAX's ``make_mesh()`` over every local chip; the world is left on the
    way out. Outside ``torchrun``: None, and no world is joined."""
    if "WORLD_SIZE" not in os.environ:
        yield None
        return
    initialize_distributed(device=device)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()
