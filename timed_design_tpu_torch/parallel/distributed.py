"""Scale-out helpers over ``torch.distributed``: the port of
``timed_design_tpu/parallel/distributed.py``.

One process per card, the PyTorch idiom: a world of ranks joined by
``initialize_distributed`` (an explicit ``tcp://`` coordinator, or the
environment ``torchrun`` describes), NCCL between CUDA ranks and gloo
between CPU ranks. Work lists split round-robin across processes and
ragged result shards gather to every process in process order. In a
single process, with no world joined, every helper degenerates to a no-op,
so the same pipeline code runs everywhere. No helper falls back: a CUDA rank
without NCCL raises, and every collective carries the world's timeout, so
a rank that hangs fails the run instead of stalling it.
"""
from __future__ import annotations

import datetime
import os
import typing as t

import numpy as np
import torch
import torch.distributed as dist

# Every process group's timeout (the world's and the mesh's groups'): a
# collective that waits longer raises on the ranks that wait
TIMEOUT_S = 600.0


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_index() -> int:
    """This process's rank in the world (0 when no world is joined)."""
    return _world()[0]


def process_count() -> int:
    """The world's size (1 when no world is joined)."""
    return _world()[1]


def comm_device() -> torch.device:
    """The device the world's collectives run on: this rank's card under
    NCCL, the CPU under gloo (or with no world)."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: torch.device | str | None = None,
    timeout_s: float | None = None,
) -> tuple[int, int]:
    """Join the world this process belongs to; returns ``(process_index,
    process_count)``.

    ``coordinator_address`` (``host:port``, the rendezvous of rank 0) with
    ``num_processes`` and ``process_id``: ``init_process_group`` over
    ``tcp://host:port``. Without it: the world ``torchrun`` describes
    (``WORLD_SIZE`` set: ``env://``), or the world already joined, or
    ``(0, 1)`` without touching ``torch.distributed``.

    ``device`` is the rank's device (default: the card). A CUDA rank talks
    NCCL and takes the card ``LOCAL_RANK`` names (else its process id); a
    CPU rank talks gloo. A CUDA rank where NCCL is unavailable, or whose
    card does not exist, raises: it never drops to gloo or to the CPU.
    ``timeout_s`` bounds every collective of the world (default
    ``TIMEOUT_S``, read at the call)."""
    joining = coordinator_address is not None or (
        not dist.is_initialized() and "WORLD_SIZE" in os.environ)
    if not joining:
        return _world()
    device = torch.device("cuda" if device is None else device)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init = dict(init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                    rank=int(process_id))
        rank = int(process_id)
    else:
        init = dict(init_method="env://")
        rank = int(os.environ.get("RANK", 0))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank needs a CUDA device; pass device='cpu' "
                               "(--device cpu) for a gloo world on the CPU")
        if not dist.is_nccl_available():
            raise RuntimeError("NCCL is not available in this PyTorch: a CUDA rank "
                               "does not fall back to gloo")
        local = int(os.environ.get("LOCAL_RANK", rank))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} wants card {local} of {torch.cuda.device_count()}: NCCL "
                "takes one rank per card, and two ranks cannot share one")
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    timeout = datetime.timedelta(seconds=TIMEOUT_S if timeout_s is None else timeout_s)
    dist.init_process_group(backend, timeout=timeout, **init)
    return dist.get_rank(), dist.get_world_size()


def shard_work_for_host(items: t.Sequence, process_index: int | None = None,
                        process_count: int | None = None) -> list:
    """Static round-robin split of a work list (structures, pdb codes)
    across processes: process i takes items i, i + n, i + 2n, ..."""
    rank, size = _world()
    pi = rank if process_index is None else process_index
    pc = size if process_count is None else process_count
    return [x for i, x in enumerate(items) if i % pc == pi]


def gather_host_arrays(local: np.ndarray) -> np.ndarray:
    """All-gather per-process result arrays (e.g. probability shards) to
    every process, concatenated in process order. One process: identity.

    Shards may be ragged (``shard_work_for_host`` hands out uneven work):
    the lengths gather first, each shard is padded to the longest, gathered,
    and the padding cut off after the collective."""
    local = np.asarray(local)
    n = process_count()
    if n == 1:
        return local
    dev = comm_device()
    count = torch.tensor([local.shape[0]], dtype=torch.int64, device=dev)
    counts = [torch.empty_like(count) for _ in range(n)]
    dist.all_gather(counts, count)
    counts = [int(c) for c in counts]
    padded = np.zeros((max(counts), *local.shape[1:]), local.dtype)
    padded[: local.shape[0]] = local
    x = torch.from_numpy(padded).to(dev)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x)
    return np.concatenate([p[:c].cpu().numpy() for p, c in zip(parts, counts)])


def barrier(name: str = "sync") -> None:
    """Wait for every process of the world (a no-op in one process).
    ``name`` names the barrier in the error of one that times out."""
    if process_count() == 1:
        return
    try:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e
