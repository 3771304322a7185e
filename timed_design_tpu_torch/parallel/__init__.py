"""Parallel: the (data, model) mesh over a torch.distributed world, one
process per card, and the scale-out helpers (the port of
``timed_design_tpu/parallel/``)."""
from .mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
)
from .distributed import (  # noqa: F401
    barrier,
    gather_host_arrays,
    initialize_distributed,
    shard_work_for_host,
)
