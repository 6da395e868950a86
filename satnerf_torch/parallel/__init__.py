"""Data parallelism over ``torch.distributed`` (port of
``satnerf_tpu/parallel``): one process per rank, the batch rows sharded,
the state replicated."""

from satnerf_torch.parallel.mesh import (  # noqa: F401
    DataParallel,
    all_reduce_grads,
    gather_rows,
    make_mesh,
    replicated,
    shard_batch,
)
from satnerf_torch.parallel.multihost import (  # noqa: F401
    initialize_multihost,
    launch_local_ranks,
    local_batch_slice,
    process_group,
    rank_device,
)
