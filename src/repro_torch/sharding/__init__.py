from repro_torch.sharding.batch import (
    ShardedBatchRunner,
    mesh_devices,
    normalize_batch_axes,
    shard_vmap,
    unsharded,
)
from repro_torch.sharding.rules import batch_axes

__all__ = [
    "ShardedBatchRunner",
    "batch_axes",
    "mesh_devices",
    "normalize_batch_axes",
    "shard_vmap",
    "unsharded",
]
