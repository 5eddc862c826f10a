"""Distribution over `torch.distributed`: the counterpart of
`invertible_cd_tpu/parallel/`. `mesh.py`: the process layout, batches,
parameter shards and collectives; `spatial.py`: each latent's height split
over the sp axis (`spatial.spatial`); `tp.py` (imported on its own, it builds on the
models): attention heads and feed-forward features split over the tp axis
(`tensor_parallel`)."""
from .mesh import (
    Mesh,
    ShardedWeights,
    all_gather_in_order,
    all_gather_objects,
    all_reduce,
    all_reduce_mean,
    barrier,
    broadcast_object,
    gather_objects,
    gather_rows,
    initialize_distributed,
    is_main,
    latent_rows,
    local_device,
    make_mesh,
    param_sharding,
    process_local_batch_slice,
    shard_batch,
    shard_params,
    stride,
)

__all__ = [
    "Mesh",
    "ShardedWeights",
    "all_gather_in_order",
    "all_gather_objects",
    "all_reduce",
    "all_reduce_mean",
    "barrier",
    "broadcast_object",
    "gather_objects",
    "gather_rows",
    "initialize_distributed",
    "is_main",
    "latent_rows",
    "local_device",
    "make_mesh",
    "param_sharding",
    "process_local_batch_slice",
    "shard_batch",
    "shard_params",
    "stride",
]
