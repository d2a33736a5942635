"""Data parallelism and row (spatial) sharding over torch.distributed
(counterpart of footprints_tpu/parallel/).  ``dryrun`` is imported by path
(``footprints_tpu_torch.parallel.dryrun``): it builds the models."""

from .distributed import host_batch_slice, initialize, local_device, rank_seed, shutdown
from .halo import exchange_rows, gather_rows, shard_rows
from .mesh import (DATA_AXIS, SPATIAL_AXIS, Mesh, all_reduce_gradients, all_reduce_mean,
                   any_rank, barrier, make_mesh, mean_over_ranks, replica_digest,
                   replicate_tree, row_split, shard_batch, sync_batch_norm)

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate_tree",
    "initialize",
    "host_batch_slice",
    "local_device",
    "shutdown",
    "Mesh",
    "sync_batch_norm",
    "all_reduce_gradients",
    "all_reduce_mean",
    "any_rank",
    "barrier",
    "rank_seed",
    "replica_digest",
    "DATA_AXIS",
    "SPATIAL_AXIS",
    "row_split",
    "mean_over_ranks",
    "shard_rows",
    "exchange_rows",
    "gather_rows",
]
