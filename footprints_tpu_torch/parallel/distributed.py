"""Process-group set-up and per-rank input slices (counterpart of
footprints_tpu/parallel/distributed.py).

One process drives one card.  ``torchrun`` (``python -m
torch.distributed.run``) starts the processes and gives each its
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``; ``initialize`` reads them through the ``env://`` method,
or takes an explicit ``init_method`` (``tcp://localhost:<port>``, a
``file://`` store), world size and rank.  A plain ``python -m`` run has
none of them and stays the one-device run: ``initialize`` is then a no-op,
as JAX's is in a single process.

Input contract: every rank loads only its rows of the global batch
(``host_batch_slice``; ``data/loader.py``'s ``shard``).  JAX's
``global_batch_from_local`` has no counterpart: it assembles one global
``jax.Array`` from the hosts' shards, whereas here a rank's tensor simply
is its shard, and the collectives (parallel/mesh.py) see to the rest.
"""

import os

import torch
import torch.distributed as dist


def _under_launcher():
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def local_device(device="cuda"):
    """The card this process drives.  Under torchrun a bare ``cuda`` means
    ``cuda:{LOCAL_RANK}``; an explicit index or the CPU is kept.  Raises
    when ``LOCAL_RANK`` names a card the host does not have."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or "LOCAL_RANK" not in os.environ:
        return device
    local_rank = int(os.environ["LOCAL_RANK"])
    count = torch.cuda.device_count()
    if local_rank >= count:
        raise RuntimeError(f"LOCAL_RANK {local_rank} names cuda:{local_rank}, but this "
                           f"host has {count} CUDA device(s): start at most {count} "
                           f"processes a host (--nproc_per_node)")
    return torch.device("cuda", local_rank)


def initialize(backend=None, init_method=None, world_size=None, rank=None, *,
               device="cuda"):
    """``torch.distributed.init_process_group`` (no-op in a single process
    without torchrun's environment, or when a group is already up).

    ``backend`` defaults to NCCL for a CUDA ``device`` and gloo for the CPU;
    gloo on CUDA tensors runs several ranks on one card (the collectives
    then pass through host memory).  Returns True when a group is up."""
    if dist.is_initialized():
        return True
    if init_method is None and world_size is None and not _under_launcher():
        return False
    device = local_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)  # NCCL binds the current device
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank)
    return True


def shutdown():
    """Destroy the process group, if one is up (the end of a torchrun run)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_seed(seed, shard):
    """A dataset's augmentation seed for ``shard`` = (rank, world size):
    ``seed`` in a world of one, ``(seed, rank)`` under data parallelism, so
    the ranks draw differently (in distribution as world 1 does, not the
    same draws)."""
    rank, world_size = shard
    return seed if world_size == 1 else (seed, rank)


def host_batch_slice(global_batch_size: int, world_size=None, rank=None):
    """(start, size) of this rank's slice of the global batch dimension
    (the group's world and rank unless given)."""
    if world_size is None:
        rank, world_size = ((dist.get_rank(), dist.get_world_size())
                            if dist.is_initialized() else (0, 1))
    if global_batch_size % world_size:
        raise AssertionError(
            f"global batch {global_batch_size} must divide over {world_size} hosts")
    per = global_batch_size // world_size
    return rank * per, per
