"""The data-parallel layout and its collectives (counterpart of
footprints_tpu/parallel/mesh.py).

Scaling model: one process per card, each holding a full replica of the
params, BN state and Adam state, and ``1/world`` of every global batch
(dim 0).  The JAX package states this as shardings on one jitted program,
and XLA inserts the all-reduces; here each rank runs the single-device
step on its shard, with the collectives written out:

  * train-mode BN takes its mean and variance over the **global** batch
    (``sync_batch_norm`` hands the group to every BN; nn/layers.py does the
    two all-reduces), as the sharded JAX step does;
  * after backward the gradients are averaged over the ranks in one flat
    bucket (``all_reduce_gradients``), which is the gradient of the global
    batch's loss, since every loss term is a mean over equal shards;
  * Adam then runs identically on every rank, so the replicas stay bitwise
    equal (``replica_digest`` checks that).

Host-side agreement (the preemption flag, the checkpoint barrier) goes over
a gloo side group, so it syncs no device.

The ``spatial`` axis (``make_mesh(spatial=k)``) lays the ranks out as the
JAX mesh's ``(data, spatial)`` device array, ``reshape(world // k, k)``:
rank ``r`` holds the images of data index ``r // k`` and the rows of row
index ``r % k``, computed with a halo exchange at every op that reads
across rows (parallel/halo.py), in the eval and the train steps.  Train-mode
BN's statistics are then the global batch's as well (every rank holds
distinct, equal-sized pixels of it), and the exchanges' adjoints make the
world mean of ``all_reduce_gradients`` the global loss's gradient, so after
Adam every rank of the data x spatial world holds the same replica.

JAX's ``replicated`` and ``batch_sharded`` name ``NamedSharding``s; here a
tensor is a rank's full replica (params, BN state, the eval step's losses)
or its shard of the batch (``shard_batch``: dim 0 over data, and on a
spatial mesh dim 1, the image rows, over spatial).
"""

import dataclasses
import hashlib

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ..utils import select_device
from .distributed import host_batch_slice, local_device

# the JAX mesh's axis names (footprints_tpu/parallel/mesh.py)
DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
# the encoder's total stride: a rank's first row must be a multiple of it,
# so that every pyramid level of every rank lines up with the global grid
ROW_ALIGN = 32


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the world.  ``group`` is None in a single
    process, and every collective below is then a no-op.  On a spatial
    mesh (``spatial > 1``) the rank's row index is ``rank % spatial``, its
    ``spatial_group`` the ranks that share its images (one row shard each)
    and its ``data_group`` the ranks that share its row index."""
    world_size: int
    rank: int
    device: torch.device
    group: object = None  # the process group of the all-reduces (the world)
    side_group: object = None  # gloo, for host-side agreement
    spatial: int = 1
    spatial_group: object = None
    data_group: object = None

    @property
    def distributed(self):
        return self.group is not None

    @property
    def row_rank(self):
        """This rank's row index: its shard of the image rows."""
        return self.rank % self.spatial

    @property
    def shard(self):
        """(data index, number of data indices): a DataLoader's ``shard``;
        (rank, world size) when ``spatial`` is 1."""
        return self.rank // self.spatial, self.world_size // self.spatial

    def __str__(self):
        backend = dist.get_backend(self.group) if self.distributed else "no group"
        rows = (f", row shard {self.row_rank} of {self.spatial}" if self.spatial > 1
                else "")
        return (f"rank {self.rank} of {self.world_size}{rows} on {self.device} "
                f"over {backend}")


def make_mesh(device=None, *, spatial: int = 1) -> Mesh:
    """The mesh of this process: the group that ``initialize`` set up, or a
    world of one.  ``device`` (default ``cuda``) goes through
    ``local_device`` and ``utils.select_device``.  ``spatial=k`` shards the
    image rows over k ranks, laid out as JAX's ``make_mesh(devices,
    spatial=k)``; the world must divide by k.  Opening the groups is a
    collective: every rank calls ``make_mesh`` once, in the same order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if spatial < 1 or world % spatial:
        raise ValueError(f"{world} devices not divisible by spatial={spatial}")
    device = select_device(local_device("cuda" if device is None else device))
    if not dist.is_initialized():
        return Mesh(1, 0, device)
    rank, side = dist.get_rank(), dist.new_group(backend="gloo")
    if spatial == 1:
        return Mesh(world, rank, device, dist.group.WORLD, side, data_group=dist.group.WORLD)
    layout = np.arange(world).reshape(world // spatial, spatial)
    data_groups = [dist.new_group(column.tolist()) for column in layout.T]
    spatial_groups = [dist.new_group(row.tolist()) for row in layout]
    return Mesh(world, rank, device, dist.group.WORLD, side, spatial,
                spatial_groups[rank // spatial], data_groups[rank % spatial])


def row_split(mesh: Mesh, height: int):
    """(first row, rows) of this rank's shard of ``height`` image rows.
    Rows split evenly, as JAX's ``batch_sharded`` splits them, and each
    rank's first row must be a multiple of ROW_ALIGN (the encoder's total
    stride): ``height % (32 * spatial) == 0``.  JAX pads an uneven split;
    this raises instead."""
    if height % (ROW_ALIGN * mesh.spatial):
        raise ValueError(f"row sharding needs the image height to be a multiple of "
                         f"{ROW_ALIGN} x spatial = {ROW_ALIGN * mesh.spatial}, so that each "
                         f"of the {mesh.spatial} row shards starts at a multiple of the "
                         f"encoder's stride {ROW_ALIGN}; got {height}")
    rows = height // mesh.spatial
    return mesh.row_rank * rows, rows


def _group_for(mesh, tensor):
    """NCCL takes only CUDA tensors; a CPU tensor goes over the side group."""
    if tensor.is_cuda or dist.get_backend(mesh.group) == "gloo":
        return mesh.group
    return mesh.side_group


def replicate_tree(mesh: Mesh, module_or_optimizer):
    """Broadcast rank 0's params and buffers (a module) or state (an
    optimizer) to every rank, in place; returns its argument."""
    if not mesh.distributed:
        return module_or_optimizer
    if isinstance(module_or_optimizer, nn.Module):
        tensors = [*module_or_optimizer.parameters(), *module_or_optimizer.buffers()]
    else:
        tensors = [v for group in module_or_optimizer.param_groups
                   for p in group["params"]
                   for v in module_or_optimizer.state.get(p, {}).values()
                   if isinstance(v, torch.Tensor)]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0, group=_group_for(mesh, t))
    return module_or_optimizer


def shard_batch(mesh: Mesh, host_batch):
    """This rank's shard of a global host batch (a dict of numpy arrays),
    as tensors on its device: its slice of dim 0 and, on a spatial mesh,
    its rows of dim 1 (the image rows, ``row_split`` of ``image``'s height;
    a packed target's rows in proportion; a 1-D array whole), as the
    addressable shards of JAX's ``shard_batch`` on the same mesh."""
    n = len(next(iter(host_batch.values())))
    data_index, data_size = mesh.shard
    start, per = host_batch_slice(n, data_size, data_index)
    rows = {}
    if mesh.spatial > 1:
        height = host_batch["image"].shape[1]
        first, count = row_split(mesh, height)
        for k, v in host_batch.items():
            if v.ndim < 2:
                continue
            scale = height // v.shape[1]
            if v.shape[1] * scale != height:
                raise ValueError(f"{k}: {v.shape[1]} rows do not divide the image's {height}")
            rows[k] = slice(first // scale, (first + count) // scale)
    return {k: torch.from_numpy(np.ascontiguousarray(
                v[start:start + per, rows.get(k, slice(None))])).to(mesh.device)
            for k, v in host_batch.items()}


def sync_batch_norm(module: nn.Module, mesh: Mesh):
    """Hand the mesh's group to every ``nn.BatchNorm2d`` of ``module``, so
    that train-mode BN (nn/resnet.py -> nn/layers.py:batch_norm) takes its
    statistics over the global batch.  A world of one without a group
    leaves today's ``F.batch_norm``.  Returns ``module``."""
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.dp_group = mesh.group
    return module


def all_reduce_gradients(mesh: Mesh, params):
    """Average the ``.grad`` of ``params`` over the ranks: one all-reduce
    of one flat bucket after backward, then one multi-tensor copy back."""
    if not mesh.distributed:
        return
    # a named span for the profiler (chip_smoke.py's phase dp reads it)
    with torch.profiler.record_function("all_reduce_gradients"):
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.world_size)
        parts = flat.split([g.numel() for g in grads])
        torch._foreach_copy_(grads, [t.view_as(g) for t, g in zip(parts, grads)])


def mean_over_ranks(mesh: Mesh, losses):
    """A dict of scalar tensors averaged over the ranks in one all-reduce
    (``losses`` itself in a single process).  Every rank's value is a mean
    over an equal shard of the global batch, so this is the global mean,
    the same on every rank, as JAX returns it replicated."""
    if not mesh.distributed:
        return losses
    names = list(losses)
    means = all_reduce_mean(mesh, torch.stack([losses[k] for k in names]))
    return dict(zip(names, means.unbind()))


def all_reduce_mean(mesh: Mesh, tensor):
    """The mean of ``tensor`` over the ranks (a new tensor)."""
    if not mesh.distributed:
        return tensor
    out = tensor.clone()
    dist.all_reduce(out, group=_group_for(mesh, out))
    return out.div_(mesh.world_size)


def any_rank(mesh: Mesh, flag: bool) -> bool:
    """True when ``flag`` is set on any rank (over the side group)."""
    if not mesh.distributed:
        return flag
    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.side_group)
    return bool(t.item())


def barrier(mesh: Mesh):
    """Wait for every rank (over the side group)."""
    if mesh.distributed:
        dist.barrier(group=mesh.side_group)


def replica_digest(module: nn.Module, optimizer=None):
    """sha256 over the bytes of every param, buffer and optimizer state
    tensor, in a fixed order: equal on two ranks iff their replicas are
    bitwise equal."""
    h = hashlib.sha256()
    tensors = [*module.parameters(), *module.buffers()]
    if optimizer is not None:
        tensors += [v for group in optimizer.param_groups for p in group["params"]
                    for _, v in sorted(optimizer.state.get(p, {}).items())
                    if isinstance(v, torch.Tensor)]
    for t in tensors:
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()
