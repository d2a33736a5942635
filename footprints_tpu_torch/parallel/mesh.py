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

JAX's ``replicated`` and ``batch_sharded`` name ``NamedSharding``s and have
no counterpart: a tensor here is either a rank's full replica or its shard.
The ``spatial`` axis (image rows over cards, with a halo exchange at every
conv) is not ported yet.
"""

import dataclasses
import hashlib

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ..utils import select_device
from .distributed import host_batch_slice, local_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the data-parallel world.  ``group`` is None in
    a single process, and every collective below is then a no-op."""
    world_size: int
    rank: int
    device: torch.device
    group: object = None  # the process group of the all-reduces
    side_group: object = None  # gloo, for host-side agreement

    @property
    def distributed(self):
        return self.group is not None

    @property
    def shard(self):
        """(rank, world size): a DataLoader's ``shard``."""
        return self.rank, self.world_size

    def __str__(self):
        backend = dist.get_backend(self.group) if self.distributed else "no group"
        return f"rank {self.rank} of {self.world_size} on {self.device} over {backend}"


def make_mesh(device=None, *, spatial: int = 1) -> Mesh:
    """The mesh of this process: the group that ``initialize`` set up, or a
    world of one.  ``device`` (default ``cuda``) goes through
    ``local_device`` and ``utils.select_device``.  Opening the side group is
    a collective: every rank calls ``make_mesh`` once, in the same order."""
    if spatial != 1:
        raise NotImplementedError("spatial sharding is not ported yet")
    device = select_device(local_device("cuda" if device is None else device))
    if not dist.is_initialized():
        return Mesh(1, 0, device)
    return Mesh(dist.get_world_size(), dist.get_rank(), device, dist.group.WORLD,
                dist.new_group(backend="gloo"))


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
    """This rank's rows of a global host batch (a dict of numpy arrays), as
    tensors on its device."""
    n = len(next(iter(host_batch.values())))
    start, per = host_batch_slice(n, mesh.world_size, mesh.rank)
    return {k: torch.from_numpy(np.ascontiguousarray(v[start:start + per])).to(mesh.device)
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
