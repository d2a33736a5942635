"""Rank functions for the data-parallel tests (tests/test_torch_parallel.py),
run by footprints_tpu_torch.parallel.dryrun.spawn in processes joined over
gloo.  Imports no JAX: each returns numpy arrays and floats, which the test
holds against the JAX package in its own process."""

import numpy as np
import torch
import torch.distributed as dist

from footprints_tpu_torch.model_manager import ModelManager
from footprints_tpu_torch.models import Segmentor
from footprints_tpu_torch.nn import layers
from footprints_tpu_torch.parallel import (all_reduce_mean, replica_digest, replicate_tree,
                                           shard_batch, sync_batch_norm)
from footprints_tpu_torch.preprocessing.segmentation import trainer as seg_trainer
from footprints_tpu_torch.train import step as tstep

SEG_SEED = 10


def _rows(mesh, a):
    per = len(a) // mesh.world_size
    return a[mesh.rank * per:(mesh.rank + 1) * per]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def bn_rank(mesh, x, scale, bias, mean, var, cotangent):
    """Global-batch train-mode BN of this rank's rows of the NHWC ``x``,
    then backward of sum(y * cotangent): this rank's y and x gradient, the
    weight and bias gradients summed over the ranks, the running stats."""
    xr = _nchw(_rows(mesh, x)).requires_grad_()
    w = torch.from_numpy(scale).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    rm, rv = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
    y = layers.batch_norm(xr, w, b, rm, rv, training=True, group=mesh.group)
    (y * _nchw(_rows(mesh, cotangent))).sum().backward()
    wb = torch.cat([w.grad, b.grad])
    dist.all_reduce(wb, group=mesh.group)
    return {"y": y.detach().permute(0, 2, 3, 1).numpy(),
            "dx": xr.grad.permute(0, 2, 3, 1).numpy(),
            "dw": wb[:len(scale)].numpy(), "db": wb[len(scale):].numpy(),
            "mean": rm.numpy(), "var": rv.numpy()}


def _step_result(mesh, net, optimizer, metrics):
    """The ranks' mean of each loss term, and from rank 0 the (averaged)
    gradients and the BN running stats; the replica digest from every rank."""
    names = sorted(k for k in metrics if k != "lr")
    losses = all_reduce_mean(mesh, torch.stack([metrics[k] for k in names]))
    out = {"losses": dict(zip(names, losses.tolist())), "lr": metrics["lr"],
           "digest": replica_digest(net, optimizer)}
    if mesh.rank == 0:
        out["grads"] = {n: p.grad.numpy().copy() for n, p in net.named_parameters()
                        if p.grad is not None}
        out["state_dict"] = {k: v.numpy().copy() for k, v in net.state_dict().items()}
    return out


def footprint_step_rank(mesh, state_dict_path, batch, global_bn=True):
    """One data-parallel train step of FootprintNetwork-18 (the weights in
    ``state_dict_path``) on this rank's rows of ``batch``; BN over the
    global batch, or over each rank's rows alone (``global_bn=False``, the
    statistics DDP would take by default)."""
    mm = ModelManager(depth=18, steps_per_epoch=5, device="cpu")
    mm.net.load_state_dict(torch.load(state_dict_path), strict=True)
    if global_bn:
        sync_batch_norm(mm.net, mesh)
    replicate_tree(mesh, mm.net)
    step_fn = tstep.build_train_step(mm.net, mm.optimizer, mm.config, mesh)
    metrics = step_fn(0, shard_batch(mesh, batch))
    return _step_result(mesh, mm.net, mm.optimizer, metrics)


def footprint_steps_rank(mesh, state_dict_path, batch):
    """The step with global BN, then with per-rank BN."""
    return {"global": footprint_step_rank(mesh, state_dict_path, batch),
            "per_rank": footprint_step_rank(mesh, state_dict_path, batch, global_bn=False)}


def segmentor_step_rank(mesh, batch):
    """One data-parallel f32 train step of the seeded Segmentor-18 (PSP)."""
    net = Segmentor(18, True, generator=torch.Generator().manual_seed(SEG_SEED))
    sync_batch_norm(net, mesh)
    replicate_tree(mesh, net)
    optimizer = tstep.make_optimizer(net, tstep.TrainStepConfig())
    step_fn = seg_trainer.build_train_step(net, optimizer, lambda s: 1e-4, torch.float32,
                                           mesh)
    metrics = step_fn(0, shard_batch(mesh, batch))
    return _step_result(mesh, net, optimizer, metrics)


def parallel_rank(mesh, state_dict_path, fp_batch, seg_batch, bn_args):
    """Everything test_torch_parallel.py reads from one world: the BN, the
    FootprintNetwork steps and, at world 2, the Segmentor step."""
    out = {"bn": bn_rank(mesh, *bn_args),
           "footprint": footprint_steps_rank(mesh, state_dict_path, fp_batch)}
    if mesh.world_size == 2:
        out["segmentor"] = segmentor_step_rank(mesh, seg_batch)
    return out


def failing_rank(mesh):
    """Rank 1 raises; rank 0 waits for it in a collective that never
    completes."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier(group=mesh.group)
