"""Functional layers, NCHW logical tensors (counterpart of
footprints_tpu/nn/layers.py).

Contracts, each tested against the JAX package in tests/test_torch_layers.py:
  * conv2d           == torch.nn.Conv2d (same stride/padding)
  * batch_norm       == torch.nn.BatchNorm2d (train and eval modes)
  * reflect_pad      == torch.nn.ReflectionPad2d
  * max_pool_3x3_s2  == torch.nn.MaxPool2d(3, 2, padding=1)
  * upsample_nearest == F.interpolate(mode='nearest', scale_factor=k)
  * upsample_bilinear== F.interpolate(mode='bilinear', align_corners=False)
  * elu              == torch.nn.ELU (alpha=1)

The model keeps activations in ``torch.channels_last`` memory, so these
NCHW views hold NHWC bytes; every function here accepts either format.

Row sharding: ``conv2d``, ``reflect_pad``, ``max_pool_3x3_s2`` and
``upsample_bilinear`` take a spatial ``mesh`` (parallel/halo.py); ``x`` is
then this rank's row shard, extended by the rows the op's window reads
across each seam (a k x k conv of stride s and padding p: p above, k - s - p
below; the pool 1 / 0; reflect 1 / 1; bilinear 1 / 1 of its input), with
the op's own padding only at the image's true top and bottom, and the
result is this rank's rows of the unsharded result.  With ``mesh=None``
each runs its unsharded code.
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..parallel.halo import edge_rows, exchange_rows, halo_rows, seam_rows


def _halo(x, above, below, mesh, value=0.0):
    """The row shard ``x`` with ``above``/``below`` more rows: a
    neighbour's at a seam, ``value`` beyond the image's edge."""
    top, bottom = edge_rows(mesh, above, below)
    x = exchange_rows(x, above, below, mesh)
    if top or bottom:
        x = F.pad(x, (0, 0, top, bottom), value=value)
    return x


def conv2d(x, weight, bias=None, stride=1, padding=0, mesh=None):
    """``F.conv2d`` (square stride and padding, zero-padded); on a row
    shard with a spatial ``mesh``."""
    if mesh is None:
        return F.conv2d(x, weight, bias, stride, padding)
    below = max(weight.shape[2] - stride - padding, 0)
    return F.conv2d(_halo(x, padding, below, mesh), weight, bias, stride, (0, padding))


def batch_norm(x, weight, bias, running_mean, running_var, eps=1e-5, *,
               training=False, momentum=0.1, group=None):
    """BatchNorm over N,H,W.  Eval mode normalises with the running
    statistics.  Training mode normalises with the batch mean and biased
    variance and updates the running statistics in place:
    ``r = (1 - momentum) r + momentum s``, with the *unbiased* batch variance
    for ``running_var`` (footprints_tpu/nn/layers.py:batch_norm).

    A bf16 ``x`` (mixed precision: bf16 weight and bias, f32 running
    statistics) is normalised in f32, with the statistics computed and
    updated in f32, and returned in bf16, as the JAX function does.  In eval
    mode the running statistics may be bf16 too (the bf16 serving forward
    casts them, as footprints_tpu/export.py does): x is normalised in f32
    from those bf16-rounded values.

    With a process ``group`` (data parallelism, parallel/mesh.py:
    sync_batch_norm) training mode takes the statistics over the global
    batch instead (``_global_batch_norm``); without one, or in eval mode,
    this is ``F.batch_norm`` as it always was."""
    if training and group is not None:
        return _global_batch_norm(x, weight, bias, running_mean, running_var, eps,
                                  momentum, group)
    if x.dtype == torch.bfloat16:
        if not training:
            running_mean, running_var = running_mean.float(), running_var.float()
        return F.batch_norm(x.float(), running_mean, running_var, weight.float(),
                            bias.float(), training=training, momentum=momentum,
                            eps=eps).to(x.dtype)
    return F.batch_norm(x, running_mean, running_var, weight, bias,
                        training=training, momentum=momentum, eps=eps)


class _AllReduceSum(torch.autograd.Function):
    """A differentiable all-reduce: SUM forward, SUM of the cotangent
    backward (each rank's loss depends on every rank's statistics)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t, group):
    """The sum of ``t`` over the ranks of ``group``, on every rank; its
    adjoint sums the ranks' cotangents (each rank's result feeds its own
    loss, and every rank's input feeds every result)."""
    return _AllReduceSum.apply(t, group)


def _global_batch_norm(x, weight, bias, running_mean, running_var, eps, momentum,
                       group):
    """Train-mode BN over the batch of every rank of ``group`` (equal
    shards), as the JAX step computes it on the sharded global batch
    (footprints_tpu/nn/layers.py:batch_norm): the mean from the all-reduced
    sum, then the biased variance from the all-reduced sum of squared
    deviations from that mean (two passes, as ``jnp.var``; never E[x^2] -
    E[x]^2), in f32 for a bf16 ``x``; the running variance takes the
    unbiased factor over the global count."""
    xf = x.float() if x.dtype == torch.bfloat16 else x
    dims = (0, 2, 3)
    n = x.numel() // x.shape[1] * dist.get_world_size(group)
    mean = all_reduce_sum(xf.sum(dims), group) / n
    centred = xf - mean.view(1, -1, 1, 1)
    var = all_reduce_sum(centred.square().sum(dims), group) / n
    inv = torch.rsqrt(var + eps) * weight.to(xf.dtype)
    y = centred * inv.view(1, -1, 1, 1) + bias.to(xf.dtype).view(1, -1, 1, 1)
    with torch.no_grad():
        running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
        running_var.mul_(1 - momentum).add_(var * (n / max(n - 1, 1)), alpha=momentum)
    return y.to(x.dtype)


def reflect_pad(x, pad=1, mesh=None, memory_format=torch.contiguous_format):
    """Reflection padding of the two spatial dims.  On a row shard with a
    spatial ``mesh``: the neighbours' rows at a seam, the reflection at the
    image's edge, written into one new tensor in ``memory_format`` (the
    same values as ``F.pad`` of the exchanged rows, without the joined
    copy between them)."""
    if mesh is None:
        return F.pad(x, (pad, pad, pad, pad), mode="reflect")
    top, bottom, x = halo_rows(x, pad, pad, mesh)
    n, c, h, w = x.shape
    out = torch.empty((n, c, h + 2 * pad, w + 2 * pad), dtype=x.dtype, device=x.device,
                      memory_format=memory_format)
    rows = out[:, :, :, pad:pad + w]
    rows[:, :, pad:pad + h] = x
    if top is not None:
        rows[:, :, :pad] = top
    if bottom is not None:
        rows[:, :, pad + h:] = bottom
    # the image's edge reflects the rows written above, the neighbour's
    # among them where this rank holds fewer rows than the pad reaches
    if top is None:
        rows[:, :, :pad] = rows[:, :, pad + 1:2 * pad + 1].flip(2)
    if bottom is None:
        rows[:, :, pad + h:] = rows[:, :, h - 1:h + pad - 1].flip(2)
    out[..., :pad] = out[..., pad + 1:2 * pad + 1].flip(3)
    out[..., pad + w:] = out[..., w - 1:w + pad - 1].flip(3)
    return out


def max_pool_3x3_s2(x, mesh=None):
    """3x3/stride-2/pad-1 max pool (the ResNet stem pool); on a row shard
    with a spatial ``mesh``."""
    if mesh is None:
        return F.max_pool2d(x, 3, stride=2, padding=1)
    return F.max_pool2d(_halo(x, 1, 0, mesh, -float("inf")), 3, stride=2, padding=(0, 1))


def upsample_nearest(x, scale=2):
    """Integer-factor nearest-neighbour upsample (pixel replication)."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def upsample_bilinear(x, scale, mesh=None):
    """Bilinear upsample with half-pixel centres (align_corners=False).

    A bf16 ``x`` is upsampled in f32 and rounded back to bf16: the same
    values, but the backward then sums the up to (2 scale)^2 contributions
    to each input pixel in f32.  CUDA's bf16 backward adds them with bf16
    atomics, which put the gradient of the x8 head about 2% off.

    On a row shard with a spatial ``mesh``: upsampled with one neighbour
    row at each seam, whose ``scale`` output rows are dropped; at the
    image's edge the interpolation clamps as it does unsharded.  An integer
    shift of the source grid, so the kept rows are the unsharded ones bit
    for bit (a power-of-2 ``scale``)."""
    if mesh is not None:
        above, below = seam_rows(mesh, 1, 1)
        y = upsample_bilinear(exchange_rows(x, 1, 1, mesh), scale)
        return y[:, :, scale * above:y.shape[2] - scale * below]
    if x.dtype == torch.bfloat16:
        return F.interpolate(x.float(), scale_factor=scale, mode="bilinear",
                             align_corners=False).to(x.dtype)
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=False)


elu = F.elu
relu = F.relu
sigmoid = F.sigmoid
