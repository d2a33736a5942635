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
"""

import torch
import torch.nn.functional as F

conv2d = F.conv2d


def batch_norm(x, weight, bias, running_mean, running_var, eps=1e-5, *,
               training=False, momentum=0.1):
    """BatchNorm over N,H,W.  Eval mode normalises with the running
    statistics.  Training mode normalises with the batch mean and biased
    variance and updates the running statistics in place:
    ``r = (1 - momentum) r + momentum s``, with the *unbiased* batch variance
    for ``running_var`` (footprints_tpu/nn/layers.py:batch_norm).

    A bf16 ``x`` (mixed precision: bf16 weight and bias, f32 running
    statistics) is normalised in f32, with the statistics computed and
    updated in f32, and returned in bf16, as the JAX function does."""
    if x.dtype == torch.bfloat16:
        return F.batch_norm(x.float(), running_mean, running_var, weight.float(),
                            bias.float(), training=training, momentum=momentum,
                            eps=eps).to(x.dtype)
    return F.batch_norm(x, running_mean, running_var, weight, bias,
                        training=training, momentum=momentum, eps=eps)


def reflect_pad(x, pad=1):
    """Reflection padding of the two spatial dims."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def max_pool_3x3_s2(x):
    """3x3/stride-2/pad-1 max pool (the ResNet stem pool)."""
    return F.max_pool2d(x, 3, stride=2, padding=1)


def upsample_nearest(x, scale=2):
    """Integer-factor nearest-neighbour upsample (pixel replication)."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def upsample_bilinear(x, scale):
    """Bilinear upsample with half-pixel centres (align_corners=False).

    A bf16 ``x`` is upsampled in f32 and rounded back to bf16: the same
    values, but the backward then sums the up to (2 scale)^2 contributions
    to each input pixel in f32.  CUDA's bf16 backward adds them with bf16
    atomics, which put the gradient of the x8 head about 2% off."""
    if x.dtype == torch.bfloat16:
        return F.interpolate(x.float(), scale_factor=scale, mode="bilinear",
                             align_corners=False).to(x.dtype)
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=False)


elu = F.elu
relu = F.relu
sigmoid = F.sigmoid
