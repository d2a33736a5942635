"""Decoder building blocks (counterpart of footprints_tpu/nn/blocks.py).

  ConvBlock:        [reflect-pad(1) -> 3x3 conv -> ELU] x 2
  ConvUpsampleAndConcatBlock: pre-conv -> nearest x2 -> concat(skip) -> post-conv
  OutConvBlock:     reflect-pad(1) -> 3x3 conv -> (sigmoid) -> bilinear x scale

Module and parameter names follow the reference's state_dict.  Decoder
ConvBlocks keep their BatchNorm modules although the reference never applies
them (use_bn=False), so a reference state_dict loads strictly.  They are
frozen (``requires_grad=False``): the JAX pytree has no such leaves, so the
optimizer never sees them.

Some of the decoder's ConvBlocks run through the hand-written CUDA kernel
(ops/fused_conv.py), every time, at every batch, in training as in serving:
post-concat ConvBlocks (``ConvUpsampleAndConcatBlock(fused=True)``),
pre-concat ConvBlocks (``fused_pre=True``: ``ConvBlock(fused=True)``) and
the tail ConvBlock (``decoder_tail``).  models/footprint.py says which
(``FUSED_BLOCKS``, ``FUSED_PRE_CONCAT``), and its ``kernel_sites`` lists
the calls a forward makes.  Their backward is the op's registered autograd:
the hand-written dgrad and wgrad kernels, one launch of each per forward
call.  The other convs are ``F.pad(reflect)`` + ``F.conv2d``.  Tensors are
NCHW views of channels_last memory; the kernel sites permute them to NHWC
views, and a fused block returns the NCHW view of the kernel's NHWC output.

Inside ``parallel.halo.shard_rows`` each block runs on a row shard: the
reflect convs and the bilinear heads exchange their halo rows
(nn/layers.py), and each kernel site runs the kernel in its own reflect
mode on its input extended by one neighbour row per seam, then drops the
output rows that the seam's reflection made (ops/fused_conv.py: ``halo``).
The nearest x2 upsample and the concat are pixel-local.
"""

import torch
import torch.nn as nn

from ..ops.fused_conv import (conv_reflect_fused, conv_reflect_res_fused,
                              crop_rows, up_conv_fused)
from ..parallel.halo import exchange_rows, row_mesh, seam_rows
from ..telemetry import span
from .layers import (conv2d, elu, reflect_pad, sigmoid, upsample_bilinear,
                     upsample_nearest)


def _nhwc(x):
    """NCHW tensor -> NHWC-contiguous tensor (a view for channels_last)."""
    return x.permute(0, 2, 3, 1).contiguous()


def _nchw(y):
    """NHWC-contiguous tensor -> the NCHW channels_last view of it."""
    return y.permute(0, 3, 1, 2)


def _site_input(x, mesh):
    """A kernel site's NHWC input and its ``halo``: on a row shard, the
    NCHW ``x`` with one neighbour row on each seam side and the rows it
    gained (above, below); otherwise ``x`` and (0, 0)."""
    if mesh is None:
        return _nhwc(x), (0, 0)
    return _nhwc(exchange_rows(x, 1, 1, mesh)), seam_rows(mesh, 1, 1)


def _reflect_site(conv, x, mesh):
    """``conv`` (reflect pad, bias, ELU) at a kernel site: NCHW ``x``, this
    rank's rows, -> NHWC, this rank's rows."""
    x, halo = _site_input(x, mesh)
    return conv_reflect_fused(x, conv.weight, conv.bias, act="elu", halo=halo)


class ConvBlock(nn.Module):
    """[reflect-pad(1) -> 3x3 conv -> ELU] x 2.  fused=True runs both convs
    through the CUDA kernel's 'reflect' route, bias and ELU fused: a launch
    a conv, and no padded tensor exists."""

    def __init__(self, in_ch, out_ch, *, fused=False):
        super().__init__()
        self.fused = fused
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3)
        self.bn1 = nn.BatchNorm2d(out_ch)  # unused, kept for the state_dict
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3)
        self.bn2 = nn.BatchNorm2d(out_ch)  # unused, kept for the state_dict
        self.bn1.requires_grad_(False)
        self.bn2.requires_grad_(False)

    def forward(self, x):
        mesh = row_mesh(self)
        if self.fused:
            y = _reflect_site(self.conv1, x, mesh)
            return _nchw(_reflect_site(self.conv2, _nchw(y), mesh))
        # on a row shard the padded input goes to cuDNN in channels_last:
        # at the decoder's 1/4-scale shard shapes ([4,128|64,26|18,162],
        # 192x640 over 2 and 3 shards) its f32 heuristics pick, for NCHW, an
        # algorithm with a 2-4 GiB workspace and ~50x the time; the heads'
        # convs (2 output channels) keep NCHW, whose workspace is the
        # smaller there (chip_smoke.py:spatial_cudnn_probe, H100)
        fmt = torch.channels_last
        x = elu(conv2d(reflect_pad(x, 1, mesh, fmt), self.conv1.weight, self.conv1.bias))
        return elu(conv2d(reflect_pad(x, 1, mesh, fmt), self.conv2.weight, self.conv2.bias))


class ConvUpsampleAndConcatBlock(nn.Module):
    """pre-conv -> nearest x2 -> concat(skip) -> post-conv.  The post-concat
    conv takes ``out_ch + skip_ch`` channels (skip_ch == out_ch for
    ResNet-18/34; ResNet-50's skips are wider).

    fused=True runs the post-concat ConvBlock through the CUDA kernel with
    the JAX decomposition (footprints_tpu/nn/blocks.py:123-127): conv1 over
    concat(up(x), skip) splits linearly into an up-conv of x with the first
    ``out_ch`` input channels of the weight plus a conv of skip with the
    rest, so neither the upsampled, the concatenated nor the padded tensor
    exists; then conv2.  A launch each: the up-conv, the skip's conv with
    the bias, the up-conv as its residual and ELU, and conv2 with ELU.
    fused_pre=True runs the pre-concat ConvBlock through the kernel
    (``ConvBlock(fused=True)``).

    On either route, the pre-concat ConvBlock is the span
    ``decoder.pre_concat`` and what follows it the span
    ``decoder.post_concat``, both timed on the card while tracing.
    """

    def __init__(self, in_ch, out_ch, skip_ch=None, *, fused=False, fused_pre=False):
        super().__init__()
        self.fused = fused
        self.pre_concat_conv = ConvBlock(in_ch, out_ch, fused=fused_pre)
        self.post_concat_conv = ConvBlock(out_ch + (skip_ch or out_ch), out_ch)

    def forward(self, x, skip):
        with span("decoder.pre_concat", device=x.device):
            x = self.pre_concat_conv(x)
        with span("decoder.post_concat", device=x.device):
            if not self.fused:
                return self.post_concat_conv(torch.cat([upsample_nearest(x, 2), skip], 1))
            return self._fused_post_concat(x, skip)

    def _fused_post_concat(self, x, skip):
        c_up = x.shape[1]
        conv1 = self.post_concat_conv.conv1
        mesh = row_mesh(self)
        # the weight halves are input-channel slice views: no copy
        x, halo = _site_input(x, mesh)
        r = up_conv_fused(x, conv1.weight[:, :c_up], None, act="none")
        if mesh is not None:
            # the residual covers the skip's extended rows: of the 2 output
            # rows per halo row, the outer one read the reflected edge
            r = crop_rows(r, *halo).contiguous()
        skip, halo = _site_input(skip, mesh)
        y = conv_reflect_res_fused(skip, conv1.weight[:, c_up:], conv1.bias, r, act="elu",
                                   halo=halo)
        return _nchw(_reflect_site(self.post_concat_conv.conv2, _nchw(y), mesh))


class OutConvBlock(nn.Module):
    def __init__(self, in_ch, out_ch, scale=1, apply_sigmoid=False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3)
        self.scale = scale
        self.apply_sigmoid = apply_sigmoid

    def forward(self, x):
        mesh = row_mesh(self)
        x = conv2d(reflect_pad(x, 1, mesh), self.conv1.weight, self.conv1.bias)
        if self.apply_sigmoid:
            x = sigmoid(x)
        if self.scale != 1:
            x = upsample_bilinear(x, self.scale, mesh)
        return x


def decoder_tail(conv_block, out_block, x):
    """nearest_up_2x -> ConvBlock -> OutConvBlock, with the ConvBlock's two
    convs in the CUDA kernel (the first one upsamples as it reads)."""
    mesh = row_mesh(conv_block)
    x, halo = _site_input(x, mesh)
    y = up_conv_fused(x, conv_block.conv1.weight, conv_block.conv1.bias, act="elu",
                      halo=halo)
    return out_block(_nchw(_reflect_site(conv_block.conv2, _nchw(y), mesh)))
