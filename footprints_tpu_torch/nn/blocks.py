"""Decoder building blocks (counterpart of footprints_tpu/nn/blocks.py).

  ConvBlock:        [reflect-pad(1) -> 3x3 conv -> ELU] x 2
  ConvUpsampleAndConcatBlock: pre-conv -> nearest x2 -> concat(skip) -> post-conv
  OutConvBlock:     reflect-pad(1) -> 3x3 conv -> (sigmoid) -> bilinear x scale

Module and parameter names follow the reference's state_dict.  Decoder
ConvBlocks keep their BatchNorm modules although the reference never applies
them (use_bn=False), so a reference state_dict loads strictly.  They are
frozen (``requires_grad=False``): the JAX pytree has no such leaves, so the
optimizer never sees them.

The decoder's full-resolution convs run through the hand-written CUDA kernel
(ops/fused_conv.py), every time, in training as in serving: block4's
post-concat ConvBlock (``ConvUpsampleAndConcatBlock(fused=True)``) and the
tail ConvBlock (``decoder_tail``), 5 launches per decoder per forward.  Their
backward is cuDNN's (the op's registered autograd).  The other convs are
``F.pad(reflect)`` + ``F.conv2d``.  Tensors are NCHW views of channels_last
memory; the kernel sites permute them to NHWC views.
"""

import torch
import torch.nn as nn

from ..ops.fused_conv import (conv_reflect_fused, conv_reflect_res_fused,
                              up_conv_fused)
from .layers import (conv2d, elu, reflect_pad, sigmoid, upsample_bilinear,
                     upsample_nearest)


def _nhwc(x):
    """NCHW tensor -> NHWC-contiguous tensor (a view for channels_last)."""
    return x.permute(0, 2, 3, 1).contiguous()


def _nchw(y):
    """NHWC-contiguous tensor -> the NCHW channels_last view of it."""
    return y.permute(0, 3, 1, 2)


class ConvBlock(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3)
        self.bn1 = nn.BatchNorm2d(out_ch)  # unused, kept for the state_dict
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3)
        self.bn2 = nn.BatchNorm2d(out_ch)  # unused, kept for the state_dict
        self.bn1.requires_grad_(False)
        self.bn2.requires_grad_(False)

    def forward(self, x):
        x = elu(conv2d(reflect_pad(x, 1), self.conv1.weight, self.conv1.bias))
        return elu(conv2d(reflect_pad(x, 1), self.conv2.weight, self.conv2.bias))


class ConvUpsampleAndConcatBlock(nn.Module):
    """pre-conv -> nearest x2 -> concat(skip) -> post-conv.  The post-concat
    conv takes ``out_ch + skip_ch`` channels (skip_ch == out_ch for
    ResNet-18/34; ResNet-50's skips are wider).

    fused=True runs the post-concat ConvBlock through the CUDA kernel with
    the JAX decomposition (footprints_tpu/nn/blocks.py:123-127): conv1 over
    concat(up(x), skip) splits linearly into an up-conv of x with the first
    ``out_ch`` input channels of the weight plus a conv of skip with the
    rest, so neither the upsampled nor the concatenated tensor exists.
    """

    def __init__(self, in_ch, out_ch, skip_ch=None, *, fused=False):
        super().__init__()
        self.fused = fused
        self.pre_concat_conv = ConvBlock(in_ch, out_ch)
        self.post_concat_conv = ConvBlock(out_ch + (skip_ch or out_ch), out_ch)

    def forward(self, x, skip):
        x = self.pre_concat_conv(x)
        if not self.fused:
            x = torch.cat([upsample_nearest(x, 2), skip], 1)
            return self.post_concat_conv(x)
        c_up = x.shape[1]
        conv1 = self.post_concat_conv.conv1
        conv2 = self.post_concat_conv.conv2
        # the weight halves are input-channel slice views: no copy
        r = up_conv_fused(_nhwc(x), conv1.weight[:, :c_up], None, act="none")
        y = conv_reflect_res_fused(_nhwc(skip), conv1.weight[:, c_up:],
                                   conv1.bias, r, act="elu")
        return _nchw(conv_reflect_fused(y, conv2.weight, conv2.bias, act="elu"))


class OutConvBlock(nn.Module):
    def __init__(self, in_ch, out_ch, scale=1, apply_sigmoid=False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3)
        self.scale = scale
        self.apply_sigmoid = apply_sigmoid

    def forward(self, x):
        x = conv2d(reflect_pad(x, 1), self.conv1.weight, self.conv1.bias)
        if self.apply_sigmoid:
            x = sigmoid(x)
        if self.scale != 1:
            x = upsample_bilinear(x, self.scale)
        return x


def decoder_tail(conv_block, out_block, x):
    """nearest_up_2x -> ConvBlock -> OutConvBlock, with the ConvBlock's two
    convs in the CUDA kernel (the first one upsamples as it reads)."""
    y = up_conv_fused(_nhwc(x), conv_block.conv1.weight, conv_block.conv1.bias,
                      act="elu")
    y = conv_reflect_fused(y, conv_block.conv2.weight, conv_block.conv2.bias,
                           act="elu")
    return out_block(_nchw(y))
