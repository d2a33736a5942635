"""FootprintNetwork — shared ResNet encoder + two skip decoders (counterpart
of footprints_tpu/models/footprint.py).

  * encoder: ResNet (depth 18/34/50; the checkpoint contract is 34), 5 features
  * mask decoder:  SkipDecoder with apply_sigmoid=False (logits)
  * depth decoder: SkipDecoder with apply_sigmoid=True (sigmoid disparity)
  * per scale ('1/8','1/4','1/2','1/1'), output = concat(mask 2ch, depth 2ch)
    -> channel contract ch0=visible-ground logit, ch1=hidden-ground logit,
       ch2=visible sigmoid-disp, ch3=hidden-ground sigmoid-disp
  * every scale output is bilinearly upsampled (align_corners=False) to the
    full input resolution.

The public forward keeps the JAX layout: NHWC ``[N,H,W,3]`` in, NHWC
``[N,H,W,4]`` maps out.  Inside, tensors are NCHW views of channels_last
memory, so both permutes are views.

Inside ``parallel.halo.shard_rows`` the network runs on a row shard of the
image (the rows of every activation that the rank owns, with halo
exchanges at the ops that read across rows: nn/), and returns its rows of
each map.  A rank's rows are a multiple of 32, so the packed heads, which
are pixel-local, pack them as the unsharded heads pack the same rows.

The packed training heads (``s2d_head``, ``p4_head``) keep the JAX
package's layouts (footprints_tpu/models/footprint.py), which it computes
in s2d form to spare the TPU lane-narrow relayouts.  The card has no such
constraint, so here each is the standard head, then packed
(core/ops.py): it unpacks to the standard head bit for bit.
"""

import torch
import torch.nn as nn
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.ops import p4_pack, s2d_pack
from ..nn import init as nn_init
from ..nn import resnet
from ..nn.blocks import (ConvBlock, ConvUpsampleAndConcatBlock, OutConvBlock,
                         decoder_tail)
from ..ops.fused_conv import fused_conv3x3_op
from ..telemetry import span

SCALES = ("1/8", "1/4", "1/2", "1/1")

# Output channel contract
VISIBLE_GROUND = 0
HIDDEN_GROUND = 1
DEPTH = 2
HIDDEN_DEPTH = 3

DECODER_CHANNELS = (256, 128, 64, 64)
# the decoder blocks whose post-concat ConvBlock runs through the CUDA kernel
# (nn/blocks.py): block2's 128 channels at 1/8 scale, where cuDNN's f32
# heuristics fall off a cliff at batch 12, and block4's 64 at 1/2 scale
FUSED_BLOCKS = (2, 4)
# the decoder blocks whose pre-concat ConvBlock runs through the kernel:
# block3's 128 -> 64 channels at 1/8 scale, where cuDNN's f32 heuristics
# pick their FFT algorithm at batch 12
FUSED_PRE_CONCAT = (3,)

# a site's name from its weight's parameter name: the block's ConvBlocks as
# "pre" and "post", the decoder's tail ConvBlock as "tail"
_SITE_NAMES = (("_concat_conv.", "."), ("outconv4.0.", "tail."))


class _RecordSites(TorchDispatchMode):
    """Records the arguments of every call of the fused kernel's op."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is fused_conv3x3_op:
            self.calls.append(args)
        return func(*args, **(kwargs or {}))


def kernel_sites(net, batch, height, width):
    """The fused kernel's call sites in one forward of ``net`` (a
    FootprintNetwork or a Segmentor, on any device) at ``batch`` x
    ``height`` x ``width`` with every head, in call order, one launch each:
    [(name, pad_mode, input NHWC shape, Co, residual?, bias?, act)].

    Read from the forward itself, run on the meta device on meta twins of
    the parameters and buffers (nothing is allocated or launched, ``net``
    is left as it was) under a dispatch mode that records each call of the
    op.  A call's weight, a parameter or an input-channel slice view of
    one, names its site: ``mask_decoder.block2.post.conv1.up_half`` (the
    first input channels) and ``.skip_half``, ``decoder.tail.conv1``."""
    twins = {k: torch.empty_like(v, device="meta")
             for k, v in [*net.named_parameters(), *net.named_buffers()]}
    names = {id(v): k.removesuffix(".weight") for k, v in twins.items()}
    with torch.no_grad(), _RecordSites() as record:
        torch.func.functional_call(net, twins, (torch.empty(batch, height, width, 3,
                                                            device="meta"),))
    sites = []
    for x, w, b, residual, pad_mode, act in record.calls:
        name = names[id(w if w._base is None else w._base)]
        for part, short in _SITE_NAMES:
            name = name.replace(part, short)
        if w._base is not None:
            name += ".skip_half" if w.storage_offset() else ".up_half"
        sites.append((name, pad_mode, tuple(x.shape), w.shape[0], residual is not None,
                      b is not None, act))
    return sites


class SkipDecoder(nn.Module):
    """Monodepth2-style U-Net decoder over 5 encoder features.  ``in_ch``
    is the deepest input's width (the last feature's unless a bottleneck
    widens it); ``out_scales`` upsample the '1/8', '1/4' and '1/2' heads
    to full resolution (1, 1, 1 leaves them at their native scales).

    The blocks of ``FUSED_BLOCKS`` run their post-concat ConvBlock through
    the CUDA kernel, those of ``FUSED_PRE_CONCAT`` their pre-concat
    ConvBlock, and so does the tail ConvBlock; the other ConvBlocks stay on
    cuDNN.  ``kernel_sites`` lists the calls a forward makes."""

    def __init__(self, enc_channels, apply_sigmoid, out_ch=2, in_ch=None,
                 out_scales=(8, 4, 2)):
        super().__init__()
        c_in = enc_channels[-1] if in_ch is None else in_ch
        skips = enc_channels[-2::-1]
        for i, (c_out, skip_ch) in enumerate(zip(DECODER_CHANNELS, skips), 1):
            block = ConvUpsampleAndConcatBlock(c_in, c_out, skip_ch, fused=i in FUSED_BLOCKS,
                                               fused_pre=i in FUSED_PRE_CONCAT)
            setattr(self, f"block{i}", block)
            c_in = c_out
        s8, s4, s2 = out_scales
        self.outconv1 = OutConvBlock(128, out_ch, s8, apply_sigmoid)
        self.outconv2 = OutConvBlock(64, out_ch, s4, apply_sigmoid)
        self.outconv3 = OutConvBlock(64, out_ch, s2, apply_sigmoid)
        self.outconv4 = nn.Sequential(ConvBlock(64, 32),
                                      OutConvBlock(32, out_ch, 1, apply_sigmoid))

    def reset_parameters(self, generator):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn_init.conv_kaiming_uniform_(m, generator)
            elif isinstance(m, nn.BatchNorm2d):
                nn_init.batchnorm_(m)

    def forward(self, features, scales=SCALES):
        """Returns {scale: NCHW full-resolution map} for each requested scale."""
        out = {}
        x = self.block1(features[-1], features[-2])
        x = self.block2(x, features[-3])
        if "1/8" in scales:
            out["1/8"] = self.outconv1(x)
        x = self.block3(x, features[-4])
        if "1/4" in scales:
            out["1/4"] = self.outconv2(x)
        x = self.block4(x, features[-5])
        if "1/2" in scales:
            out["1/2"] = self.outconv3(x)
        if "1/1" in scales:
            out["1/1"] = decoder_tail(self.outconv4[0], self.outconv4[1], x)
        return out


class FootprintNetwork(nn.Module):
    """ResNet encoder + mask and depth SkipDecoders.

    Built on ``device`` and initialised from ``generator`` (torch defaults:
    Kaiming-normal-fan-out encoder convs, Kaiming-uniform decoder convs,
    identity BN).  Parameters are created on the meta device first, so
    construction draws nothing from the global RNG.  Construction is the
    span ``model.build``; a forward, the spans ``encoder`` and ``decoder``
    (one a decoder), timed on the card while tracing (telemetry.py).
    """

    def __init__(self, depth: int = 34, *, device="cpu", generator=None):
        super().__init__()
        self.depth = depth
        enc_channels = resnet.feature_channels(depth)
        with span("model.build"):
            with torch.device("meta"):
                self.encoder = resnet.ResnetEncoder(depth)
                self.mask_decoder = SkipDecoder(enc_channels, apply_sigmoid=False)
                self.depth_decoder = SkipDecoder(enc_channels, apply_sigmoid=True)
            self.to_empty(device=device)
            self.reset_parameters(generator if generator is not None
                                  else torch.Generator().manual_seed(0))

    def reset_parameters(self, generator):
        self.encoder.reset_parameters(generator)
        self.mask_decoder.reset_parameters(generator)
        self.depth_decoder.reset_parameters(generator)

    def forward(self, image, scales=SCALES, s2d_head=False, p4_head=False):
        """image: [N,H,W,3] in [0,1].  Returns {scale: [N,H,W,4]} with the
        ch0..ch3 contract above, for each scale in ``scales`` (serving asks
        for '1/1' alone and skips the other heads).

        ``s2d_head`` replaces '1/1' by '1/1_s2d' [N,H/2,W/2,16], channel c's
        4 phases at lanes 4c..4c+3; ``p4_head`` replaces '1/2' by
        '1/2_s2d2' [N,H/4,W/4,64], channel c's 16 period-4 phases at lanes
        16c..16c+15.  The training step scores them against packed targets
        (train/losses.py)."""
        x = image.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        with span("encoder", device=x.device):
            features = self.encoder(x)
        with span("decoder", device=x.device):
            mask = self.mask_decoder(features, scales)
        with span("decoder", device=x.device):
            depth = self.depth_decoder(features, scales)
        packs = {"1/1": ("1/1_s2d", s2d_pack)} if s2d_head else {}
        if p4_head:
            packs["1/2"] = ("1/2_s2d2", p4_pack)
        out = {}
        for k in mask:
            y = torch.cat([mask[k], depth[k]], 1).permute(0, 2, 3, 1)
            if k in packs:
                k, pack = packs[k]
                y = pack(y)
            out[k] = y
        return out
