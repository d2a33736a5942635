"""Segmentor, the binary ground-segmentation network of the preprocessing
pipeline (counterpart of footprints_tpu/models/segmentor.py).

  * the FootprintNetwork's ResNet encoder (5 features, (x - 0.45) / 0.225)
  * an optional PSP bottleneck: adaptive average pools to 1, 2, 4 and 6
    cells (``nn.AdaptiveAvgPool2d``'s cells), a bias-free 1x1 reduce conv to
    a quarter of the width each, a bilinear resize back with
    align_corners=True, and the concat [x, p6, p4, p2, p1] (twice the width)
  * the FootprintNetwork's up-concat decoder with one single-channel head per
    scale; the 4 *logit* maps come back at their native scales (1/8, 1/4,
    1/2 and 1/1 of the input), not upsampled: the training loop resizes them

The decoder's ConvBlocks run through the CUDA kernel where the
FootprintNetwork's do (models/footprint.py: ``FUSED_BLOCKS``,
``FUSED_PRE_CONCAT`` and the tail; ``kernel_sites`` lists the calls).
Parameter names follow the reference's state_dict (``encoder.*``,
``decoder.block{i}.*``, ``decoder.outconv{1..4}.*``,
``decoder.PSP.block{1..4}.reduce`` for pool sizes 1, 2, 4, 6).

NHWC ``[N,H,W,3]`` in, a list of 4 NHWC ``[N,h,w,1]`` maps out, as in the
JAX package; inside, NCHW views of channels_last memory.

On a row shard (``parallel.halo.shard_rows``) the encoder and decoder
exchange halos as the FootprintNetwork's do, and the PSP, whose adaptive
pools span the shards, gathers the whole 1/32 map (``[N,512,H/32,W/32]``:
60 KB an image at 192x640), runs its branches on it and keeps its own rows.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn import resnet
from ..parallel.halo import gather_rows, own_rows, row_mesh
from ..telemetry import span
from .footprint import SCALES, SkipDecoder

PSP_POOL_SIZES = (1, 2, 4, 6)


class PSPBlock(nn.Module):
    def __init__(self, pool_size, feats, reduce_factor=4):
        super().__init__()
        self.pool_size = pool_size
        self.reduce = nn.Conv2d(feats, feats // reduce_factor, 1, bias=False)

    def forward(self, x):
        y = self.reduce(F.adaptive_avg_pool2d(x, self.pool_size))
        return F.interpolate(y, size=x.shape[-2:], mode="bilinear", align_corners=True)


class PSP(nn.Module):
    def __init__(self, feats):
        super().__init__()
        for i, s in enumerate(PSP_POOL_SIZES, 1):
            setattr(self, f"block{i}", PSPBlock(s, feats))

    def forward(self, x):
        mesh, rows = row_mesh(self), x.shape[2]
        if mesh is not None:
            x = gather_rows(x, mesh)
        p1, p2, p4, p6 = (getattr(self, f"block{i}")(x)
                          for i in range(1, len(PSP_POOL_SIZES) + 1))
        y = torch.cat([x, p6, p4, p2, p1], 1)
        return y if mesh is None else own_rows(y, rows, mesh)


class SegSkipDecoder(SkipDecoder):
    """The SkipDecoder with 1-channel logit heads at native scales, behind
    an optional PSP bottleneck.  The PSP is the span ``decoder.psp``, timed
    on the card while tracing (telemetry.py), inside the Segmentor's
    ``decoder``."""

    def __init__(self, enc_channels, use_psp):
        c4 = enc_channels[-1]
        super().__init__(enc_channels, apply_sigmoid=False, out_ch=1,
                         in_ch=2 * c4 if use_psp else c4, out_scales=(1, 1, 1))
        self.use_psp = use_psp
        if use_psp:
            self.PSP = PSP(c4)

    def forward(self, features, scales=SCALES):
        """Returns the NCHW logit maps of ``scales``, in that order."""
        if self.use_psp:
            with span("decoder.psp", device=features[-1].device):
                features = [*features[:-1], self.PSP(features[-1])]
        out = super().forward(features, scales)
        return [out[k] for k in scales]


class Segmentor(nn.Module):
    """ResNet encoder + SegSkipDecoder, built on ``device`` and initialised
    from ``generator`` like the FootprintNetwork (the PSP's reduce convs get
    the decoder convs' Kaiming-uniform init), with its spans: ``model.build``,
    ``encoder`` and ``decoder`` (the PSP's ``decoder.psp`` inside)."""

    def __init__(self, depth: int = 34, use_psp: bool = True, *, device="cpu",
                 generator=None):
        super().__init__()
        self.depth = depth
        self.use_psp = use_psp
        enc_channels = resnet.feature_channels(depth)
        with span("model.build"):
            with torch.device("meta"):
                self.encoder = resnet.ResnetEncoder(depth)
                self.decoder = SegSkipDecoder(enc_channels, use_psp)
            self.to_empty(device=device)
            generator = generator if generator is not None else torch.Generator().manual_seed(0)
            self.encoder.reset_parameters(generator)
            self.decoder.reset_parameters(generator)

    def forward(self, image, scales=SCALES):
        """image: [N,H,W,3] in [0,1].  Returns the [N,h,w,1] logit maps at
        ``scales`` (all four by default: 1/8, 1/4, 1/2 and 1/1 of H,W); the
        dump asks for '1/1' alone and skips the other heads."""
        x = image.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        with span("encoder", device=x.device):
            features = self.encoder(x)
        with span("decoder", device=x.device):
            maps = self.decoder(features, scales)
        return [y.permute(0, 2, 3, 1) for y in maps]
