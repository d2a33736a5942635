"""The plain reference of both configurations: FootprintNetwork-34 and
Segmentor-34 (PSP) written out in plain PyTorch, frozen from the repo's
test oracle (nianticlabs/footprints ``network.py`` and
``preprocessing/segmentation/network.py``).

Module names give ``state_dict()`` keys equal to the reference's, and so to
the port's, so both sides load one seeded state dict.  Inputs are NCHW in
[0, 1]; every conv is ``nn.Conv2d`` (cuDNN on the card, with TF32 as the
caller sets it), the decoders' nearest x2 upsample is materialised, and
every head at every scale is computed.  It imports nothing of the port.

A configuration names its builder as ``"reference": "models:<function>"``
(``footprint_network``, ``segmentor``).  The decoders and both networks take
the encoder's five feature widths, ResNet-34's by default, so a reference
for another encoder defines the encoder alone and builds on these.
"""


import torch
import torch.nn as nn
import torch.nn.functional as F


class BasicBlock(nn.Module):
    def __init__(self, c_in, c_out, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c_out, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(c_out)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(c_out)
        if stride != 1 or c_in != c_out:
            self.downsample = nn.Sequential(
                nn.Conv2d(c_in, c_out, 1, stride=stride, bias=False),
                nn.BatchNorm2d(c_out),
            )
        else:
            self.downsample = None

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + idt)


def _stage(c_in, c_out, n_blocks, stride):
    layers = [BasicBlock(c_in, c_out, stride)]
    layers += [BasicBlock(c_out, c_out) for _ in range(n_blocks - 1)]
    return nn.Sequential(*layers)


# widths of ResNet-18/34's five features, at 1/2 ... 1/32 of the input
RESNET34_CHANNELS = (64, 64, 128, 256, 512)


class ResnetEncoder(nn.Module):
    """ResNet-34's 5-stage feature extractor with the reference's
    wrapping/naming."""

    def __init__(self):
        super().__init__()
        conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        bn1 = nn.BatchNorm2d(64)
        self.layer0 = nn.Sequential(conv1, bn1, nn.ReLU(inplace=True))
        self.layer1 = nn.Sequential(
            nn.MaxPool2d(3, stride=2, padding=1), _stage(64, 64, 3, 1)
        )
        self.layer2 = _stage(64, 128, 4, 2)
        self.layer3 = _stage(128, 256, 6, 2)
        self.layer4 = _stage(256, 512, 3, 2)

    def forward(self, x):
        x = (x - 0.45) / 0.225
        f0 = self.layer0(x)
        f1 = self.layer1(f0)
        f2 = self.layer2(f1)
        f3 = self.layer3(f2)
        f4 = self.layer4(f3)
        return [f0, f1, f2, f3, f4]


class ConvBlock(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3)
        self.bn1 = nn.BatchNorm2d(out_ch)  # allocated but unused (use_bn=False)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3)
        self.bn2 = nn.BatchNorm2d(out_ch)
        self.pad = nn.ReflectionPad2d(1)
        self.non_lin = nn.ELU(inplace=True)

    def forward(self, x):
        x = self.non_lin(self.conv1(self.pad(x)))
        x = self.non_lin(self.conv2(self.pad(x)))
        return x


class ConvUpsampleAndConcatBlock(nn.Module):
    """The post-concat conv takes ``out_ch`` upsampled channels, then
    ``skip_ch`` of the skip (``out_ch`` unless given)."""

    def __init__(self, in_ch, out_ch, skip_ch=None):
        super().__init__()
        self.pre_concat_conv = ConvBlock(in_ch, out_ch)
        self.post_concat_conv = ConvBlock(out_ch + (skip_ch or out_ch), out_ch)

    def forward(self, x, skip):
        x = self.pre_concat_conv(x)
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = torch.cat([x, skip], 1)
        return self.post_concat_conv(x)


class OutConvBlock(nn.Module):
    def __init__(self, in_ch, out_ch, scale=1, apply_sigmoid=False):
        super().__init__()
        self.pad = nn.ReflectionPad2d(1)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3)
        self.scale = scale
        self.apply_sigmoid = apply_sigmoid

    def forward(self, x):
        x = self.conv1(self.pad(x))
        if self.apply_sigmoid:
            x = torch.sigmoid(x)
        if self.scale != 1:
            x = F.interpolate(x, scale_factor=self.scale, mode="bilinear",
                              align_corners=False)
        return x


def _decoder_blocks(decoder, in_ch, enc_channels):
    """block1..block4: 256, 128, 64, 64 channels, each over the next
    shallower feature as its skip."""
    skips = enc_channels[-2::-1]
    for i, (out_ch, skip_ch) in enumerate(zip((256, 128, 64, 64), skips), 1):
        setattr(decoder, f"block{i}", ConvUpsampleAndConcatBlock(in_ch, out_ch, skip_ch))
        in_ch = out_ch


class SkipDecoder(nn.Module):
    def __init__(self, apply_sigmoid, enc_channels=RESNET34_CHANNELS):
        super().__init__()
        _decoder_blocks(self, enc_channels[-1], enc_channels)
        self.outconv1 = OutConvBlock(128, 2, 8, apply_sigmoid)
        self.outconv2 = OutConvBlock(64, 2, 4, apply_sigmoid)
        self.outconv3 = OutConvBlock(64, 2, 2, apply_sigmoid)
        self.outconv4 = nn.Sequential(
            ConvBlock(64, 32), OutConvBlock(32, 2, 1, apply_sigmoid)
        )

    def forward(self, features):
        out = {}
        x = self.block1(features[-1], features[-2])
        x = self.block2(x, features[-3])
        out["1/8"] = self.outconv1(x)
        x = self.block3(x, features[-4])
        out["1/4"] = self.outconv2(x)
        x = self.block4(x, features[-5])
        out["1/2"] = self.outconv3(x)
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        out["1/1"] = self.outconv4(x)
        return out


class FootprintNetwork(nn.Module):
    def __init__(self, encoder=None, enc_channels=RESNET34_CHANNELS):
        super().__init__()
        self.encoder = ResnetEncoder() if encoder is None else encoder
        self.mask_decoder = SkipDecoder(False, enc_channels)
        self.depth_decoder = SkipDecoder(True, enc_channels)

    def forward(self, x):
        feats = self.encoder(x)
        m = self.mask_decoder(feats)
        d = self.depth_decoder(feats)
        return {k: torch.cat([m[k], d[k]], 1) for k in m}


# ------------------------- segmentation network ----------------------------

class PSPBlock(nn.Module):
    def __init__(self, pool_size, feats, reduce_factor=4):
        super().__init__()
        self.pooling = nn.AdaptiveAvgPool2d((pool_size, pool_size))
        self.reduce = nn.Conv2d(feats, feats // reduce_factor, 1, bias=False)

    def forward(self, x):
        h, w = x.shape[-2:]
        y = self.reduce(self.pooling(x))
        return F.interpolate(y, size=(h, w), mode="bilinear", align_corners=True)


class PSP(nn.Module):
    def __init__(self, feats):
        super().__init__()
        self.block1 = PSPBlock(1, feats)
        self.block2 = PSPBlock(2, feats)
        self.block3 = PSPBlock(4, feats)
        self.block4 = PSPBlock(6, feats)

    def forward(self, x):
        p1, p2, p4, p6 = self.block1(x), self.block2(x), self.block3(x), self.block4(x)
        return torch.cat([x, p6, p4, p2, p1], 1)


class SegSkipDecoder(nn.Module):
    def __init__(self, use_psp, enc_channels=RESNET34_CHANNELS):
        super().__init__()
        self.use_PSP = use_psp
        c4 = enc_channels[-1]
        if use_psp:
            self.PSP = PSP(c4)
        _decoder_blocks(self, 2 * c4 if use_psp else c4, enc_channels)
        self.outconv1 = OutConvBlock(128, 1)
        self.outconv2 = OutConvBlock(64, 1)
        self.outconv3 = OutConvBlock(64, 1)
        self.outconv4 = nn.Sequential(ConvBlock(64, 32), OutConvBlock(32, 1))

    def forward(self, features):
        outs = []
        x = features[-1]
        if self.use_PSP:
            x = self.PSP(x)
        x = self.block1(x, features[-2])
        x = self.block2(x, features[-3])
        outs.append(self.outconv1(x))
        x = self.block3(x, features[-4])
        outs.append(self.outconv2(x))
        x = self.block4(x, features[-5])
        outs.append(self.outconv3(x))
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        outs.append(self.outconv4(x))
        return outs


class Segmentor(nn.Module):
    def __init__(self, use_psp=True, encoder=None, enc_channels=RESNET34_CHANNELS):
        super().__init__()
        self.encoder = ResnetEncoder() if encoder is None else encoder
        self.decoder = SegSkipDecoder(use_psp, enc_channels)

    def forward(self, x):
        return self.decoder(self.encoder(x))


def _resnet34(config):
    if config["encoder_depth"] != 34:
        raise ValueError(f"{config['name']}: this reference's encoder is ResNet-34, "
                         f"not ResNet-{config['encoder_depth']}")


def footprint_network(config):
    """The FootprintNetwork of ``config``: ResNet-34, two SkipDecoders."""
    _resnet34(config)
    return FootprintNetwork()


def segmentor(config):
    """The Segmentor of ``config``: ResNet-34, PSP as ``use_psp`` says."""
    _resnet34(config)
    return Segmentor(use_psp=config["use_psp"])
