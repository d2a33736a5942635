"""The plain reference of FootprintNetwork-50: torchvision's ``resnet50``
encoder (He et al., "Deep Residual Learning for Image Recognition", CVPR
2016; torchvision's v1.5 Bottleneck, the stride on the 3x3 conv) as
Monodepth2's ``ResnetEncoder(num_layers=50)`` uses it
(nianticlabs/monodepth2 ``networks/resnet_encoder.py``), under
nianticlabs/footprints' two SkipDecoders (``footprints/network.py``, in
``reference/models.py``), in plain PyTorch.

The encoder returns five features of widths (64, 256, 512, 1024, 2048) at
1/2 ... 1/32 of the input: the stem's ReLU output, then layer1 (after the
max-pool) to layer4.  Module names follow the port's state dict
(``encoder.layer0.0`` the stem conv, ``encoder.layer1.1.<i>.conv1``,
``encoder.layer2.<i>.downsample.0``, ...), so both sides load one seeded
state dict.  It imports nothing of the port.

Departures from the published description:

- no ImageNet-pretrained weights: the benchmark draws seeded weights
  (``weights.py``);
- torchvision's ``avgpool`` and ``fc`` are not built: Monodepth2's encoder
  returns the five features and never calls them;
- the stem, max-pool and stages are wrapped as ``layer0`` ... ``layer4``,
  as footprints' encoder names them, and the input is normalised as
  ``(x - 0.45) / 0.225`` (Monodepth2), not with ImageNet's per-channel
  mean and std.
"""

import torch.nn as nn

from reference import models

EXPANSION = 4
BLOCKS = (3, 4, 6, 3)  # torchvision resnet50's layers
STAGE_WIDTHS = (64, 128, 256, 512)  # each stage's bottleneck width
CHANNELS = (64,) + tuple(w * EXPANSION for w in STAGE_WIDTHS)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (carrying the stride) -> 1x1, each followed by BN, ReLU
    after the first two and after the residual sum; a 1x1 projection with
    BN on the identity where the stride or the width changes."""

    def __init__(self, c_in, width, stride=1):
        super().__init__()
        c_out = width * EXPANSION
        self.conv1 = nn.Conv2d(c_in, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, c_out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(c_out)
        self.relu = nn.ReLU(inplace=True)
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
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + idt)


def _stage(c_in, width, n_blocks, stride):
    layers = [Bottleneck(c_in, width, stride)]
    layers += [Bottleneck(width * EXPANSION, width) for _ in range(n_blocks - 1)]
    return nn.Sequential(*layers)


class ResnetEncoder(nn.Module):
    """ResNet-50's 5-stage feature extractor with the reference's
    wrapping and naming."""

    def __init__(self):
        super().__init__()
        conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.layer0 = nn.Sequential(conv1, nn.BatchNorm2d(64), nn.ReLU(inplace=True))
        self.layer1 = nn.Sequential(nn.MaxPool2d(3, stride=2, padding=1),
                                    _stage(64, STAGE_WIDTHS[0], BLOCKS[0], 1))
        c_in = CHANNELS[1]
        for i in range(1, 4):
            setattr(self, f"layer{i + 1}", _stage(c_in, STAGE_WIDTHS[i], BLOCKS[i], 2))
            c_in = CHANNELS[i + 1]

    def forward(self, x):
        x = (x - 0.45) / 0.225
        features = [self.layer0(x)]
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            features.append(layer(features[-1]))
        return features


def footprint_network(config):
    """The FootprintNetwork of ``config``: ResNet-50, two SkipDecoders over
    its five widths."""
    if config["encoder_depth"] != 50:
        raise ValueError(f"{config['name']}: this reference's encoder is ResNet-50, "
                         f"not ResNet-{config['encoder_depth']}")
    return models.FootprintNetwork(ResnetEncoder(), CHANNELS)
