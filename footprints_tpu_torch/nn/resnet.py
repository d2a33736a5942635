"""ResNet encoder family (18/34/50), counterpart of footprints_tpu/nn/resnet.py.

Five feature stages as in the reference: stem conv+BN+ReLU (stride 2), then
maxpool+layer1, layer2..layer4.  Features have strides (2, 4, 8, 16, 32).
Input normalisation ``(x - 0.45) / 0.225`` is part of the encoder.

Module names follow the reference's state_dict (``layer0`` = Sequential(conv,
bn, relu); ``layer1`` = Sequential(maxpool, stage); ``layer2..4`` = stages),
so a reference ``model.pth`` loads with ``load_state_dict(strict=True)``.

The encoder runs on cuDNN / torch.nn.functional: the JAX package has no
Pallas kernel here either.  BN follows ``module.training``: batch statistics
and running-stat updates after ``.train()``, running statistics after
``.eval()``.  ``num_batches_tracked`` is not advanced (momentum is fixed).
Under data parallelism train-mode BN takes its statistics over the global
batch (parallel/mesh.py:sync_batch_norm).  Inside ``parallel.halo.
shard_rows`` the encoder runs on a row shard: the 3x3 and 7x7 convs and the
pool exchange their halo rows (nn/layers.py); BN (eval), ReLU and the 1x1
convs are pixel-local.
"""

import torch.nn as nn

from ..parallel.halo import row_mesh
from ..telemetry import span
from . import init as nn_init
from .layers import batch_norm, conv2d, max_pool_3x3_s2, relu

# depth -> (block kind, blocks per stage)
ARCHS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
}
STAGE_WIDTHS = (64, 128, 256, 512)
EXPANSION = {"basic": 1, "bottleneck": 4}


def feature_channels(depth: int):
    """Channels of the 5 returned feature maps."""
    kind, _ = ARCHS[depth]
    e = EXPANSION[kind]
    return (64,) + tuple(w * e for w in STAGE_WIDTHS)


def _bn(x, bn):
    # dp_group: set by parallel/mesh.py:sync_batch_norm for global-batch BN
    return batch_norm(x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                      bn.eps, training=bn.training, momentum=bn.momentum,
                      group=getattr(bn, "dp_group", None))


def _conv(conv, x):
    """``conv(x)``; on a row shard, with the halo rows its window reads."""
    mesh = row_mesh(conv)
    if mesh is None:
        return conv(x)
    return conv2d(x, conv.weight, conv.bias, conv.stride[0], conv.padding[0], mesh)


def _downsample(c_in, c_out, stride):
    if stride == 1 and c_in == c_out:
        return None
    return nn.Sequential(nn.Conv2d(c_in, c_out, 1, stride=stride, bias=False),
                         nn.BatchNorm2d(c_out))


class BasicBlock(nn.Module):
    def __init__(self, c_in, width, stride):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, width, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.downsample = _downsample(c_in, width, stride)

    def forward(self, x):
        y = relu(_bn(_conv(self.conv1, x), self.bn1))
        y = _bn(_conv(self.conv2, y), self.bn2)
        if self.downsample is not None:
            x = _bn(self.downsample[0](x), self.downsample[1])
        return relu(y + x)


class Bottleneck(nn.Module):
    def __init__(self, c_in, width, stride):
        super().__init__()
        c_out = width * EXPANSION["bottleneck"]
        self.conv1 = nn.Conv2d(c_in, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, c_out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(c_out)
        self.downsample = _downsample(c_in, c_out, stride)

    def forward(self, x):
        y = relu(_bn(self.conv1(x), self.bn1))
        y = relu(_bn(_conv(self.conv2, y), self.bn2))
        y = _bn(self.conv3(y), self.bn3)
        if self.downsample is not None:
            x = _bn(self.downsample[0](x), self.downsample[1])
        return relu(y + x)


class ResnetEncoder(nn.Module):
    def __init__(self, depth: int = 34):
        super().__init__()
        kind, stage_blocks = ARCHS[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        e = EXPANSION[kind]
        self.depth = depth
        self.layer0 = nn.Sequential(
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False),
            nn.BatchNorm2d(64), nn.ReLU())
        c_in = 64
        for si, (n_blocks, width) in enumerate(zip(stage_blocks, STAGE_WIDTHS)):
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append(block(c_in, width, stride))
                c_in = width * e
            stage = nn.Sequential(*blocks)
            if si == 0:
                stage = nn.Sequential(nn.MaxPool2d(3, stride=2, padding=1), stage)
            setattr(self, f"layer{si + 1}", stage)

    def reset_parameters(self, generator):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn_init.conv_kaiming_normal_fanout_(m, generator)
            elif isinstance(m, nn.BatchNorm2d):
                nn_init.batchnorm_(m)

    def forward(self, x):
        """x: NCHW in [0,1].  Returns the 5 feature maps (NCHW).  Each
        residual stage is the span ``encoder.layer<i>`` (the first after
        the max-pool), timed on the card while tracing."""
        x = (x - 0.45) / 0.225
        x = relu(_bn(_conv(self.layer0[0], x), self.layer0[1]))
        features = [x]
        x = max_pool_3x3_s2(x, row_mesh(self))
        stages = (self.layer1[1], self.layer2, self.layer3, self.layer4)
        for i, stage in enumerate(stages, 1):
            with span(f"encoder.layer{i}", device=x.device):
                for blk in stage:
                    x = blk(x)
            features.append(x)
        return features
