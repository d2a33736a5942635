"""The yardstick's arithmetic against hand counts."""

import math

import torch
import torch.nn as nn

import flops
import harness


class Tiny(nn.Module):
    """A stem conv, a decoder-like post-concat conv over [up(x), skip], and
    a tail conv over up(x), to count by hand."""

    def __init__(self):
        super().__init__()
        self.stem = nn.Conv2d(3, 8, 3, stride=2, padding=1, bias=False)
        self.post_concat_conv = nn.Module()
        self.post_concat_conv.conv1 = nn.Conv2d(16, 8, 3, padding=1)
        self.outconv4 = nn.Sequential(nn.Module())
        self.outconv4[0].conv1 = nn.Conv2d(8, 4, 3, padding=1)

    def forward(self, x):
        y = self.stem(x)  # [1,8,H/2,W/2]
        up = nn.functional.interpolate(y, scale_factor=2, mode="nearest")
        z = self.post_concat_conv.conv1(torch.cat([up, up], 1))  # [1,8,H,W]
        small = nn.functional.avg_pool2d(z, 2)
        return self.outconv4[0].conv1(nn.functional.interpolate(small, scale_factor=2))


def test_conv_flops_by_hand():
    with torch.device("meta"):
        model = Tiny()
    counts = flops.conv_flops(model, 8, 12)
    assert counts["stem"] == 2 * 8 * 4 * 6 * 3 * 9
    # half the 16 input channels upsampled: 8 at 4 taps, 8 at 9
    assert counts["post_concat_conv.conv1"] == 2 * 8 * 8 * 12 * (8 * 4 + 8 * 9)
    assert counts["outconv4.0.conv1"] == 2 * 4 * 8 * 12 * 8 * 4
    assert flops.train_flops(model, 8, 12) == 3 * sum(counts.values()) - counts["stem"]


def test_whole_models():
    fp = harness.reference_model({"model": "FootprintNetwork"})
    seg = harness.reference_model({"model": "Segmentor", "use_psp": True})
    # the '1/1' forward leaves the side heads out; every head is small
    fwd, every = (flops.forward_flops(fp, 192, 640, h) for h in (False, True))
    assert 50.9e9 < fwd < every < 51.2e9
    assert 34.6e9 < flops.forward_flops(seg, 192, 640, False) < 34.8e9
    assert flops.train_flops(fp, 192, 640) < 3 * every


def test_site_flops_and_bounds_by_hand():
    up, skip, conv2, tail1, tail2 = flops.sites(4, 192, 640)
    assert flops.site_flops(up) == 2 * 4 * 64 * 64 * 4 * 96 * 320
    assert flops.site_flops(tail2) == 2 * 9 * 32 * 32 * 4 * 192 * 640
    # f32: 3 TF32 products a MAC, under the FMA rate off the tensor cores
    f = flops.site_flops(conv2)
    nbytes = 4 * (4 * 96 * 320 * 64 + 64 * 64 * 9 + 64 + 4 * 96 * 320 * 64)
    assert math.isclose(flops.forward_bound_s(conv2, "float32"),
                        max(3 * f / 495e12, nbytes / 3.35e12))
    # the smoke script's bound of a b4 f32 forward of both decoders (PERF.md: 0.4759 ms)
    assert math.isclose(flops.fused_bound_s(4, 192, 640, 2, "float32", False) * 1e3,
                        0.47586, rel_tol=1e-4)
    bwd = flops.fused_bound_s(12, 192, 640, 2, "float32", True)
    fwd = flops.fused_bound_s(12, 192, 640, 2, "float32", False)
    assert math.isclose(bwd, 3 * fwd, rel_tol=0.05) and bwd > fwd


def test_mfu_reader():
    cell = harness.cell("fp-kitti.dump.b12")
    m = harness.Measure(cell=cell, window_s=2.0, units=330, trace=None, flops_per_unit=1e12)
    assert math.isclose(harness.metric_reader("mfu.dump").read(m), 100.0)
