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


def config_model(name):
    return harness.reference_model(harness.load_json(harness.HERE, "configs", f"{name}.json"))


def test_whole_models():
    fp = config_model("footprints-r34-kitti")
    seg = config_model("segmentor-r34-psp-kitti")
    # the '1/1' forward leaves the side heads out; every head is small.
    # Pinned to the counts from before the upsampled half was taken as the
    # block's out_channels: the same for both configurations, whose skips
    # are as wide as the block's output.
    assert flops.forward_flops(fp, 192, 640, False) == 50_972_590_080
    assert flops.forward_flops(fp, 192, 640, True) == 51_167_232_000
    assert flops.train_flops(fp, 192, 640) == 152_923_668_480
    assert flops.forward_flops(seg, 192, 640, False) == 34_677_325_824
    assert flops.forward_flops(seg, 192, 640, True) == 34_725_986_304
    assert flops.train_flops(seg, 192, 640) == 103_599_931_392


def site_bound_s(n, h, w, ci, co, up, residual, bias):
    """A site's f32 forward bound counted by hand: 3 TF32 products a MAC
    at 4 taps (upsampled input, output 2h x 2w) or 9, or its bytes."""
    ho, wo = (2 * h, 2 * w) if up else (h, w)
    macs = (4 if up else 9) * ci * co * n * ho * wo
    nbytes = 4 * (n * h * w * ci + co * ci * 9 + (co if bias else 0)
                  + n * ho * wo * co * (2 if residual else 1))
    return max(3 * 2 * macs / 495e12, nbytes / 3.35e12)


def test_site_flops_and_bounds_by_hand():
    fp = config_model("footprints-r34-kitti")
    seg = config_model("segmentor-r34-psp-kitti")
    # 8 sites a decoder: block2's and block4's post-concat ConvBlocks (up
    # half, skip half with residual and bias, conv2), then the tail's two
    sites = flops.sites(fp, 12, 192, 640)
    assert [s[0] for s in sites[:8]] == [
        "mask_decoder.block2.post.conv1.up_half", "mask_decoder.block2.post.conv1.skip_half",
        "mask_decoder.block2.post.conv2", "mask_decoder.block4.post.conv1.up_half",
        "mask_decoder.block4.post.conv1.skip_half", "mask_decoder.block4.post.conv2",
        "mask_decoder.tail.conv1", "mask_decoder.tail.conv2"]
    assert [s[0].split(".", 1)[1] for s in sites[8:]] == [
        s[0].split(".", 1)[1] for s in sites[:8]]
    assert len(flops.sites(seg, 12, 192, 640)) == 8
    up2, skip2, conv22, up4, skip4, conv24, tail1, tail2 = sites[:8]
    assert skip2[1:] == ("reflect", (12, 24, 80, 128), 128, True, True)
    assert up2[1:] == ("up2_reflect", (12, 12, 40, 128), 128, False, False)
    assert conv22[1:] == ("reflect", (12, 24, 80, 128), 128, False, True)
    assert up4[1:] == ("up2_reflect", (12, 48, 160, 64), 64, False, False)
    assert skip4[1:] == ("reflect", (12, 96, 320, 64), 64, True, True)
    assert tail1[1:] == ("up2_reflect", (12, 96, 320, 64), 32, False, True)
    assert tail2[1:] == ("reflect", (12, 192, 640, 32), 32, False, True)
    assert flops.site_flops(up4) == 2 * 12 * 64 * 64 * 4 * 96 * 320
    assert flops.site_flops(tail2) == 2 * 9 * 32 * 32 * 12 * 192 * 640
    # a b4 f32 forward of both decoders, site by site
    decoder = (site_bound_s(4, 12, 40, 128, 128, True, False, False)
               + site_bound_s(4, 24, 80, 128, 128, False, True, True)
               + site_bound_s(4, 24, 80, 128, 128, False, False, True)
               + site_bound_s(4, 48, 160, 64, 64, True, False, False)
               + site_bound_s(4, 96, 320, 64, 64, False, True, True)
               + site_bound_s(4, 96, 320, 64, 64, False, False, True)
               + site_bound_s(4, 96, 320, 64, 32, True, False, True)
               + site_bound_s(4, 192, 640, 32, 32, False, False, True))
    assert math.isclose(flops.fused_bound_s(fp, 4, 192, 640, "float32", False), 2 * decoder)
    assert math.isclose(flops.fused_bound_s(seg, 4, 192, 640, "float32", False), decoder)
    # PERF.md's site table: 0.8145 ms a decoder at b12 (0.7138 over the 5
    # sites that the kernel ran before block2's)
    assert math.isclose(flops.fused_bound_s(seg, 12, 192, 640, "float32", False) * 1e3,
                        0.81446, rel_tol=1e-4)
    bwd = flops.fused_bound_s(fp, 12, 192, 640, "float32", True)
    fwd = flops.fused_bound_s(fp, 12, 192, 640, "float32", False)
    assert math.isclose(bwd, 3 * fwd, rel_tol=0.05) and bwd > fwd


def test_mfu_reader():
    cell = harness.cell("fp-kitti.dump.b12")
    m = harness.Measure(cell=cell, window_s=2.0, units=330, trace=None, flops_per_unit=1e12)
    assert math.isclose(harness.metric_reader("mfu.dump").read(m), 100.0)
