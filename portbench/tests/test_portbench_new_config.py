"""A configuration the harness has never seen, added as new files alone: a
reference module with an encoder of ResNet-50's feature widths under
``reference/models.py``'s decoders, and a configuration that names it.
The harness builds it, and the FLOPs and the fused kernel's sites follow
its wider skips, with no edit to the harness's code."""

import textwrap

import pytest

import flops
import harness

WIDE = textwrap.dedent('''
    import torch.nn as nn

    from reference import models

    WIDTHS = (64, 256, 512, 1024, 2048)


    class StubEncoder(nn.Module):
        """Five features of ResNet-50's widths at 1/2 ... 1/32 of the input."""

        def __init__(self):
            super().__init__()
            chans = (3,) + WIDTHS
            self.stages = nn.ModuleList(nn.Conv2d(a, b, 1, stride=2)
                                        for a, b in zip(chans, chans[1:]))

        def forward(self, x):
            features = []
            for stage in self.stages:
                x = stage(x)
                features.append(x)
            return features


    def footprint_network(config):
        return models.FootprintNetwork(StubEncoder(), WIDTHS)


    def segmentor(config):
        return models.Segmentor(config["use_psp"], StubEncoder(), WIDTHS)
''')


@pytest.fixture
def reference_dir(tmp_path):
    (tmp_path / "wide.py").write_text(WIDE)
    return str(tmp_path)


def test_wide_footprint_network(reference_dir):
    config = {"name": "footprints-wide", "model": "FootprintNetwork",
              "reference": "wide:footprint_network"}
    model = harness.reference_model(config, reference_dir=reference_dir)
    # block2's post-concat conv1: 128 upsampled channels, then the 512 of
    # the 1/8 feature
    conv1 = model.mask_decoder.block2.post_concat_conv.conv1
    assert tuple(conv1.weight.shape) == (128, 640, 3, 3)
    counts = flops.conv_flops(model, 192, 640)
    assert counts["mask_decoder.block2.post_concat_conv.conv1"] == (
        2 * 128 * 24 * 80 * (128 * 4 + 512 * 9))
    # block1's: 256 upsampled, 1024 of the 1/16 feature
    assert counts["depth_decoder.block1.post_concat_conv.conv1"] == (
        2 * 256 * 12 * 40 * (256 * 4 + 1024 * 9))
    sites = {s[0]: s[1:] for s in flops.sites(model, 12, 192, 640)}
    assert len(sites) == 16
    assert sites["mask_decoder.block2.post.conv1.up_half"] == (
        "up2_reflect", (12, 12, 40, 128), 128, False, False)
    assert sites["mask_decoder.block2.post.conv1.skip_half"] == (
        "reflect", (12, 24, 80, 512), 128, True, True)
    assert sites["depth_decoder.block4.post.conv1.skip_half"] == (
        "reflect", (12, 96, 320, 64), 64, True, True)


def test_wide_segmentor(reference_dir):
    config = {"name": "segmentor-wide", "model": "Segmentor", "use_psp": True,
              "reference": "wide:segmentor"}
    model = harness.reference_model(config, reference_dir=reference_dir)
    # the PSP doubles the deepest feature's 2048 channels
    assert model.decoder.block1.pre_concat_conv.conv1.in_channels == 4096
    sites = {s[0]: s[1:] for s in flops.sites(model, 2, 192, 640)}
    assert len(sites) == 8
    assert sites["decoder.block2.post.conv1.skip_half"][1] == (2, 24, 80, 512)
