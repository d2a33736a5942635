"""The port's primitives, initialisers and ResNet encoders
(footprints_tpu_torch/{core,nn}) held against the JAX package on the same
numpy inputs.  JAX is NHWC/HWIO, the port NCHW/OIHW: inputs cross as numpy
arrays and are transposed on the way."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from footprints_tpu.core import ops as jops
from footprints_tpu.nn import layers as jl
from footprints_tpu.nn import resnet as jresnet
from footprints_tpu_torch.core import ops as tops
from footprints_tpu_torch.models import FootprintNetwork
from footprints_tpu_torch.nn import init as tinit
from footprints_tpu_torch.nn import layers as tl
from footprints_tpu_torch.nn import resnet as tresnet

from ._torch_port import jax_model, nchw, nhwc

ATOL = 1e-5


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# --- layers: the contract table of nn/layers.py ---------------------------

@pytest.mark.parametrize("stride,padding,k", [(1, 0, 3), (1, 1, 3), (2, 1, 3),
                                              (2, 3, 7), (2, 0, 1)])
def test_conv2d(stride, padding, k):
    x, w, b = _rand(0, 2, 11, 13, 5), _rand(1, k, k, 5, 4), _rand(2, 4)
    ref = jl.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                    stride=stride, padding=padding)
    got = tl.conv2d(nchw(x), torch.from_numpy(np.ascontiguousarray(
        np.transpose(w, (3, 2, 0, 1)))), torch.from_numpy(b),
        stride=stride, padding=padding)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=ATOL)


def test_batch_norm_eval():
    x = _rand(3, 2, 5, 6, 8)
    rng = np.random.RandomState(4)
    params = {"scale": rng.rand(8).astype(np.float32) + 0.5,
              "bias": rng.randn(8).astype(np.float32)}
    state = {"mean": rng.randn(8).astype(np.float32),
             "var": rng.rand(8).astype(np.float32) + 0.1}
    ref, _ = jl.batch_norm(jnp.asarray(x), params, state, train=False)
    got = tl.batch_norm(nchw(x), *(torch.from_numpy(a) for a in (
        params["scale"], params["bias"], state["mean"], state["var"])))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=ATOL)


def test_batch_norm_eval_with_bf16_statistics():
    """The bf16 serving forward casts the BN statistics to bf16 as the JAX
    one does (footprints_tpu/export.py): eval mode normalises in f32 from
    the bf16-rounded statistics, and returns bf16."""
    x = torch.from_numpy(_rand(5, 2, 8, 5, 6)).to(torch.bfloat16)
    rng = np.random.RandomState(6)
    w, b, mean = (torch.from_numpy(a).to(torch.bfloat16) for a in (
        rng.rand(8).astype(np.float32) + 0.5, rng.randn(8).astype(np.float32),
        rng.randn(8).astype(np.float32)))
    var = torch.from_numpy(rng.rand(8).astype(np.float32) + 0.1).to(torch.bfloat16)
    got = tl.batch_norm(x, w, b, mean, var)
    assert got.dtype == torch.bfloat16
    ref = torch.nn.functional.batch_norm(x.float(), mean.float(), var.float(), w.float(),
                                         b.float(), training=False, eps=1e-5)
    torch.testing.assert_close(got, ref.to(torch.bfloat16), atol=0, rtol=0)


@pytest.mark.parametrize("pad,hw", [(1, (4, 5)), (1, (2, 2)), (2, (5, 7))])
def test_reflect_pad(pad, hw):
    x = _rand(5, 2, *hw, 3)
    ref = jl.reflect_pad(jnp.asarray(x), pad)
    np.testing.assert_array_equal(nhwc(tl.reflect_pad(nchw(x), pad)),
                                  np.asarray(ref))


@pytest.mark.parametrize("hw", [(8, 8), (7, 9), (96, 320)])
def test_max_pool_3x3_s2(hw):
    x = _rand(6, 1, *hw, 4)
    ref = jl.max_pool_3x3_s2(jnp.asarray(x))
    np.testing.assert_array_equal(nhwc(tl.max_pool_3x3_s2(nchw(x))),
                                  np.asarray(ref))


@pytest.mark.parametrize("scale", [2, 3])
def test_upsample_nearest(scale):
    x = _rand(7, 2, 3, 5, 4)
    ref = jl.upsample_nearest(jnp.asarray(x), scale)
    np.testing.assert_array_equal(nhwc(tl.upsample_nearest(nchw(x), scale)),
                                  np.asarray(ref))


@pytest.mark.parametrize("scale", [2, 4, 8])
def test_upsample_bilinear(scale):
    x = _rand(8, 2, 3, 5, 2)
    ref = jl.upsample_bilinear(jnp.asarray(x), scale)
    np.testing.assert_allclose(nhwc(tl.upsample_bilinear(nchw(x), scale)),
                               np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("name", ["elu", "relu", "sigmoid"])
def test_activations(name):
    x = _rand(9, 1000) * 4
    ref = getattr(jl, name)(jnp.asarray(x))
    np.testing.assert_allclose(getattr(tl, name)(torch.from_numpy(x)).numpy(),
                               np.asarray(ref), atol=1e-6)


def test_sigmoid_to_depth():
    disp = np.random.RandomState(10).rand(3, 4, 5).astype(np.float32)
    ref = np.asarray(jops.sigmoid_to_depth(jnp.asarray(disp)))
    np.testing.assert_allclose(tops.sigmoid_to_depth(torch.from_numpy(disp)).numpy(),
                               ref, rtol=1e-6)
    np.testing.assert_allclose(tops.np_sigmoid_to_depth(disp),
                               jops.np_sigmoid_to_depth(disp), rtol=1e-6)


# --- init --------------------------------------------------------------------

def test_kaiming_uniform_bounds_and_determinism():
    conv = torch.nn.Conv2d(64, 32, 3)
    tinit.conv_kaiming_uniform_(conv, torch.Generator().manual_seed(1))
    bound = 1 / math.sqrt(64 * 9)
    w = conv.weight.detach()
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert conv.bias.detach().abs().max() <= bound
    assert abs(w.std().item() - bound / math.sqrt(3)) < 0.02 * bound
    again = torch.nn.Conv2d(64, 32, 3)
    tinit.conv_kaiming_uniform_(again, torch.Generator().manual_seed(1))
    torch.testing.assert_close(again.weight, conv.weight, rtol=0, atol=0)


def test_kaiming_normal_fanout_std():
    conv = torch.nn.Conv2d(64, 128, 3, bias=False)
    tinit.conv_kaiming_normal_fanout_(conv, torch.Generator().manual_seed(2))
    std = math.sqrt(2 / (128 * 9))
    assert abs(conv.weight.detach().std().item() - std) < 0.02 * std
    assert abs(conv.weight.detach().mean().item()) < 0.02 * std


def test_network_init_is_seeded_and_bn_identity():
    a = FootprintNetwork(18, generator=torch.Generator().manual_seed(5)).state_dict()
    b = FootprintNetwork(18, generator=torch.Generator().manual_seed(5)).state_dict()
    c = FootprintNetwork(18, generator=torch.Generator().manual_seed(6)).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["encoder.layer0.0.weight"], c["encoder.layer0.0.weight"])
    assert torch.equal(a["encoder.layer0.1.running_var"], torch.ones(64))
    assert torch.equal(a["mask_decoder.block1.pre_concat_conv.bn1.weight"],
                       torch.ones(256))
    assert int(a["encoder.layer0.1.num_batches_tracked"]) == 0


# --- encoder -----------------------------------------------------------------

@pytest.mark.parametrize("depth", [18, 34, 50])
def test_encoder_features_match_jax(depth):
    _, params, state, net = jax_model(depth, seed=depth)
    x = np.random.RandomState(11).rand(2, 64, 96, 3).astype(np.float32)
    ref, _ = jresnet.encoder_apply(params["encoder"], state["encoder"],
                                   jnp.asarray(x), depth=depth, train=False)
    with torch.no_grad():
        got = net.encoder(nchw(x))
    assert len(got) == 5
    assert [f.shape[1] for f in got] == list(tresnet.feature_channels(depth))
    for i, (g, r) in enumerate(zip(got, ref)):
        # the random stack grows activations into the hundreds: a relative
        # bar, 1e-5 of the feature's largest value (f32 over up to 50 layers)
        r = np.asarray(r)
        np.testing.assert_allclose(nhwc(g), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max(),
                                   err_msg=f"feature {i}")
