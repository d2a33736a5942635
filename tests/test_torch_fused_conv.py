"""The port's fused pad+conv3x3 module (footprints_tpu_torch/ops/fused_conv.py)
held against the JAX package's Pallas kernel (ops/pallas_conv.py), run
through the Pallas interpreter on the CPU.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.  f32 tolerance 1e-5, as
tests/test_pallas_conv.py uses.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from footprints_tpu.nn import blocks as jblocks
from footprints_tpu.nn.layers import conv2d as jconv2d
from footprints_tpu.nn.layers import reflect_pad as jreflect_pad
from footprints_tpu.ops import pallas_conv
from footprints_tpu.ops.upconv import _phase_kernels, conv3x3_on_nearest_up
from footprints_tpu.ops.s2d import (_phase_embedded_kernel, _s2d_kernel,
                                    depth_to_space, space_to_depth)
from footprints_tpu_torch.nn.blocks import (ConvBlock,
                                            ConvUpsampleAndConcatBlock,
                                            OutConvBlock, decoder_tail)
from footprints_tpu_torch.nn.layers import upsample_nearest
from footprints_tpu_torch.ops import fused_conv as fc

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_conv, "INTERPRET", True)


def _inputs(seed, n, h, w_, ci, co, res_hw=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w_, ci).astype(np.float32)
    w = (rng.randn(3, 3, ci, co) * 0.1).astype(np.float32)  # HWIO
    b = rng.randn(co).astype(np.float32)
    r = None if res_hw is None else rng.randn(n, *res_hw, co).astype(np.float32)
    return x, w, b, r


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w_hwio, (3, 2, 0, 1))))


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _port(x, w, b, r, **kw):
    with torch.no_grad():
        return fc.fused_conv3x3(_t(x), _oihw(w), _t(b), _t(r), **kw).numpy()


# --- kernel level: fused_conv3x3 against the Pallas kernel -----------------

@pytest.mark.parametrize("h,w_,ci,co,th", [(8, 12, 4, 6, 4), (3, 5, 8, 8, 3),
                                           (4, 7, 3, 5, 2)])
@pytest.mark.parametrize("act", ["elu", "none"])
@pytest.mark.parametrize("with_res", [False, True])
def test_reflect_matches_pallas_s2d_reflect(h, w_, ci, co, th, act, with_res):
    """pad_mode='reflect' at full resolution [2h,2w] (odd h/w among the
    s2d shapes) == depth_to_space of the Pallas s2d_reflect kernel."""
    x, w, b, r = _inputs(1, 2, 2 * h, 2 * w_, ci, co,
                         res_hw=(2 * h, 2 * w_) if with_res else None)
    ref = pallas_conv.fused_conv3x3(
        space_to_depth(jnp.asarray(x)), _s2d_kernel(jnp.asarray(w)),
        jnp.tile(jnp.asarray(b), 4),
        None if r is None else space_to_depth(jnp.asarray(r)),
        pad_mode="s2d_reflect", act=act, th=th, interpret=True)
    got = _port(x, w, b, r, pad_mode="reflect", act=act)
    np.testing.assert_allclose(got, np.asarray(depth_to_space(ref)), atol=ATOL)


@pytest.mark.parametrize("h,w_,ci,co,th", [(8, 12, 5, 7, 4), (6, 20, 16, 8, 3),
                                           (5, 7, 4, 6, 5), (3, 9, 3, 3, 1)])
@pytest.mark.parametrize("act", ["elu", "none"])
def test_up2_reflect_matches_pallas_edge(h, w_, ci, co, th, act):
    """pad_mode='up2_reflect' == depth_to_space of the Pallas 'edge' kernel
    with the phase-embedded weights (odd low-res H/W included)."""
    x, w, b, _ = _inputs(2, 2, h, w_, ci, co)
    ref = pallas_conv.fused_conv3x3(
        jnp.asarray(x), _phase_embedded_kernel(jnp.asarray(w)),
        jnp.tile(jnp.asarray(b), 4), pad_mode="edge", act=act, th=th,
        interpret=True)
    got = _port(x, w, b, None, pad_mode="up2_reflect", act=act)
    assert got.shape == (2, 2 * h, 2 * w_, co)
    np.testing.assert_allclose(got, np.asarray(depth_to_space(ref)), atol=ATOL)


@pytest.mark.parametrize("h,w_", [(5, 7), (2, 2), (9, 4)])
def test_reflect_matches_jax_conv_of_reflect_pad(h, w_):
    """Odd full-resolution H/W, which the s2d layout cannot hold: the plain
    contract conv2d(reflect_pad(x)) of footprints_tpu/nn/layers.py."""
    x, w, b, r = _inputs(3, 2, h, w_, 6, 5, res_hw=(h, w_))
    ref = jax.nn.elu(jconv2d(jreflect_pad(jnp.asarray(x), 1), jnp.asarray(w),
                             jnp.asarray(b)) + r)
    got = _port(x, w, b, r, pad_mode="reflect", act="elu")
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)


# --- the phase-fold spec of the up2_reflect kernel --------------------------

_PHASE_SHAPES = [(1, 1, 3, 2), (5, 7, 4, 6), (3, 9, 5, 3), (6, 1, 2, 4)]


@pytest.mark.parametrize("ci,co", [(3, 2), (5, 7)])
def test_up2_phase_weights_match_jax_phase_kernels(ci, co):
    """The kernel's folded 2x2 taps == footprints_tpu/ops/upconv.py's."""
    _, w, _, _ = _inputs(20, 1, 1, 1, ci, co)
    ref = _phase_kernels(jnp.asarray(w))  # [a][b] HWIO [2,2,ci,co]
    got = fc.up2_phase_weights(_oihw(w))  # [2,2,co,ci,2,2]
    assert got.shape == (2, 2, co, ci, 2, 2)
    for a in range(2):
        for b in range(2):
            np.testing.assert_allclose(
                got[a, b].permute(2, 3, 1, 0).numpy(), np.asarray(ref[a][b]),
                atol=ATOL)


@pytest.mark.parametrize("h,w_,ci,co", _PHASE_SHAPES)
def test_up2_phase_conv_plain_matches_jax_conv3x3_on_nearest_up(h, w_, ci, co):
    x, w, b, _ = _inputs(21, 2, h, w_, ci, co)
    ref = conv3x3_on_nearest_up(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                precision=jax.lax.Precision.HIGHEST)
    with torch.no_grad():
        got = fc.up2_phase_conv_plain(_t(x), _oihw(w), _t(b)).numpy()
    assert got.shape == (2, 2 * h, 2 * w_, co)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("h,w_,ci,co", _PHASE_SHAPES)
def test_up2_phase_conv_plain_matches_fused_plain(h, w_, ci, co):
    """The 4-tap phase form == the 9-tap contract of pad_mode='up2_reflect'."""
    x, w, b, _ = _inputs(22, 2, h, w_, ci, co)
    with torch.no_grad():
        got = fc.up2_phase_conv_plain(_t(x), _oihw(w), _t(b))
        ref = fc.fused_conv3x3_plain(_t(x), _oihw(w), _t(b),
                                     pad_mode="up2_reflect", act="none")
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)


# --- the three wrappers against their JAX counterparts ---------------------

@pytest.mark.parametrize("h,w_,ci,co", [(4, 6, 4, 8), (8, 5, 8, 4)])
@pytest.mark.parametrize("act", ["elu", "none"])
def test_up_conv_fused_matches_jax(h, w_, ci, co, act):
    x, w, b, _ = _inputs(4, 2, h, w_, ci, co)
    ref = pallas_conv.up_conv_s2d_fused(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(b), act)
    with torch.no_grad():
        got = fc.up_conv_fused(_t(x), _oihw(w), _t(b), act=act).numpy()
    np.testing.assert_allclose(got, np.asarray(depth_to_space(ref)), atol=ATOL)


@pytest.mark.parametrize("h,w_,ci,co", [(8, 14, 4, 8), (16, 10, 8, 6)])
def test_conv_reflect_fused_matches_jax(h, w_, ci, co):
    x, w, b, _ = _inputs(5, 2, h, w_, ci, co)
    ref = pallas_conv.s2d_conv_fused(space_to_depth(jnp.asarray(x)),
                                     jnp.asarray(w), jnp.asarray(b), "elu")
    with torch.no_grad():
        got = fc.conv_reflect_fused(_t(x), _oihw(w), _t(b), act="elu").numpy()
    np.testing.assert_allclose(got, np.asarray(depth_to_space(ref)), atol=ATOL)


@pytest.mark.parametrize("h,w_,ci,co", [(8, 14, 4, 8), (16, 10, 8, 6)])
def test_conv_reflect_res_fused_matches_jax(h, w_, ci, co):
    x, w, b, r = _inputs(6, 2, h, w_, ci, co, res_hw=(h, w_))
    ref = pallas_conv.s2d_conv_res_fused(
        space_to_depth(jnp.asarray(x)), jnp.asarray(w), jnp.asarray(b),
        space_to_depth(jnp.asarray(r)), "elu")
    with torch.no_grad():
        got = fc.conv_reflect_res_fused(_t(x), _oihw(w), _t(b), _t(r),
                                        act="elu").numpy()
    np.testing.assert_allclose(got, np.asarray(depth_to_space(ref)), atol=ATOL)


# --- the blocks that hold the kernel sites ----------------------------------

def _load_conv(conv, p):
    with torch.no_grad():
        conv.weight.copy_(_oihw(np.asarray(p["w"])))
        conv.bias.copy_(torch.from_numpy(np.array(p["b"])))


def _load_conv_block(block, p):
    _load_conv(block.conv1, p["conv1"])
    _load_conv(block.conv2, p["conv2"])


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def test_block4_fused_matches_jax_pallas_path(monkeypatch):
    """ConvUpsampleAndConcatBlock(fused=True) == the JAX up_concat_block on
    its gated Pallas serving path (interpret mode)."""
    monkeypatch.setattr(pallas_conv, "pallas_supported", lambda *a, **k: True)
    params, state = jblocks.init_up_concat_block_asym(jax.random.PRNGKey(0),
                                                      24, 32, 16)
    rng = np.random.RandomState(8)
    x = rng.randn(2, 4, 8, 24).astype(np.float32)
    skip = rng.randn(2, 8, 16, 16).astype(np.float32)
    ref, _ = jblocks.up_concat_block(params, state, jnp.asarray(x),
                                     jnp.asarray(skip), train=False, fast=True)
    block = ConvUpsampleAndConcatBlock(24, 32, 16, fused=True)
    _load_conv_block(block.pre_concat_conv, params["pre"])
    _load_conv_block(block.post_concat_conv, params["post"])
    with torch.no_grad():
        got = block(_nchw(x), _nchw(skip)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)


def test_block4_fused_matches_unfused():
    torch.manual_seed(0)
    fused = ConvUpsampleAndConcatBlock(12, 16, fused=True)
    plain = ConvUpsampleAndConcatBlock(12, 16, fused=False)
    plain.load_state_dict(fused.state_dict())
    rng = np.random.RandomState(9)
    x, skip = _nchw(rng.randn(2, 3, 5, 12).astype(np.float32)), \
        _nchw(rng.randn(2, 6, 10, 16).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(fused(x, skip).numpy(),
                                   plain(x, skip).numpy(), atol=ATOL)


def test_block2_fused_matches_jax_unfused_block():
    """Block2 of a ResNet-18/34 decoder (256 -> 128 channels, skip 128) on
    its fused path == the JAX up_concat_block at the same shapes, which runs
    it unfused (``fast=False``: the skip's 24x80 map is below
    ``_S2D_MIN_PIXELS``)."""
    params, state = jblocks.init_up_concat_block_asym(jax.random.PRNGKey(3), 256, 128, 128)
    rng = np.random.RandomState(11)
    x = rng.randn(2, 12, 40, 256).astype(np.float32)
    skip = rng.randn(2, 24, 80, 128).astype(np.float32)
    ref, _ = jblocks.up_concat_block(params, state, jnp.asarray(x), jnp.asarray(skip),
                                     train=False, fast=False)
    block = ConvUpsampleAndConcatBlock(256, 128, 128, fused=True)
    _load_conv_block(block.pre_concat_conv, params["pre"])
    _load_conv_block(block.post_concat_conv, params["post"])
    with torch.no_grad():
        got = block(_nchw(x), _nchw(skip)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("skip_ch", [128, 512])
def test_block2_fused_matches_unfused_forward_and_gradients(skip_ch, dtype, tol):
    """ConvUpsampleAndConcatBlock(128, 128, skip_ch) at block2's layout (a
    12x40 input, a 24x80 skip, batch 2; the skip 128 channels wide under
    ResNet-18/34, 512 under ResNet-50): the fused path (the plain versions
    of the kernel's three sites, their gradients through the op's
    registered autograd) against the unfused block (upsample, concat,
    reflect pads, F.conv2d), forward and the gradients of x, the skip and
    every weight and bias.  Bars: ``tol`` + ``tol``|ref| for the output and
    the input gradients; ``tol`` max|ref| + ``tol``|ref| for the weight and
    bias gradients, each a sum of some 4000-8000 products added in another
    order.  The 512-wide skip sums 4x the products in conv1's skip half;
    the default init scales its weights by 1/sqrt(fan_in), so the sums
    keep their size and the bars hold as they are."""
    torch.manual_seed(12)
    fused = ConvUpsampleAndConcatBlock(128, 128, skip_ch, fused=True).to(dtype)
    plain = ConvUpsampleAndConcatBlock(128, 128, skip_ch, fused=False).to(dtype)
    plain.load_state_dict(fused.state_dict())
    g = torch.Generator().manual_seed(13)
    x = torch.randn(2, 12, 40, 128, generator=g, dtype=dtype)
    skip = torch.randn(2, 24, 80, skip_ch, generator=g, dtype=dtype)
    cot = torch.randn(2, 24, 80, 128, generator=g, dtype=dtype)

    def run(block):
        xs, ss = (_nchw(t.numpy()).requires_grad_() for t in (x, skip))
        y = block(xs, ss)
        (y * cot.permute(0, 3, 1, 2)).sum().backward()
        grads = {n: p.grad for n, p in block.named_parameters() if p.requires_grad}
        return y.detach(), {"x": xs.grad, "skip": ss.grad, **grads}

    got_y, got = run(fused)
    ref_y, ref = run(plain)
    torch.testing.assert_close(got_y, ref_y, atol=tol, rtol=tol)
    assert got.keys() == ref.keys() and len(got) == 2 + 8
    for k, want in ref.items():
        atol = tol * want.abs().max().item() if k not in ("x", "skip") else tol
        torch.testing.assert_close(got[k], want, atol=atol, rtol=tol, msg=k)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("skip_ch", [64, 256])
def test_block3_fused_pre_concat_matches_unfused_forward_and_gradients(skip_ch, dtype, tol):
    """ConvUpsampleAndConcatBlock(128, 64, skip_ch, fused_pre=True) at block3's
    layout (a 12x40 input, a 24x80 skip, batch 2; the skip 64 channels wide
    under ResNet-18/34, 256 under ResNet-50): the pre-concat ConvBlock on
    the kernel's 'reflect' route (the plain versions of its two sites, their
    gradients through the op's registered autograd) against the block on
    cuDNN's route (reflect pads, F.conv2d, ELU), forward and the gradients
    of x, the skip and every weight and bias, under the bars of
    test_block2_fused_matches_unfused_forward_and_gradients."""
    torch.manual_seed(14)
    fused = ConvUpsampleAndConcatBlock(128, 64, skip_ch, fused_pre=True).to(dtype)
    plain = ConvUpsampleAndConcatBlock(128, 64, skip_ch).to(dtype)
    plain.load_state_dict(fused.state_dict())
    assert fused.pre_concat_conv.fused and not plain.pre_concat_conv.fused
    g = torch.Generator().manual_seed(15)
    x = torch.randn(2, 12, 40, 128, generator=g, dtype=dtype)
    skip = torch.randn(2, 24, 80, skip_ch, generator=g, dtype=dtype)
    cot = torch.randn(2, 24, 80, 64, generator=g, dtype=dtype)

    def run(block):
        xs, ss = (_nchw(t.numpy()).requires_grad_() for t in (x, skip))
        y = block(xs, ss)
        (y * cot.permute(0, 3, 1, 2)).sum().backward()
        grads = {n: p.grad for n, p in block.named_parameters() if p.requires_grad}
        return y.detach(), {"x": xs.grad, "skip": ss.grad, **grads}

    got_y, got = run(fused)
    ref_y, ref = run(plain)
    torch.testing.assert_close(got_y, ref_y, atol=tol, rtol=tol)
    assert got.keys() == ref.keys() and len(got) == 2 + 8
    for k, want in ref.items():
        atol = tol * want.abs().max().item() if k not in ("x", "skip") else tol
        torch.testing.assert_close(got[k], want, atol=atol, rtol=tol, msg=k)


def test_block3_fused_pre_concat_matches_jax_conv_block():
    """ConvBlock(128, 64, fused=True), block3's pre-concat ConvBlock on the
    kernel's route, == the JAX package's conv_block (reflect pads, XLA
    convs, ELU) at block3's widths on a 12x40 map, batch 2: the output, and
    under one cotangent (jax.vjp) the gradients of x and of every weight
    and bias.  Bars: ATOL for the output and x's gradient, ATOL max|ref| +
    ATOL|ref| for the weight and bias gradients (sums of 960 pixels' products
    added in another order)."""
    params, state = jblocks.init_conv_block(jax.random.PRNGKey(4), 128, 64)
    rng = np.random.RandomState(16)
    x = rng.randn(2, 12, 40, 128).astype(np.float32)
    cot = rng.randn(2, 12, 40, 64).astype(np.float32)
    ref, vjp = jax.vjp(lambda p, a: jblocks.conv_block(p, state, a)[0], params,
                       jnp.asarray(x))
    ref_p, ref_x = vjp(jnp.asarray(cot))
    block = ConvBlock(128, 64, fused=True)
    _load_conv_block(block, params)
    xs = _nchw(x).requires_grad_()
    y = block(xs)
    (y * _nchw(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=ATOL)
    np.testing.assert_allclose(xs.grad.permute(0, 2, 3, 1).numpy(), np.asarray(ref_x),
                               atol=ATOL)
    for name in ("conv1", "conv2"):
        conv, want = getattr(block, name), ref_p[name]
        for got, ref_g in ((conv.weight.grad, _oihw(np.asarray(want["w"])).numpy()),
                           (conv.bias.grad, np.asarray(want["b"]))):
            np.testing.assert_allclose(got.numpy(), ref_g, rtol=ATOL,
                                       atol=ATOL * np.abs(ref_g).max(), err_msg=name)


@pytest.mark.parametrize("apply_sigmoid", [False, True])
def test_decoder_tail_matches_jax_pallas_path(monkeypatch, apply_sigmoid):
    monkeypatch.setattr(pallas_conv, "pallas_supported", lambda *a, **k: True)
    conv_p, conv_s = jblocks.init_conv_block(jax.random.PRNGKey(1), 24, 32)
    out_p = jblocks.init_out_conv_block(jax.random.PRNGKey(2), 32, 2)
    x = np.random.RandomState(10).randn(2, 4, 8, 24).astype(np.float32)
    ref, _ = jblocks.decoder_tail(conv_p, conv_s, out_p, jnp.asarray(x),
                                  apply_sigmoid=apply_sigmoid, train=False)
    conv_block = ConvBlock(24, 32)
    out_block = OutConvBlock(32, 2, 1, apply_sigmoid)
    _load_conv_block(conv_block, conv_p)
    _load_conv(out_block.conv1, out_p["conv1"])
    with torch.no_grad():
        got = decoder_tail(conv_block, out_block, _nchw(x))
        naive = out_block(conv_block(upsample_nearest(_nchw(x), 2)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), atol=ATOL)


# --- the wrapper's contract -------------------------------------------------

def _good(**over):
    args = dict(x=torch.randn(1, 4, 5, 3), w=torch.randn(2, 3, 3, 3),
                b=torch.randn(2), residual=None, pad_mode="reflect", act="elu")
    args.update(over)
    return args


@pytest.mark.parametrize("bad,exc", [
    (dict(x=torch.randn(1, 4, 5, 3, dtype=torch.float16)), TypeError),
    (dict(x=torch.randn(1, 5, 4, 3).transpose(1, 2)), ValueError),
    (dict(x=torch.randn(4, 5, 3)), ValueError),
    (dict(w=torch.randn(2, 4, 3, 3)), ValueError),
    (dict(w=torch.randn(3, 3, 3, 2).permute(3, 2, 0, 1)), ValueError),
    (dict(w=torch.randn(2, 6, 3, 3)[:, ::2]), ValueError),
    (dict(w=torch.randn(2, 3, 3, 3, dtype=torch.bfloat16)), ValueError),
    (dict(b=torch.randn(3)), ValueError),
    (dict(residual=torch.randn(1, 4, 5, 3)), ValueError),
    (dict(residual=torch.randn(1, 4, 5, 2, dtype=torch.bfloat16)), ValueError),
    (dict(pad_mode="edge"), ValueError),
    (dict(act="relu"), ValueError),
    (dict(x=torch.randn(1, 1, 5, 3)), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, exc):
    with pytest.raises(exc):
        with torch.no_grad():
            fc.fused_conv3x3(**_good(**bad))


@pytest.mark.parametrize("lo,hi", [(0, 3), (5, 8), (2, 5)])
def test_wrapper_takes_input_channel_slice_view(lo, hi):
    """An input-channel slice of a contiguous OIHW weight (as block4 passes
    its two halves) is taken as it is, no copy, at any channel offset."""
    full = torch.randn(2, 8, 3, 3)
    w = full[:, lo:hi]
    assert not w.is_contiguous() and w.stride() == (72, 9, 3, 1)
    args = _good(w=w)
    with torch.no_grad():
        got = fc.fused_conv3x3(**args)
        ref = fc.fused_conv3x3_plain(**{**args, "w": w.contiguous()})
    torch.testing.assert_close(got, ref)


def test_wrapper_refuses_grad_inputs():
    """The raw kernel wrapper records no graph; gradients go through the
    three autograd wrappers (tests/test_torch_fused_grad.py)."""
    args = _good(w=torch.randn(2, 3, 3, 3, requires_grad=True))
    with pytest.raises(RuntimeError, match="records no autograd graph"):
        fc.fused_conv3x3(**args)


def test_cpu_runs_plain_version_and_counts_no_launch():
    args = _good()
    before = fc.fused_conv3x3.launches
    with torch.no_grad():
        got = fc.fused_conv3x3(**args)
        ref = fc.fused_conv3x3_plain(**args)
    assert fc.fused_conv3x3.launches == before
    assert got.shape == (1, 4, 5, 2) and got.is_contiguous()
    torch.testing.assert_close(got, ref)


def test_f64_on_cpu_runs_the_plain_version():
    """f64 reference runs (chip_smoke.py's CPU step) go through the plain
    version; the kernel has no f64 route."""
    args = _good(x=torch.randn(1, 4, 5, 3, dtype=torch.float64),
                 w=torch.randn(2, 3, 3, 3, dtype=torch.float64),
                 b=torch.randn(2, dtype=torch.float64))
    with torch.no_grad():
        got = fc.fused_conv3x3(**args)
        ref = fc.fused_conv3x3_plain(**args)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


def test_bf16_on_cpu_matches_f32_plain():
    x, w, b, r = _inputs(11, 2, 6, 10, 8, 8, res_hw=(6, 10))
    to16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    x16, w16, b16, r16 = to16(x), to16(_oihw(w).numpy()), to16(b), to16(r)
    with torch.no_grad():
        got = fc.fused_conv3x3(x16, w16, b16, r16, pad_mode="reflect", act="elu")
        ref = fc.fused_conv3x3_plain(x16.float(), w16.float(), b16.float(),
                                     r16.float(), pad_mode="reflect", act="elu")
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref, atol=2e-2, rtol=2e-2)
