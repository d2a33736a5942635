"""The fused conv's backward kernels' plain versions and ops on the CPU
(footprints_tpu_torch/ops/fused_conv.py: fused_conv3x3_dgrad_plain,
fused_conv3x3_wgrad_plain, up2_phase_weights_adjoint, the ops
footprints::fused_conv3x3_dgrad / _wgrad and the op's backward).

References, on inputs drawn with numpy from a seed:
  * the JAX package's hand VJPs: jax.vjp of ops/s2d.py:up_conv_to_s2d (the
    phase form's _edge_conv_phase_bwd) and s2d_conv3x3_reflect
    (_s2d_reflect_conv_bwd), and of the pallas_conv custom_vjp wrappers with
    the Pallas forward in interpret mode; atol = rtol = 1e-4 (f32 sums of up
    to N H W terms taken in other orders);
  * autograd of fused_conv3x3_plain in f64, at 1e-9 (the same sums in
    another order and form: the gather and phase forms against the padded
    and upsampled composition).
The kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from footprints_tpu.ops import pallas_conv
from footprints_tpu.ops.s2d import (depth_to_space, s2d_conv3x3_reflect, space_to_depth,
                                    up_conv_to_s2d)
from footprints_tpu_torch.ops import fused_conv as fc

TOL_JAX = 1e-4
TOL_F64 = 1e-9


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_conv, "INTERPRET", True)


def _draw(seed, n, h, w_, ci, co, up, dtype=np.float32):
    """x [N,H,W,Ci], w HWIO [3,3,Ci,Co], a pre-activation cotangent gz of the
    output's shape."""
    rng = np.random.RandomState(seed)
    ho, wo = (2 * h, 2 * w_) if up else (h, w_)
    return (rng.randn(n, h, w_, ci).astype(dtype),
            (rng.randn(3, 3, ci, co) * 0.2).astype(dtype),
            rng.randn(n, ho, wo, co).astype(dtype))


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w_hwio, (3, 2, 0, 1))))


def _hwio(g_oihw):
    return np.transpose(g_oihw.numpy(), (2, 3, 1, 0))


def _plain(x, w, gz, pad_mode):
    """(gx, gw HWIO) of the port's plain versions, as numpy."""
    tx, tw, tg = torch.from_numpy(x), _oihw(w), torch.from_numpy(gz)
    gx = fc.fused_conv3x3_dgrad_plain(tg, tw, pad_mode=pad_mode)
    gw = fc.fused_conv3x3_wgrad_plain(tg, tx, pad_mode=pad_mode)
    return gx.numpy(), _hwio(gw)


def _jax_vjp(fn, x, w, gz):
    _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
    return [np.asarray(g) for g in vjp(jnp.asarray(gz))]


def _jax_s2d(kind, x, w, gz):
    """The JAX package's hand VJP of its XLA composition (ops/s2d.py)."""
    if kind == "up":
        return _jax_vjp(lambda x, w: depth_to_space(up_conv_to_s2d(x, w)), x, w, gz)
    return _jax_vjp(lambda x, w: depth_to_space(s2d_conv3x3_reflect(space_to_depth(x), w)),
                    x, w, gz)


def _jax_pallas(kind, x, w, gz):
    """The VJP of the Pallas kernel's custom_vjp wrappers (interpret mode),
    act 'none' and a zero bias, so the cotangent is the pre-activation's."""
    b = jnp.zeros(w.shape[-1], jnp.float32)
    if kind == "up":
        return _jax_vjp(lambda x, w: depth_to_space(
            pallas_conv.up_conv_s2d_fused(x, w, b, "none")), x, w, gz)
    return _jax_vjp(lambda x, w: depth_to_space(
        pallas_conv.s2d_conv_fused(space_to_depth(x), w, b, "none")), x, w, gz)


def _close(got, ref, tol):
    np.testing.assert_allclose(got, np.asarray(ref), atol=tol, rtol=tol)


# the s2d forms need even full-resolution H and W; the Pallas kernel tiles
# 4 rows of its s2d / low-res input
@pytest.mark.parametrize("kind,shape", [("up", (4, 6, 4, 8)), ("up", (8, 5, 8, 4)),
                                        ("up", (1, 1, 4, 3)), ("up", (3, 7, 32, 16)),
                                        ("reflect", (8, 12, 4, 8)), ("reflect", (16, 10, 8, 6)),
                                        ("reflect", (4, 4, 3, 5)), ("reflect", (6, 14, 32, 32))])
def test_plain_versions_match_jax_hand_vjp(kind, shape):
    x, w, gz = _draw(40, 2, *shape, up=kind == "up")
    got = _plain(x, w, gz, "up2_reflect" if kind == "up" else "reflect")
    for a, r in zip(got, _jax_s2d(kind, x, w, gz)):
        _close(a, r, TOL_JAX)


@pytest.mark.parametrize("kind,shape", [("up", (4, 6, 4, 8)), ("reflect", (8, 12, 4, 8))])
def test_plain_versions_match_jax_pallas_wrappers_vjp(kind, shape):
    x, w, gz = _draw(41, 2, *shape, up=kind == "up")
    got = _plain(x, w, gz, "up2_reflect" if kind == "up" else "reflect")
    for a, r in zip(got, _jax_pallas(kind, x, w, gz)):
        _close(a, r, TOL_JAX)


def _f64_autograd(x, w, gz, pad_mode):
    tx = torch.from_numpy(x).double().requires_grad_(True)
    tw = _oihw(w).double().requires_grad_(True)
    y = fc.fused_conv3x3_plain(tx, tw, pad_mode=pad_mode, act="none")
    return torch.autograd.grad(y, (tx, tw), torch.from_numpy(gz).double())


# tiny and ragged shapes: H or W = 2 at reflect (both reflect folds on one
# row or column), 3 (rows 1 and H-2 the same), 1x1 and 1-wide at up2 (all
# phase taps clamped onto one pixel)
@pytest.mark.parametrize("pad_mode,hw", [("reflect", (2, 2)), ("reflect", (2, 5)),
                                         ("reflect", (5, 2)), ("reflect", (3, 3)),
                                         ("reflect", (7, 9)), ("up2_reflect", (1, 1)),
                                         ("up2_reflect", (1, 4)), ("up2_reflect", (3, 1)),
                                         ("up2_reflect", (2, 2)), ("up2_reflect", (5, 7))])
@pytest.mark.parametrize("ci,co", [(3, 5), (8, 2)])
def test_plain_versions_match_f64_autograd_of_plain_forward(pad_mode, hw, ci, co):
    x, w, gz = _draw(42, 2, *hw, ci, co, up=pad_mode == "up2_reflect", dtype=np.float64)
    ref_x, ref_w = _f64_autograd(x, w, gz, pad_mode)
    tg = torch.from_numpy(gz)
    gx = fc.fused_conv3x3_dgrad_plain(tg, _oihw(w), pad_mode=pad_mode)
    gw = fc.fused_conv3x3_wgrad_plain(tg, torch.from_numpy(x), pad_mode=pad_mode)
    assert gx.dtype == gw.dtype == torch.float64
    torch.testing.assert_close(gx, ref_x, atol=TOL_F64, rtol=TOL_F64)
    torch.testing.assert_close(gw, ref_w, atol=TOL_F64, rtol=TOL_F64)


@pytest.mark.parametrize("seed", [0, 1])
def test_up2_phase_weights_adjoint_identity(seed):
    """<up2_phase_weights(w), G> = <w, up2_phase_weights_adjoint(G)>, and the
    adjoint is linear: a 0/1 matrix from the 16 phase taps to the 9 taps,
    each 3x3 tap fed by 4 phase taps (2 row x 2 column incidences)."""
    rng = np.random.RandomState(seed)
    w = torch.from_numpy(rng.randn(4, 3, 3, 3))
    g = torch.from_numpy(rng.randn(2, 2, 4, 3, 2, 2))
    lhs = (fc.up2_phase_weights(w) * g).sum()
    rhs = (w * fc.up2_phase_weights_adjoint(g)).sum()
    torch.testing.assert_close(lhs, rhs, atol=1e-12, rtol=1e-12)
    ones = fc.up2_phase_weights_adjoint(torch.ones(2, 2, 1, 1, 2, 2))
    torch.testing.assert_close(ones, torch.full((1, 1, 3, 3), 4.0, dtype=ones.dtype))


@pytest.mark.parametrize("pad_mode", ["reflect", "up2_reflect"])
def test_dgrad_reads_a_slice_view_weight(pad_mode):
    """Block4 passes its post conv1 weight as input-channel slice views
    (nn/blocks.py): dgrad on the view equals dgrad on its contiguous copy,
    and the op's backward puts each half's gradient into the one weight."""
    x, w, gz = _draw(43, 2, 4, 5, 6, 3, up=pad_mode == "up2_reflect")
    full = torch.from_numpy(np.random.RandomState(44).randn(3, 16, 3, 3).astype(np.float32))
    full[:, 5:11] = _oihw(w)
    view = full[:, 5:11]
    tg = torch.from_numpy(gz)
    assert not view.is_contiguous()
    torch.testing.assert_close(fc.fused_conv3x3_dgrad(tg, view, pad_mode=pad_mode),
                               fc.fused_conv3x3_dgrad(tg, view.contiguous(), pad_mode=pad_mode),
                               atol=0, rtol=0)
    leaf = full.clone().requires_grad_(True)
    y = fc._fused(torch.from_numpy(x), leaf[:, 5:11], None, None, pad_mode, "none")
    (y * tg).sum().backward()
    want = torch.zeros_like(full)
    want[:, 5:11] = fc.fused_conv3x3_wgrad_plain(tg, torch.from_numpy(x), pad_mode=pad_mode)
    torch.testing.assert_close(leaf.grad, want, atol=1e-6, rtol=1e-6)


SUBSETS = [s for s in itertools.product([False, True], repeat=4) if any(s)]


@pytest.mark.parametrize("needs", SUBSETS, ids=lambda s: "".join("xwbr"[i] for i in range(4)
                                                                  if s[i]))
@pytest.mark.parametrize("pad_mode", ["reflect", "up2_reflect"])
def test_backward_runs_only_what_needs_input_grad_asks(monkeypatch, needs, pad_mode):
    """The op's backward runs dgrad only when x needs a gradient and wgrad
    only when w does, returns None for every input that needs none, and
    its gradients equal autograd's through the plain composition."""
    calls = []
    for name in ("_dgrad_plain", "_wgrad_plain"):
        real = getattr(fc, name)
        monkeypatch.setattr(fc, name, lambda *a, _real=real, _name=name: (
            calls.append(_name), _real(*a))[1])
    up = pad_mode == "up2_reflect"
    x, w, gz = _draw(45, 2, 3, 4, 5, 3, up=up)
    rng = np.random.RandomState(46)
    b = rng.randn(3).astype(np.float32)
    r = rng.randn(*gz.shape).astype(np.float32)
    base = [torch.from_numpy(x), _oihw(w), torch.from_numpy(b), torch.from_numpy(r)]
    leaves = [t.clone().requires_grad_(need) for t, need in zip(base, needs)]
    y = fc._fused(*leaves, pad_mode, "elu")
    (y * torch.from_numpy(gz)).sum().backward()
    assert calls == [n for n, need in (("_dgrad_plain", needs[0]), ("_wgrad_plain", needs[1]))
                     if need]
    ref = [t.clone().requires_grad_(True) for t in base]
    (fc.fused_conv3x3_plain(*ref, pad_mode=pad_mode, act="elu")
     * torch.from_numpy(gz)).sum().backward()
    for leaf, want, need in zip(leaves, ref, needs):
        if not need:
            assert leaf.grad is None
        else:
            torch.testing.assert_close(leaf.grad, want.grad, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("pad_mode", ["reflect", "up2_reflect"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_opcheck_backward_ops_cpu(pad_mode, dtype):
    """torch.library.opcheck on the backward ops' CPU implementations:
    schema, fake implementation and their use under tracing (neither op is
    differentiable: no input requires grad)."""
    x, w, gz = (torch.from_numpy(a).to(dtype) for a in _draw(
        47, 2, 3, 5, 4, 3, up=pad_mode == "up2_reflect"))
    w = w.permute(3, 2, 0, 1).contiguous()
    torch.library.opcheck(fc.fused_conv3x3_dgrad_op, (gz, w, pad_mode))
    torch.library.opcheck(fc.fused_conv3x3_wgrad_op, (gz, x, pad_mode))


@pytest.mark.parametrize("pad_mode", ["reflect", "up2_reflect"])
def test_bf16_plain_versions_sum_in_f32_and_round_once(pad_mode):
    """A bf16 cotangent (the mixed-precision steps on the CPU) gives bf16
    gradients: the f32 plain version's on the same bf16 values, rounded
    once."""
    x, w, gz = (torch.from_numpy(a).to(torch.bfloat16) for a in _draw(
        48, 2, 5, 6, 8, 4, up=pad_mode == "up2_reflect"))
    w = w.permute(3, 2, 0, 1).contiguous()
    gx = fc.fused_conv3x3_dgrad(gz, w, pad_mode=pad_mode)
    gw = fc.fused_conv3x3_wgrad(gz, x, pad_mode=pad_mode)
    assert gx.dtype == gw.dtype == torch.bfloat16
    f32 = [t.float() for t in (x, w, gz)]
    assert torch.equal(gx, fc.fused_conv3x3_dgrad_plain(f32[2], f32[1], pad_mode=pad_mode)
                       .to(torch.bfloat16))
    assert torch.equal(gw, fc.fused_conv3x3_wgrad_plain(f32[2], f32[0], pad_mode=pad_mode)
                       .to(torch.bfloat16))


def test_backward_ops_raise_on_what_the_kernels_do_not_take():
    gz = torch.zeros(1, 5, 6, 4)
    with pytest.raises(ValueError, match="even"):
        fc.fused_conv3x3_dgrad(gz, torch.zeros(4, 2, 3, 3), pad_mode="up2_reflect")
    with pytest.raises(ValueError, match="contiguous NHWC"):
        fc.fused_conv3x3_dgrad(gz.transpose(1, 2), torch.zeros(4, 2, 3, 3), pad_mode="reflect")
    with pytest.raises(ValueError, match="OIHW"):
        fc.fused_conv3x3_dgrad(gz, torch.zeros(4, 2, 3, 3).transpose(2, 3), pad_mode="reflect")
    with pytest.raises(ValueError, match=r"x must be a contiguous NHWC \[1,5,6,Ci\]"):
        fc.fused_conv3x3_wgrad(gz, torch.zeros(1, 5, 5, 2), pad_mode="reflect")
    with pytest.raises(ValueError, match="reflect padding needs"):
        fc.fused_conv3x3_wgrad(torch.zeros(1, 1, 6, 4), torch.zeros(1, 1, 6, 2),
                               pad_mode="reflect")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fc.fused_conv3x3_wgrad(gz.half(), torch.zeros(1, 5, 6, 2).half(), pad_mode="reflect")


# the dgrad kernel's weight pre-pack: its plain version (the kernel's own is
# held against it bit for bit on the card, tests/test_torch_cuda.py)

def _unpack(packed, dtype, pad_mode, ci, co):
    """fused_conv3x3_dgrad_pack_plain's bytes -> [hi, lo] (f32) or [bf16]
    taps [Co, Ci, taps], undoing its documented layout."""
    n_tile, chunk, taps, planes = fc.dgrad_pack_geometry(dtype, pad_mode, ci)
    e = 4 if dtype == torch.float32 else 8
    n_ci, n_chunks = -(-ci // n_tile), -(-co // chunk)
    halves = 2 if dtype == torch.float32 else 1
    t = packed.view(dtype).reshape(n_ci, planes, n_chunks, halves, taps, n_tile // 8,
                                   chunk // e, 8, e)
    # back to [hl, chunk, kb, e, ci tile, nb, nr, plane, tap]
    t = t.permute(3, 2, 6, 8, 0, 5, 7, 1, 4).reshape(halves, n_chunks * chunk, n_ci * n_tile,
                                                     planes * taps)
    return t[:, :co, :ci]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("ci,co", [(8, 4), (33, 40), (64, 32)])
def test_dgrad_pack_plain_folds_as_jax_phase_kernels(seed, ci, co):
    """At 'up2_reflect' the pack's 16 taps are the JAX package's phase
    kernels (footprints_tpu/ops/upconv.py:_phase_kernels, rows summed
    first): hi + lo within 2^-21 relative of them in f32, and the bf16
    pack equal to them rounded to bf16."""
    from footprints_tpu.ops.upconv import _phase_kernels

    rng = np.random.RandomState(60 + seed)
    w_hwio = rng.randn(3, 3, ci, co).astype(np.float32)
    kernels = _phase_kernels(jnp.asarray(w_hwio))
    # [a][b] of [ty, tx, ci, co] -> [co, ci, ((a*2 + b)*2 + ty)*2 + tx]
    ref = np.stack([np.asarray(kernels[a][b]) for a in range(2) for b in range(2)])
    ref = torch.from_numpy(ref.reshape(4, 2, 2, ci, co).transpose(4, 3, 0, 1, 2)
                           .reshape(co, ci, 16).copy())
    w = _oihw(w_hwio)
    hi, lo = _unpack(fc.fused_conv3x3_dgrad_pack_plain(w, pad_mode="up2_reflect"),
                     torch.float32, "up2_reflect", ci, co)
    err = (hi.double() + lo.double() - ref.double()).abs()
    assert bool((err <= 2.0 ** -21 * ref.double().abs()).all())
    (b16,) = _unpack(fc.fused_conv3x3_dgrad_pack_plain(w.to(torch.bfloat16),
                                                       pad_mode="up2_reflect"),
                     torch.bfloat16, "up2_reflect", ci, co)
    ref16 = fc.up2_phase_weights(w.to(torch.bfloat16).float())
    ref16 = ref16.permute(2, 3, 0, 1, 4, 5).reshape(co, ci, 16).to(torch.bfloat16)
    assert torch.equal(b16, ref16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode", ["reflect", "up2_reflect"])
@pytest.mark.parametrize("ci_lo,ci_hi,co", [(0, 3, 5), (5, 38, 17), (64, 128, 64), (0, 64, 70)])
def test_dgrad_pack_plain_layout_holds_every_tap_once(dtype, pad_mode, ci_lo, ci_hi, co):
    """Undoing the documented layout gives back the taps (the 9 of w, or
    up2_phase_weights' 16), from an input-channel slice view too, and every
    padded byte is zero: the pack is a permutation of the taps and zeros."""
    rng = np.random.RandomState(ci_hi + co)
    full = torch.from_numpy(rng.randn(co, 128, 3, 3).astype(np.float32)).to(dtype)
    w = full[:, ci_lo:ci_hi]
    ci = ci_hi - ci_lo
    packed = fc.fused_conv3x3_dgrad_pack_plain(w, pad_mode=pad_mode)
    got = _unpack(packed, dtype, pad_mode, ci, co)
    wf = w.float()
    taps = (wf.reshape(co, ci, 9) if pad_mode == "reflect" else
            fc.up2_phase_weights(wf).permute(2, 3, 0, 1, 4, 5).reshape(co, ci, 16))
    if dtype == torch.float32:
        torch.testing.assert_close(got[0].double() + got[1].double(), taps.double(),
                                   atol=0, rtol=2.0 ** -21)
    else:
        assert torch.equal(got[0], taps.to(torch.bfloat16))
    nonzero = int((packed.view(dtype) != 0).sum())
    assert nonzero == int((got != 0).sum())


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7e4, 3e30])
def test_tf32_split_plain(scale):
    """The 3xTF32 split of the backward kernels, emulated on the f32 bits:
    hi is exactly representable in TF32 (13 low bits zero) and the nearest
    such value (ties away from zero), lo the same of the rest, and hi + lo
    is the input within 2^-21 relative."""
    rng = np.random.RandomState(int(np.log10(scale) + 40))
    v = torch.from_numpy((rng.randn(4096) * scale).astype(np.float32))
    hi, lo = fc.tf32_split_plain(v)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    step = hi.abs().double() * 2.0 ** -10  # a TF32 ulp is at least 2^-11 |hi|
    assert bool(((hi.double() - v.double()).abs() <= step / 2 * 1.0001).all())
    err = (hi.double() + lo.double() - v.double()).abs()
    assert bool((err <= 2.0 ** -21 * v.double().abs()).all())
    # ties go away from zero: 1 + 2^-11 lies halfway between TF32's 1 and 1 + 2^-10
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert fc.tf32_round_plain(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


@pytest.mark.parametrize("intervals,most", [([], 0), ([(0, 10)], 1),
                                            ([(0, 10), (5, 15), (12, 20)], 2),
                                            ([(0, 10), (10, 20)], 1),
                                            ([(0, 30), (1, 29), (2, 28), (40, 50)], 3)])
def test_probe_counts_blocks_resident_at_once(intervals, most):
    """The probe's blocks resident on an SM: the most of a block's (start,
    end) intervals that hold one instant (one that ends as another starts
    does not overlap it)."""
    from footprints_tpu_torch.ops.probe import most_overlapping

    assert most_overlapping(intervals) == most
