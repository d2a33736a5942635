"""Gradients of the port's three fused-conv wrappers (the registered
autograd of the custom op in footprints_tpu_torch/ops/fused_conv.py) held against the JAX package's
custom_vjp wrappers (ops/pallas_conv.py: up_conv_s2d_fused, s2d_conv_fused,
s2d_conv_res_fused; Pallas forward in interpret mode, XLA backward), and
against autograd through the port's plain version.

Each case draws x, w, b, residual and an output cotangent G with numpy and
differentiates sum(out * G).  Tolerances: atol 1e-4 + rtol 1e-4 against
JAX (f32 sums over up to 9*Ci*N*H*W terms taken in other orders), 1e-5
against the plain version (the same cuDNN-free CPU convs, another graph).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from footprints_tpu.ops import pallas_conv
from footprints_tpu.ops.s2d import depth_to_space, space_to_depth
from footprints_tpu_torch.ops import fused_conv as fc

TOL_JAX = 1e-4
TOL_PLAIN = 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_conv, "INTERPRET", True)


def _draw(seed, n, h, w_, ci, co, up):
    rng = np.random.RandomState(seed)
    ho, wo = (2 * h, 2 * w_) if up else (h, w_)
    return dict(x=rng.randn(n, h, w_, ci).astype(np.float32),
                w=(rng.randn(3, 3, ci, co) * 0.2).astype(np.float32),  # HWIO
                b=rng.randn(co).astype(np.float32),
                r=rng.randn(n, ho, wo, co).astype(np.float32),
                g=rng.randn(n, ho, wo, co).astype(np.float32))


def _leaf(a):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)


def _oihw(w_hwio):
    return _leaf(np.transpose(w_hwio, (3, 2, 0, 1)))


def _hwio(g_oihw):
    return np.transpose(g_oihw.numpy(), (2, 3, 1, 0))


def _close(got, ref, tol):
    np.testing.assert_allclose(got, np.asarray(ref), atol=tol, rtol=tol)


def _jax_grads(kind, d, act):
    """Grads (x, w HWIO, b[, residual]) of sum(out * G) through the JAX
    custom_vjp wrapper, in full-resolution NHWC."""
    g = jnp.asarray(d["g"])

    def f(x, w, b, r):
        if kind == "up":
            out = pallas_conv.up_conv_s2d_fused(x, w, b, act)
        elif kind == "reflect":
            out = pallas_conv.s2d_conv_fused(space_to_depth(x), w, b, act)
        else:
            out = pallas_conv.s2d_conv_res_fused(space_to_depth(x), w, b,
                                                 space_to_depth(r), act)
        return jnp.sum(depth_to_space(out) * g)

    args = [jnp.asarray(d[k]) for k in ("x", "w", "b", "r")]
    return jax.grad(f, argnums=(0, 1, 2, 3))(*args)


def _port(kind, d, act, plain=False):
    x, w, b, r = _leaf(d["x"]), _oihw(d["w"]), _leaf(d["b"]), _leaf(d["r"])
    if plain:
        pad_mode = "up2_reflect" if kind == "up" else "reflect"
        out = fc.fused_conv3x3_plain(x, w, b, r if kind == "res" else None,
                                     pad_mode=pad_mode, act=act)
    elif kind == "up":
        out = fc.up_conv_fused(x, w, b, act=act)
    elif kind == "reflect":
        out = fc.conv_reflect_fused(x, w, b, act=act)
    else:
        out = fc.conv_reflect_res_fused(x, w, b, r, act=act)
    (out * torch.from_numpy(d["g"])).sum().backward()
    return x.grad, w.grad, b.grad, r.grad


# the Pallas kernel tiles 4 rows (f32) of its s2d / low-res input
CASES = [("up", (4, 6, 4, 8)), ("up", (8, 5, 8, 4)),
         ("reflect", (8, 12, 4, 8)), ("reflect", (16, 10, 8, 6)),
         ("res", (8, 12, 4, 8)), ("res", (16, 10, 8, 6))]


@pytest.mark.parametrize("kind,shape", CASES)
@pytest.mark.parametrize("act", ["elu", "none"])
def test_grads_match_jax_custom_vjp(kind, shape, act):
    d = _draw(30, 2, *shape, up=kind == "up")
    ref = _jax_grads(kind, d, act)
    gx, gw, gb, gr = _port(kind, d, act)
    _close(gx.numpy(), ref[0], TOL_JAX)
    _close(_hwio(gw), ref[1], TOL_JAX)
    _close(gb.numpy(), ref[2], TOL_JAX)
    if kind == "res":
        _close(gr.numpy(), ref[3], TOL_JAX)
    else:
        assert gr is None


@pytest.mark.parametrize("kind,shape", CASES)
@pytest.mark.parametrize("act", ["elu", "none"])
def test_grads_match_autograd_of_plain_version(kind, shape, act):
    d = _draw(31, 2, *shape, up=kind == "up")
    got = _port(kind, d, act)
    ref = _port(kind, d, act, plain=True)
    for a, r in zip(got, ref):
        if r is None:
            assert a is None
        else:
            _close(a.numpy(), r.numpy(), TOL_PLAIN)


def test_block4_slice_view_weights_get_their_gradient():
    """Block4 passes its post conv1 weight as two input-channel slice views
    (nn/blocks.py): the up half to up_conv_fused, the skip half to
    conv_reflect_res_fused.  The gradient must reach the one [Co,2Ci,3,3]
    weight through both views, as it reaches the JAX composition's
    (footprints_tpu/nn/blocks.py:up_concat_block, gated Pallas path)."""
    rng = np.random.RandomState(32)
    n, h, w_, c = 2, 4, 6, 4
    x = rng.randn(n, h, w_, c).astype(np.float32)
    skip = rng.randn(n, 2 * h, 2 * w_, c).astype(np.float32)
    w = (rng.randn(3, 3, 2 * c, c) * 0.2).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    g = rng.randn(n, 2 * h, 2 * w_, c).astype(np.float32)

    def f(x, skip, w, b):
        r = pallas_conv.up_conv_s2d_fused(x, w[:, :, :c, :], jnp.zeros_like(b), "none")
        y = pallas_conv.s2d_conv_res_fused(space_to_depth(skip), w[:, :, c:, :],
                                           b, r, "elu")
        return jnp.sum(depth_to_space(y) * g)

    ref = jax.grad(f, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, skip, w, b)))

    tx, tskip, tw, tb = _leaf(x), _leaf(skip), _oihw(w), _leaf(b)
    r = fc.up_conv_fused(tx, tw[:, :c], None, act="none")
    y = fc.conv_reflect_res_fused(tskip, tw[:, c:], tb, r, act="elu")
    (y * torch.from_numpy(g)).sum().backward()
    _close(tx.grad.numpy(), ref[0], TOL_JAX)
    _close(tskip.grad.numpy(), ref[1], TOL_JAX)
    _close(_hwio(tw.grad), ref[2], TOL_JAX)
    _close(tb.grad.numpy(), ref[3], TOL_JAX)


def test_no_grad_forward_builds_no_graph():
    d = _draw(33, 1, 4, 6, 4, 4, up=False)
    x, w, b = _leaf(d["x"]), _oihw(d["w"]), _leaf(d["b"])
    with torch.no_grad():
        y = fc.conv_reflect_fused(x, w, b)
    assert y.grad_fn is None and not y.requires_grad
    assert fc.conv_reflect_fused(x, w, b).grad_fn is not None
