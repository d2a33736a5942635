"""One train step of the port's Segmentor trainer
(footprints_tpu_torch/preprocessing/segmentation/trainer.py:
build_train_step, in f32 and in bf16 mixed precision) against the JAX
package's step on the CPU, and the fused conv's bf16 gradients at the
Segmentor's 5 decoder sites against the JAX custom_vjps.

The step: Segmentor-18 at 64x96, batch 2, from the same weights (the port's
seeded init with randomised BN, carried into the JAX pytree by the weight
bridge) and the same numpy batch.  The JAX step is the seg trainer's loss
function (Segmentor.apply, train-mode BN, compute_seg_losses; bf16 compute
copies of every param and of the image when mixed), differentiated with
jax.grad at precision "highest".

Tolerances:
  * f32 (PSP on and off), the FootprintNetwork step's bars
    (tests/test_torch_train_step.py): loss terms and BN running stats
    1e-5; each gradient leaf ||d||/||ref|| < 2e-2; the Adam update at
    1e-8 plus one f32 ulp of the parameter (2^-22 relative; BN scales sit
    near 1, where an ulp is 1.2e-7): optax.adam applied to the port's
    gradients gives the port's updated params (on identical gradients the
    two updates are the same arithmetic, rounded in other orders).
    Measured: both packages' f32 gradients sit within 1e-4 of an f64 port
    step at every leaf (worst ~1e-5 on this input).
  * bf16 (PSP on), bars at about twice the worst measured here: loss terms
    5e-6 from JAX's f32 step's (the port's worst 2.56e-6; JAX's f32 step
    sits 1.1e-7 from an f64 step, JAX's bf16 step up to 1.06e-5 from it), and
    more than 1e-6 from the port's f32 step's somewhere (the bf16 casts ran);
    BN running stats 2e-2 (worst 9.5e-3, running
    variances of bf16 activations); the whole gradient (all leaves as one
    vector) ||d||/||ref|| < 0.1 (0.041); each leaf < 0.75 (worst 0.380,
    encoder.layer4[0].down_conv.w).  The leaf bar is above 0.1 because at
    batch 2 the deep encoder's BN sees 12 to 48 values per channel: its
    backward subtracts nearly equal bf16-rounded terms, so both packages'
    bf16 gradients sit 0.31-0.37 from an f64 step at those leaves.  What
    holds them instead: every leaf of the port's gradient, and the whole
    of it, is no farther from the f64 step's than twice the JAX gradient's
    distance to it, plus 1e-3 at a leaf (whole: 0.045 and 0.040 measured;
    the worst leaf's ratio 1.48-1.51, the least margin 1.6e-3 at the decoder's
    outconv3 bias, 6e-4 from f64 on both sides), and the masters stay f32
    on both sides.
  * the 5 fused sites in bf16 (the op's autograd against up_conv_s2d_fused,
    s2d_conv_fused and s2d_conv_res_fused, Pallas in interpret mode, on
    the same bf16-rounded inputs and cotangent; bf16 convs and sums on both
    sides, each rounded to 8 bits), about twice the worst measured: the x,
    w and residual gradients ||d||/||ref|| < 1e-2 (worst 4.0e-3) and
    elementwise within 2e-2 max|ref| (8.3e-3); the bias gradients, sums of
    N H W bf16 cotangents of both signs whose cancellation magnifies each
    term's rounding, ||d||/||ref|| < 4e-2 (1.8e-2) and elementwise within
    4e-2 max|ref| (2.0e-2).
"""

import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from footprints_tpu.models import Segmentor as JaxSegmentor
from footprints_tpu.ops import pallas_conv
from footprints_tpu.ops.s2d import depth_to_space, space_to_depth
from footprints_tpu.preprocessing.segmentation.losses import compute_seg_losses as jax_seg_losses
from footprints_tpu_torch.convert import (segmentor_jax_params_from_state_dict,
                                          segmentor_state_dict_from_jax_params)
from footprints_tpu_torch.models import Segmentor
from footprints_tpu_torch.ops import fused_conv as fc
from footprints_tpu_torch.preprocessing.segmentation import trainer as seg_trainer
from footprints_tpu_torch.train import step as tstep

from ._torch_port import _randomise_bn

H, W, N = 64, 96, 2
LR = 1e-4


def _batch():
    rng = np.random.RandomState(4)
    return {"image": rng.rand(N, H, W, 3).astype(np.float32),
            "ground_mask": (rng.rand(N, H, W) > 0.5).astype(np.float32),
            "labelled_pix": (rng.rand(N, H, W) > 0.2).astype(np.float32)}


def _weights(psp):
    """The seeded port Segmentor-18's weights with randomised BN, as JAX
    (params, state) numpy pytrees."""
    sd = Segmentor(18, psp, generator=torch.Generator().manual_seed(3)).state_dict()
    params, state = segmentor_jax_params_from_state_dict(sd, 18, psp)
    rng = np.random.RandomState(3)
    return _randomise_bn(params, rng), _randomise_bn(state, rng)


def _jax_step(psp, mixed, params, state, batch):
    """(grads, new BN state, losses) of the JAX seg trainer's loss."""
    jnet = JaxSegmentor(18, psp)

    def loss_fn(p):
        if mixed:
            p = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
            image = batch["image"].astype(jnp.bfloat16)
        else:
            image = batch["image"]
        outputs, new_state = jnet.apply(p, state, image, train=True)
        losses = jax_seg_losses(outputs, batch["ground_mask"], batch["labelled_pix"])
        return losses["loss"], (new_state, losses)

    grads, (new_state, losses) = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    return jax.tree.map(np.asarray, (grads, new_state, losses))


def _port_step(psp, dtype, params, state, batch):
    """The port's step from the same weights: (metrics, net, grads as a JAX
    pytree of numpy arrays)."""
    net = Segmentor(18, psp)
    net.load_state_dict(segmentor_state_dict_from_jax_params(params, state, 18, psp))
    net.to(dtype if dtype == torch.float64 else torch.float32)
    optimizer = tstep.make_optimizer(net, tstep.TrainStepConfig())
    step = seg_trainer.build_train_step(net, optimizer, lambda s: LR,
                                        torch.float32 if dtype == torch.float64 else dtype)
    metrics = step(0, {k: torch.from_numpy(v).to(next(net.parameters()).dtype)
                       for k, v in batch.items()})
    sd = {k: np.zeros(tuple(v.shape), np.float64) for k, v in net.state_dict().items()}
    sd.update({n: p.grad.double().numpy() for n, p in net.named_parameters()
               if p.grad is not None})
    return metrics, net, segmentor_jax_params_from_state_dict(sd, 18, psp)[0]


@functools.lru_cache(maxsize=None)
def _steps(psp, mixed):
    """The JAX step, the port's step and the port's f64 step, from one
    set of weights and one batch."""
    params, state = _weights(psp)
    batch = _batch()
    jax_out = _jax_step(psp, mixed, params, state, {k: jnp.asarray(v) for k, v in batch.items()})
    port = _port_step(psp, torch.bfloat16 if mixed else torch.float32, params, state, batch)
    f64 = _port_step(psp, torch.float64, params, state, batch)
    return params, state, jax_out, port, f64


def _leaf_rels(got, ref):
    """{leaf path: ||got - ref|| / ||ref||} over two pytrees of one structure."""
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(flat_got) == len(flat_ref)
    return {jax.tree_util.keystr(p): float(
        np.linalg.norm(np.asarray(g, np.float64) - np.asarray(flat_ref[p], np.float64))
        / max(np.linalg.norm(np.asarray(flat_ref[p], np.float64)), 1e-30))
        for p, g in flat_got}


def _global_rel(got, ref):
    a = np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(got)])
    b = np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(ref)])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bn_state(net, psp):
    return segmentor_jax_params_from_state_dict(net.state_dict(), 18, psp)[1]


# --- f32 -----------------------------------------------------------------------

@pytest.mark.parametrize("psp", [True, False], ids=["psp", "no_psp"])
def test_f32_step_losses_and_bn_state_match_jax(psp):
    _, _, (_, jstate, jlosses), (metrics, net, _), _ = _steps(psp, False)
    assert sorted(metrics) == sorted([*jlosses, "lr"]) and metrics["lr"] == LR
    for k, v in jlosses.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    got = _bn_state(net, psp)
    assert jax.tree.structure(got) == jax.tree.structure(jstate)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("psp", [True, False], ids=["psp", "no_psp"])
def test_f32_step_gradients_match_jax(psp):
    _, _, (jgrads, _, _), (_, net, grads), (_, _, g64) = _steps(psp, False)
    rels = _leaf_rels(grads, jgrads)
    worst = max(rels, key=rels.get)
    print(f"worst gradient leaf {worst}: {rels[worst]:.2e}")
    assert rels[worst] < 2e-2, (worst, rels[worst])
    # every pytree leaf got a gradient, and nothing else did
    n_grads = sum(p.grad is not None for p in net.parameters())
    assert n_grads == len(jax.tree.leaves(jgrads)) == len(rels)
    # both f32 gradients sit near the f64 step's on this input
    assert max(_leaf_rels(grads, g64).values()) < 1e-4
    assert max(_leaf_rels(jgrads, g64).values()) < 1e-4


@pytest.mark.parametrize("psp", [True, False], ids=["psp", "no_psp"])
def test_f32_step_adam_update_matches_optax(psp):
    """optax.adam on the port's gradients, from the same params, gives the
    port's updated params."""
    params, _, _, (_, net, grads), _ = _steps(psp, False)
    optimizer = optax.adam(LR)

    @jax.jit
    def adam_step(p, g):
        updates, _ = optimizer.update(g, optimizer.init(p), p)
        return optax.apply_updates(p, updates)

    want = adam_step(*jax.tree.map(lambda a: np.asarray(a, np.float32), (params, grads)))
    got = segmentor_jax_params_from_state_dict(net.state_dict(), 18, psp)[0]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-8, rtol=2.0 ** -22)


# --- bf16 mixed precision -----------------------------------------------------

def test_bf16_step_losses_and_bn_state_match_jax():
    """The loss terms within 5e-6 of JAX's f32 step's, and not the port's
    f32 step's (a step that skipped the bf16 casts sits within 1e-7 of
    it); the BN running stats within 2e-2 of JAX's bf16 step's.  JAX's f32
    step stands for the exact step: block2's post-concat conv1 rounds apart
    in bf16 here (the fused path's up half and skip half, as block4's) and
    once in JAX (unfused at this size), so the two bf16 steps no longer
    round alike at the 1/8-scale head, where JAX's bf16 loss sits 1.06e-5
    from the exact one and the port's 2.45e-6."""
    _, _, (_, jstate, _), (metrics, net, _), _ = _steps(True, True)
    jlosses = _steps(True, False)[2][2]
    f32 = _steps(True, False)[3][0]
    for k, v in jlosses.items():
        assert metrics[k].dtype == torch.float32
        np.testing.assert_allclose(metrics[k].item(), float(v), atol=5e-6, rtol=0, err_msg=k)
    assert max(abs(metrics[k].item() - f32[k].item()) for k in jlosses) > 1e-6
    for a, b in zip(jax.tree.leaves(_bn_state(net, True)), jax.tree.leaves(jstate)):
        assert a.dtype == np.float32 and np.asarray(b).dtype == np.float32
        np.testing.assert_allclose(a, b, atol=2e-2, rtol=0)


def test_bf16_step_gradients_match_jax():
    _, _, (jgrads, _, _), (_, net, grads), (_, _, g64) = _steps(True, True)
    # the masters and their gradients stay f32 on both sides
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in net.parameters() if p.grad is not None)
    assert {np.asarray(g).dtype for g in jax.tree.leaves(jgrads)} == {np.dtype(np.float32)}
    rels = _leaf_rels(grads, jgrads)
    worst = max(rels, key=rels.get)
    whole = _global_rel(grads, jgrads)
    port_f64, jax_f64 = _global_rel(grads, g64), _global_rel(jgrads, g64)
    leaf_port_f64, leaf_jax_f64 = _leaf_rels(grads, g64), _leaf_rels(jgrads, g64)
    ratio = {k: v / max(leaf_jax_f64[k], 1e-30) for k, v in leaf_port_f64.items()}
    print(f"worst gradient leaf {worst}: {rels[worst]:.3f}; whole gradient {whole:.3f}; "
          f"from the f64 step: port {port_f64:.3f}, JAX {jax_f64:.3f}; worst leaf ratio "
          f"{max(ratio.values()):.3f}")
    assert rels[worst] < 0.75, (worst, rels[worst])
    assert whole < 0.1
    assert port_f64 <= 2 * jax_f64
    # leaf by leaf, the port is no farther from the f64 step than twice JAX
    for k, v in leaf_port_f64.items():
        assert v <= 2 * leaf_jax_f64[k] + 1e-3, (k, v, leaf_jax_f64[k])


def test_bf16_step_differs_from_f32():
    """The mixed step really ran in bf16: its loss moves off the f32 step's
    by more than f32 rounding, and by less than bf16's bars."""
    (_, _, _, (m32, _, _), _), (_, _, _, (m16, _, _), _) = _steps(True, False), _steps(True, True)
    assert 1e-7 < abs(m16["loss"].item() - m32["loss"].item()) < 1e-2


# --- 5 kinds of kernel call in bf16 at small shapes, against the JAX custom_vjps --

@pytest.fixture
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_conv, "INTERPRET", True)


# (name, kind, low-res or full-res input [N,H,W,Ci], Co, bias?, act): the
# Segmentor's block4 post-concat ConvBlock and tail at small widths; the
# bf16 Pallas kernel tiles 8 rows of its low-res or s2d input
SITES = [("block4.post.conv1.up_half", "up", (2, 8, 6, 8), 8, False, "none"),
         ("block4.post.conv1.skip_half", "res", (2, 16, 12, 8), 8, True, "elu"),
         ("block4.post.conv2", "reflect", (2, 16, 12, 8), 8, True, "elu"),
         ("tail.conv1", "up", (2, 8, 6, 8), 4, True, "elu"),
         ("tail.conv2", "reflect", (2, 16, 12, 4), 4, True, "elu")]


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


@pytest.mark.usefixtures("_interpret_mode")
@pytest.mark.parametrize("site", SITES, ids=[s[0] for s in SITES])
def test_bf16_site_gradients_match_jax_custom_vjp(site):
    _, kind, shape, co, with_bias, act = site
    rng = np.random.RandomState(50)
    n, h, w_, ci = shape
    ho, wo = (2 * h, 2 * w_) if kind == "up" else (h, w_)
    d = {"x": rng.randn(*shape), "w": rng.randn(3, 3, ci, co) * 0.2,  # HWIO
         "b": rng.randn(co) if with_bias else np.zeros(co),
         "r": rng.randn(n, ho, wo, co), "g": rng.randn(n, ho, wo, co)}
    d = {k: _bf16(v) for k, v in d.items()}  # the same bf16-rounded inputs

    def f(x, w, b, r):
        if kind == "up":
            out = pallas_conv.up_conv_s2d_fused(x, w, b, act)
        elif kind == "reflect":
            out = pallas_conv.s2d_conv_fused(space_to_depth(x), w, b, act)
        else:
            out = pallas_conv.s2d_conv_res_fused(space_to_depth(x), w, b,
                                                 space_to_depth(r), act)
        assert out.dtype == jnp.bfloat16
        return jnp.sum(depth_to_space(out).astype(jnp.float32) * d["g"].astype(np.float32))

    ref = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(d[k], jnp.bfloat16) for k in ("x", "w", "b", "r")))
    ref = [np.asarray(a, np.float32) for a in ref]

    def leaf(a):
        return torch.from_numpy(np.ascontiguousarray(a.astype(np.float32))).to(
            torch.bfloat16).requires_grad_(True)

    x, w, b, r = leaf(d["x"]), leaf(np.transpose(d["w"], (3, 2, 0, 1))), leaf(d["b"]), leaf(d["r"])
    if kind == "up":
        y = fc.up_conv_fused(x, w, b if with_bias else None, act=act)
    elif kind == "reflect":
        y = fc.conv_reflect_fused(x, w, b, act=act)
    else:
        y = fc.conv_reflect_res_fused(x, w, b, r, act=act)
    assert y.dtype == torch.bfloat16
    (y.float() * torch.from_numpy(d["g"].astype(np.float32))).sum().backward()
    got = {"x": x.grad, "w": np.transpose(w.grad.float().numpy(), (2, 3, 1, 0)),
           "b": b.grad, "r": r.grad}
    checks = [("x", 0), ("w", 1)] + ([("b", 2)] if with_bias else []) + (
        [("r", 3)] if kind == "res" else [])
    for k, i in checks:
        a = got[k] if k == "w" else got[k].float().numpy()
        if k != "w":
            assert got[k].dtype == torch.bfloat16
        e = ref[i]
        rel = np.linalg.norm(a - e) / np.linalg.norm(e)
        bar = 4e-2 if k == "b" else 1e-2
        assert rel < bar, (k, rel)
        assert (np.abs(a - e) <= (4e-2 if k == "b" else 2e-2) * np.abs(e).max()).all(), k
