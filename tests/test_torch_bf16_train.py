"""bf16 mixed-precision training of the port's FootprintNetwork
(train/step.py with ``compute_dtype='bfloat16'`` and both packed heads, and
``main --mode train --compute_dtype bfloat16``) held against the JAX
package on the CPU.

The step: FootprintNetwork-18 at 64x96, batch 2, from the same weights (the
port's seeded init with randomised BN, carried into the JAX pytree by the
weight bridge) and the same numpy batch, through each package's own train
step (footprints_tpu/train/step.py:build_train_step, bf16 compute copies of
every param and of the image, the packed heads, the f32 loss).  JAX's
gradient is its first Adam moment over (1 - b1).  The reference for both is
the port's step in f64 (f32 loss, f64 everywhere else).

Bars, as tests/test_torch_seg_step.py holds the bf16 seg step:
  * the port's whole gradient (all leaves as one vector) no farther from
    the f64 step's than twice the JAX gradient's distance to it, and each
    leaf no farther than twice JAX's plus 1e-3: at batch 2 the deep
    encoder's BN backward subtracts nearly equal bf16-rounded terms, so
    both packages' bf16 gradients sit far from f64 at those leaves;
  * the masters, their gradients, Adam's moments and the loss stay f32;
  * the loss terms within 1.5e-4 of JAX's (bf16 forwards that round in
    other places; worst measured 6.6e-5) and the BN running stats within
    2e-2 (running variances of bf16 activations; worst 1.0e-2);
  * the bf16 eval step's loss terms within 1.5e-4 + 1.5e-4|ref| of the f32
    eval step's (worst 7.4e-5 relative).
  The two packages round differently at block4's post-concat conv1: the
  JAX composition adds two bf16 results in bf16, the port's fused site
  adds the bf16-rounded up-conv to its f32 accumulator.  That is inside
  these bars.  At a logit of exactly 0 the port's loss gradient is
  sigmoid(0) - t and JAX's is -t (ROADMAP.md §3).  The step counts such
  logits and prints the count; the comparison keeps them in: this input
  gives 1 of the port's 98304 mask logits (its f64 step none), where the
  port's gradient is the f64 step's, so it can only move the port towards
  the reference.

The trainer: ``main --mode train --compute_dtype bfloat16 --device cpu``
trains, validates in bf16 with the packed heads, checkpoints in f32 and
resumes; the JAX ModelManager loads its checkpoint, and the port loads the
JAX ModelManager's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from footprints_tpu.convert import footprint_params_from_state_dict
from footprints_tpu.model_manager import ModelManager as JaxModelManager
from footprints_tpu.models import FootprintNetwork as JaxFootprintNetwork
from footprints_tpu.train import step as jstep
from footprints_tpu_torch import main as port_main
from footprints_tpu_torch.checkpoint import load_checkpoint
from footprints_tpu_torch.convert import (jax_params_from_state_dict,
                                          state_dict_from_jax_params, unravel_params)
from footprints_tpu_torch.models import FootprintNetwork
from footprints_tpu_torch.options import Options
from footprints_tpu_torch.train import step as tstep
from footprints_tpu_torch.train.trainer import TrainManager

from ._torch_port import _randomise_bn
from .test_torch_packed_heads import _batch
from .test_torch_trainer import _argv
from .test_trainer_e2e import _make_kitti_tree

DEPTH = 18


def _config(dtype, cls=tstep.TrainStepConfig):
    """The step's config (the port's, or the JAX package's ``cls``): both
    heads on, the forward in ``dtype`` (f64 runs the f32 config on an f64
    net)."""
    return cls(steps_per_epoch=5, s2d_head=True, p4_head=True,
               compute_dtype="bfloat16" if dtype == torch.bfloat16 else None)


def _weights():
    sd = FootprintNetwork(DEPTH, generator=torch.Generator().manual_seed(3)).state_dict()
    params, state = jax_params_from_state_dict(sd, DEPTH)
    rng = np.random.RandomState(3)
    return _randomise_bn(params, rng), _randomise_bn(state, rng)


def _jax_step(params, state, batch):
    """JAX's bf16 step: (gradient pytree, new train state, metrics)."""
    config = _config(torch.bfloat16, cls=jstep.TrainStepConfig)
    ts = {"params": params, "state": state,
          "opt_state": jstep.make_optimizer(config).init(params),
          "step": jnp.zeros((), jnp.int32)}
    new_ts, metrics = jstep.build_train_step(JaxFootprintNetwork(DEPTH), config)(
        jax.tree.map(np.array, ts), {k: jnp.asarray(v) for k, v in batch.items()})
    new_ts = jax.tree.map(np.asarray, new_ts)
    (_, mu, _), _ = new_ts["opt_state"]
    return unravel_params(mu / 0.1, params), new_ts, metrics


def _port_step(dtype, params, state, batch):
    """The port's step from the same weights: (metrics, net, optimizer,
    gradient pytree, the count of logits that are exactly 0)."""
    net = FootprintNetwork(DEPTH)
    net.load_state_dict(state_dict_from_jax_params(params, state, DEPTH))
    net.to(torch.float64 if dtype == torch.float64 else torch.float32)
    zeros = []
    net.mask_decoder.register_forward_hook(
        lambda module, inputs, out: zeros.append(sum(int((v == 0).sum())
                                                     for v in out.values())))
    config = _config(dtype)
    optimizer = tstep.make_optimizer(net, config)
    metrics = tstep.build_train_step(net, optimizer, config)(
        0, {k: torch.from_numpy(v).to(next(net.parameters()).dtype)
            for k, v in batch.items()})
    sd = {k: np.zeros(tuple(v.shape), np.float64) for k, v in net.state_dict().items()}
    sd.update({n: p.grad.double().numpy() for n, p in net.named_parameters()
               if p.grad is not None})
    return metrics, net, optimizer, jax_params_from_state_dict(sd, DEPTH)[0], zeros[0]


@pytest.fixture(scope="module")
def steps():
    params, state = _weights()
    batch = _batch(70)
    return {"jax": _jax_step(params, state, batch),
            "bf16": _port_step(torch.bfloat16, params, state, batch),
            "f32": _port_step(torch.float32, params, state, batch),
            "f64": _port_step(torch.float64, params, state, batch)}


def _leaf_rels(got, ref):
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(flat_got) == len(flat_ref)
    return {jax.tree_util.keystr(p): float(
        np.linalg.norm(np.asarray(g, np.float64) - np.asarray(flat_ref[p], np.float64))
        / max(np.linalg.norm(np.asarray(flat_ref[p], np.float64)), 1e-30))
        for p, g in flat_got}


def _whole_rel(got, ref):
    a = np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(got)])
    b = np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(ref)])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bf16_step_gradient_is_no_farther_from_f64_than_twice_jax(steps):
    jgrads = steps["jax"][0]
    grads, zeros = steps["bf16"][3], steps["bf16"][4]
    g64 = steps["f64"][3]
    print(f"exact-zero logits: bf16 step {zeros}, f64 step {steps['f64'][4]}")
    port_f64, jax_f64 = _whole_rel(grads, g64), _whole_rel(jgrads, g64)
    leaf_port, leaf_jax = _leaf_rels(grads, g64), _leaf_rels(jgrads, g64)
    ratio = {k: v / max(leaf_jax[k], 1e-30) for k, v in leaf_port.items()}
    worst = max(ratio, key=ratio.get)
    print(f"whole gradient from the f64 step: port {port_f64:.4f}, JAX {jax_f64:.4f}; "
          f"worst leaf ratio {worst}: {ratio[worst]:.3f} ({leaf_port[worst]:.4f} against "
          f"{leaf_jax[worst]:.4f}); port to JAX {_whole_rel(grads, jgrads):.4f}")
    assert port_f64 <= 2 * jax_f64
    for k, v in leaf_port.items():
        assert v <= 2 * leaf_jax[k] + 1e-3, (k, v, leaf_jax[k])


def test_bf16_step_keeps_masters_adam_state_and_loss_in_f32(steps):
    metrics, net, optimizer, _, _ = steps["bf16"]
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(p.grad.dtype == torch.float32 for p in net.parameters() if p.grad is not None)
    assert optimizer.state and all(
        s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32
        for s in optimizer.state.values())
    assert all(v.dtype == torch.float32 for k, v in metrics.items() if k != "lr")
    new_ts = steps["jax"][1]
    (_, mu, nu), _ = new_ts["opt_state"]
    assert mu.dtype == nu.dtype == np.float32
    assert {a.dtype for a in jax.tree.leaves(new_ts["params"])} == {np.dtype(np.float32)}


def test_bf16_step_losses_and_bn_state_match_jax(steps):
    _, new_ts, jmetrics = steps["jax"]
    metrics, net = steps["bf16"][:2]
    assert sorted(metrics) == sorted(jmetrics) and len(metrics) == 22
    worst = max(abs(metrics[k].item() - float(v)) for k, v in jmetrics.items() if k != "lr")
    print(f"worst loss term gap to JAX: {worst:.2e}")
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), atol=1.5e-4, rtol=0,
                                   err_msg=k)
    state = jax_params_from_state_dict(net.state_dict(), DEPTH)[1]
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(new_ts["state"])):
        assert a.dtype == np.float32 and np.asarray(b).dtype == np.float32
        np.testing.assert_allclose(a, b, atol=2e-2, rtol=0)


def test_bf16_step_differs_from_f32(steps):
    """The mixed step really ran in bf16: its loss moves off the f32
    step's by more than f32 rounding, and by less than bf16's bars."""
    gap = abs(steps["bf16"][0]["loss"].item() - steps["f32"][0]["loss"].item())
    assert 1e-7 < gap < 1e-2


def test_bf16_eval_step_runs_in_bf16_with_the_heads(steps):
    """Validation runs in the training dtype and with its heads, as JAX's
    build_eval_step does; its losses stay f32 and near the f32 eval's."""
    net = steps["bf16"][1]
    seen = []
    hook = net.mask_decoder.register_forward_hook(
        lambda module, inputs, out: seen.append({v.dtype for v in out.values()}))
    batch = {k: torch.from_numpy(v) for k, v in _batch(71).items()}
    try:
        got = tstep.build_eval_step(net, _config(torch.bfloat16))(batch)
        ref = tstep.build_eval_step(net, _config(torch.float32))(batch)
    finally:
        hook.remove()
    assert seen == [{torch.bfloat16}, {torch.float32}]
    assert sorted(got) == sorted(ref) and "visible_ground/1/1" in got
    for k, v in ref.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].item(), v.item(), atol=1.5e-4, rtol=1.5e-4,
                                   err_msg=k)


# --- the trainer through the entry point ------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_bf16")
    return root, _make_kitti_tree(root)


@pytest.mark.parametrize("dtype,heads,packed", [
    ("bfloat16", (), True), ("bfloat16", ("--s2d_head", "off", "--p4_head", "off"), False),
    ("float32", (), False), ("float32", ("--s2d_head", "on", "--p4_head", "on"), True)],
    ids=["bf16_auto", "bf16_off", "f32_auto", "f32_on"])
def test_trainer_packs_targets_for_the_heads(tree, dtype, heads, packed):
    root, config = tree
    tm = TrainManager(Options().parse(_argv(root, config, "--compute_dtype", dtype, *heads)))
    assert tm.step_config.s2d_head is tm.step_config.p4_head is packed
    batch = tm._put(next(iter(tm.val_loader)))
    tm.val_iter.close()
    assert ("depth@s2d" in batch and "moving_object_mask@s2d2" in batch) is packed
    assert len(batch) == 7 + 12 * packed


def test_main_trains_bf16_checkpoints_and_resumes(tree, tmp_path):
    root, config = tree
    argv = _argv(root, config, "--model_name", "bf16", "--compute_dtype", "bfloat16")
    manager = port_main.main(argv)
    assert manager.step_config.s2d_head and manager.step_config.p4_head
    assert [(mode, step) for mode, step, _ in manager.logged] == [("train", 0), ("val", 0)]
    for _, _, losses in manager.logged:
        assert len(losses) == 21 and all(np.isfinite(v) for v in losses.values())
    assert all(p.dtype == torch.float32 for p in manager.model_manager.net.parameters())
    weights = root / "logs" / "bf16" / "models" / "weights_0"
    ckpt = load_checkpoint(str(weights / "checkpoint.npz"))
    assert int(ckpt["step"]) == int(ckpt["opt_state"][0][0]) == 1
    assert all(np.asarray(a).dtype == np.float32 for a in jax.tree.leaves(ckpt["params"]))

    # resume in the port, Adam moments included
    tm = TrainManager(Options().parse(argv + ["--load_path", str(weights)]))
    assert tm.step == 1
    (_, mu, nu), _ = tm.model_manager.train_state()["opt_state"]
    np.testing.assert_array_equal(mu, ckpt["opt_state"][0][1])
    np.testing.assert_array_equal(nu, ckpt["opt_state"][0][2])
    tm.val_iter.close()

    # the JAX package's ModelManager loads it ...
    jmm = JaxModelManager(save_folder=str(tmp_path), depth=DEPTH)
    jmm.save_model("jax_init")
    jmm.load_model(str(weights), load_optimiser=True)
    sd = {k: v.numpy() for k, v in manager.model_manager.net.state_dict().items()}
    want = footprint_params_from_state_dict(sd, depth=DEPTH)
    for got, ref in zip((jmm.params, jmm.state), want):
        assert jax.tree.structure(got) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, b)
    assert int(jmm.step) == 1

    # ... and the port's bf16 trainer loads the JAX ModelManager's
    jax_init = load_checkpoint(str(tmp_path / "jax_init" / "checkpoint.npz"))
    tm = TrainManager(Options().parse(argv + ["--load_path", str(tmp_path / "jax_init")]))
    got = jax_params_from_state_dict(tm.model_manager.net.state_dict(), DEPTH)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves((jax_init["params"],
                                                           jax_init["state"]))):
        np.testing.assert_array_equal(a, b)
    tm.val_iter.close()
