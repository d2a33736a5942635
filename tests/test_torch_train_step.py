"""The port's training step (footprints_tpu_torch/train/, nn/layers.py)
held against the JAX package on the CPU: train-mode BatchNorm, the 4-scale
loss, Adam with the StepLR schedule, and one whole train step of
FootprintNetwork-18 from the same weights and batch.

Tolerances: BN and the losses are short f32 reductions (1e-5, 1e-6); Adam
updates at lr 1e-4 on parameters of magnitude 1e-3 are exact to f32
rounding (1e-8); the whole step holds losses and BN running stats at 1e-5
and each gradient leaf at ||d||/||ref|| < 2e-2, the bar of
tests/test_grad_parity.py (near-cancelling encoder gradients move by
~1e-3 relative from summation order alone).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from footprints_tpu.nn import layers as jl
from footprints_tpu.train import losses as jlosses
from footprints_tpu.train import step as jstep
from footprints_tpu_torch.convert import jax_params_from_state_dict, unravel_params
from footprints_tpu_torch.model_manager import ModelManager
from footprints_tpu_torch.nn import layers as tl
from footprints_tpu_torch.train import losses as tlosses
from footprints_tpu_torch.train import step as tstep

from ._torch_port import jax_model, nchw, nhwc

SCALES = ("1/8", "1/4", "1/2", "1/1")


def _targets(n, h, w, seed):
    rng = np.random.RandomState(seed)
    return {
        "depth": (rng.rand(n, h, w) * 20 * (rng.rand(n, h, w) > 0.3)).astype(np.float32),
        "visible_ground": (rng.rand(n, h, w) > 0.5).astype(np.float32),
        "all_ground": (rng.rand(n, h, w) > 0.4).astype(np.float32),
        "ground_depth": (rng.rand(n, h, w) * 15 * (rng.rand(n, h, w) > 0.5)).astype(np.float32),
        "depth_mask": (rng.rand(n, h, w) > 0.6).astype(np.float32),
        "moving_object_mask": (rng.rand(n, h, w) > 0.8).astype(np.float32),
    }


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# --- train-mode BatchNorm ---------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 5, 6, 8), (3, 1, 2, 4)])
def test_batch_norm_train_matches_jax(shape):
    rng = np.random.RandomState(40)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    c = shape[-1]
    params = {"scale": rng.rand(c).astype(np.float32) + 0.5,
              "bias": rng.randn(c).astype(np.float32)}
    state = {"mean": rng.randn(c).astype(np.float32),
             "var": rng.rand(c).astype(np.float32) + 0.1}
    ref, ref_state = jl.batch_norm(jnp.asarray(x), params, state, train=True)
    mean, var = torch.from_numpy(state["mean"].copy()), torch.from_numpy(state["var"].copy())
    got = tl.batch_norm(nchw(x), torch.from_numpy(params["scale"]),
                        torch.from_numpy(params["bias"]), mean, var, training=True)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(ref_state["mean"]), atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(ref_state["var"]), atol=1e-5)


def test_encoder_bn_follows_train_and_eval():
    _, _, _, net = jax_model(18, seed=1)
    x = torch.rand(2, 64, 64, 3)
    running = net.encoder.layer0[1].running_mean.clone()
    with torch.no_grad():
        net.eval()(x)
        assert torch.equal(net.encoder.layer0[1].running_mean, running)
        net.train()(x)
        assert not torch.equal(net.encoder.layer0[1].running_mean, running)
    # the decoders' BN modules stay unused and frozen
    bn = net.mask_decoder.block1.pre_concat_conv.bn1
    assert not bn.weight.requires_grad
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))


# --- the loss ---------------------------------------------------------------

def test_compute_losses_matches_jax():
    n, h, w = 2, 16, 24
    rng = np.random.RandomState(41)
    preds = {}
    for k in SCALES:
        p = rng.randn(n, h, w, 4).astype(np.float32) * 3
        p[..., 2:] = 1 / (1 + np.exp(-p[..., 2:]))
        preds[k] = p
    targets = _targets(n, h, w, 42)
    config = tlosses.LossConfig(min_depth=0.1, max_depth=80.0, footprint_prior_weight=0.3)
    ref = jlosses.compute_losses({k: jnp.asarray(v) for k, v in preds.items()},
                                 {k: jnp.asarray(v) for k, v in targets.items()},
                                 jlosses.LossConfig(0.1, 80.0, 0.3))
    got = tlosses.compute_losses({k: torch.from_numpy(v) for k, v in preds.items()},
                                 _torch_batch(targets), config)
    assert sorted(got) == sorted(ref) and len(got) == 4 * 5 + 1
    for k in ref:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), atol=1e-6, rtol=1e-6,
                                   err_msg=k)


# --- Adam + StepLR ----------------------------------------------------------

def test_adam_step_lr_matches_optax_across_a_boundary():
    """3 updates, the schedule boundary after 2 (1 epoch x 2 steps), on
    identical gradients: the port's Adam equals optax.flatten(optax.adam)."""
    rng = np.random.RandomState(43)
    shapes = [(4, 3, 3, 3), (7,), (2, 5)]
    init = [(rng.randn(*s) * 1e-3).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) * 10.0 ** rng.randint(-4, 1)
              for s in shapes] for _ in range(3)]
    config = tstep.TrainStepConfig(learning_rate=1e-4, scheduler_step_epochs=1,
                                   steps_per_epoch=2)
    jconfig = jstep.TrainStepConfig(learning_rate=1e-4, scheduler_step_epochs=1,
                                    steps_per_epoch=2)

    params = torch.nn.ParameterList([torch.nn.Parameter(torch.from_numpy(a.copy()))
                                     for a in init])
    opt = tstep.make_optimizer(params, config)
    schedule = tstep.make_lr_schedule(config)
    optimizer = jstep.make_optimizer(jconfig)
    jparams = [jnp.asarray(a) for a in init]
    jopt = optimizer.init(jparams)
    lrs = []
    for step, g in enumerate(grads):
        lrs.append(schedule(step))
        for group in opt.param_groups:
            group["lr"] = lrs[-1]
        for p, gi in zip(params, g):
            p.grad = torch.from_numpy(gi)
        opt.step()
        updates, jopt = optimizer.update([jnp.asarray(gi) for gi in g], jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, jp in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0,
                                       atol=1e-8)
    np.testing.assert_allclose(lrs, [1e-4, 1e-4, 1e-5], rtol=1e-12)
    assert [float(jstep.make_lr_schedule(jconfig)(s)) for s in range(3)] == \
        pytest.approx(lrs, rel=1e-6)


@pytest.mark.parametrize("dtype,exc", [("float16", ValueError)])
def test_compute_dtype_other_than_f32_raises(dtype, exc):
    """Only float32 and bfloat16 (mixed precision) are compute dtypes."""
    with pytest.raises(exc):
        tstep.TrainStepConfig(compute_dtype=dtype)
    assert tstep.TrainStepConfig(compute_dtype="float32").compute_dtype == "float32"


# --- one whole step ---------------------------------------------------------

H, W, N = 64, 96, 2


@pytest.fixture(scope="module")
def one_step():
    """One JAX train step (one compile) and one port step from the same
    weights and batch.  Returns (jax train state, jax metrics, port
    ModelManager, port metrics, port grads by name)."""
    jnet, params, state, _ = jax_model(18, seed=3)
    # host copies: the jitted step donates (deletes) the arrays it is given
    params, state = jax.tree.map(np.array, (params, state))
    rng = np.random.RandomState(44)
    batch = {"image": rng.rand(N, H, W, 3).astype(np.float32), **_targets(N, H, W, 45)}
    jconfig = jstep.TrainStepConfig(steps_per_epoch=5)
    ts = {"params": params, "state": state,
          "opt_state": jstep.make_optimizer(jconfig).init(params),
          "step": jnp.zeros((), jnp.int32)}
    new_ts, jmetrics = jstep.build_train_step(jnet, jconfig)(
        ts, {k: jnp.asarray(v) for k, v in batch.items()})
    new_ts = jax.tree.map(np.asarray, new_ts)

    mm = ModelManager(depth=18, steps_per_epoch=5, device="cpu")
    mm.set_train_state({"params": params, "state": state, "opt_state": None,
                        "step": 0})
    step_fn = tstep.build_train_step(mm.net, mm.optimizer, mm.config)
    metrics = step_fn(mm.step, _torch_batch(batch))
    mm.step += 1
    grads = {n: p.grad.clone() for n, p in mm.net.named_parameters()
             if p.grad is not None}
    return new_ts, jmetrics, mm, metrics, grads


def _worst_leaf(got, ref):
    """Largest ||got - ref|| / ||ref|| over matching leaves of two pytrees."""
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(flat_got) == len(flat_ref)
    worst = (0.0, None)
    for path, g in flat_got:
        r = np.asarray(flat_ref[path])
        rel = np.linalg.norm(np.asarray(g) - r) / max(np.linalg.norm(r), 1e-12)
        worst = max(worst, (rel, jax.tree_util.keystr(path)))
    return worst


def test_one_step_losses_match_jax(one_step):
    _, jmetrics, _, metrics, _ = one_step
    assert sorted(metrics) == sorted(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), atol=1e-5, rtol=1e-5,
                                   err_msg=k)


def test_one_step_gradients_match_jax(one_step):
    """JAX's gradient is its first Adam moment over (1 - b1); the port's is
    .grad, mapped into the JAX pytree by the weight bridge."""
    new_ts, _, mm, _, grads = one_step
    (count, mu, _), _ = new_ts["opt_state"]
    assert int(count) == 1
    template = jax_params_from_state_dict(mm.net.state_dict(), 18)[0]
    ref = unravel_params(np.asarray(mu) / 0.1, template)
    sd = {k: np.zeros(tuple(v.shape), np.float32) for k, v in mm.net.state_dict().items()}
    sd.update({k: v.numpy() for k, v in grads.items()})
    got = jax_params_from_state_dict(sd, 18)[0]
    worst, path = _worst_leaf(got, ref)
    print(f"worst gradient leaf {path}: {worst:.2e}")
    assert worst < 2e-2, (path, worst)
    # every pytree leaf got a gradient, and nothing else did
    assert len(grads) == len(jax.tree.leaves(template))


def test_one_step_bn_state_and_counters_match_jax(one_step):
    new_ts, jmetrics, mm, metrics, _ = one_step
    ts = mm.train_state()
    for a, b in zip(jax.tree.leaves(ts["state"]), jax.tree.leaves(new_ts["state"])):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert jax.tree.structure(ts["state"]) == jax.tree.structure(new_ts["state"])
    assert int(ts["step"]) == int(new_ts["step"]) == 1
    assert int(ts["opt_state"][0][0]) == int(new_ts["opt_state"][0][0]) == 1
    assert metrics["lr"] == pytest.approx(float(jmetrics["lr"]), rel=1e-6)
    (_, mu, nu), _ = ts["opt_state"]
    (_, jmu, jnu), _ = new_ts["opt_state"]
    assert mu.shape == jmu.shape == nu.shape == jnu.shape
