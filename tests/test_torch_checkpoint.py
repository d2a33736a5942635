"""Checkpoints cross between the packages: a port-written
``checkpoint.npz`` resumes in the JAX package (params, BN state, optax Adam
state and step, bit for bit), and a JAX checkpoint resumes in the port with
its Adam moments, so the port's next step matches the JAX package's.

Bars of the second step: losses and BN running stats 1e-5; Adam moments
and the parameter update per leaf at ||d||/||ref|| < 2e-2 (the gradient
bar of tests/test_grad_parity.py)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from footprints_tpu.convert import footprint_params_from_state_dict
from footprints_tpu.model_manager import ModelManager as JaxModelManager
from footprints_tpu.train import step as jstep
from footprints_tpu_torch.checkpoint import load_checkpoint
from footprints_tpu_torch.convert import jax_params_from_state_dict
from footprints_tpu_torch.model_manager import ModelManager
from footprints_tpu_torch.train import step as tstep

from ._torch_port import jax_model

H, W, N, DEPTH = 64, 96, 2, 18


def _batch(seed):
    rng = np.random.RandomState(seed)
    shape = (N, H, W)
    return {
        "image": rng.rand(N, H, W, 3).astype(np.float32),
        "depth": (rng.rand(*shape) * 20 * (rng.rand(*shape) > 0.3)).astype(np.float32),
        "visible_ground": (rng.rand(*shape) > 0.5).astype(np.float32),
        "all_ground": (rng.rand(*shape) > 0.4).astype(np.float32),
        "ground_depth": (rng.rand(*shape) * 15).astype(np.float32),
        "depth_mask": (rng.rand(*shape) > 0.6).astype(np.float32),
        "moving_object_mask": (rng.rand(*shape) > 0.8).astype(np.float32),
    }


def _port_step(mm, batch):
    step_fn = tstep.build_train_step(mm.net, mm.optimizer, mm.config)
    metrics = step_fn(mm.step, {k: torch.from_numpy(v) for k, v in batch.items()})
    mm.step += 1
    return metrics


def _sd_of(named, like):
    """{name: tensor} over zeros of every state_dict key -> numpy sd."""
    sd = {k: np.zeros(tuple(v.shape), np.float32) for k, v in like.items()}
    sd.update({k: v.detach().numpy() for k, v in named.items()})
    return sd


def test_port_checkpoint_resumes_in_the_jax_package(tmp_path):
    mm = ModelManager(save_folder=str(tmp_path), depth=DEPTH, seed=5,
                      steps_per_epoch=3, device="cpu")
    _port_step(mm, _batch(50))
    mm.save_model("weights_0")

    jmm = JaxModelManager(depth=DEPTH, steps_per_epoch=3)
    jmm.load_model(os.path.join(tmp_path, "weights_0"), load_optimiser=True)

    sd = {k: v.numpy() for k, v in mm.net.state_dict().items()}
    params, state = footprint_params_from_state_dict(sd, depth=DEPTH)
    for got, ref in ((jmm.params, params), (jmm.state, state)):
        assert jax.tree.structure(got) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, b)
    assert int(jmm.step) == 1

    adam, sched = jmm.opt_state
    assert type(adam).__name__ == "ScaleByAdamState"
    assert int(adam.count) == int(sched.count) == 1
    like = mm.net.state_dict()
    for moment, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
        named = {n: mm.optimizer.state[p][key]
                 for n, p in mm.net.named_parameters() if p.requires_grad}
        ref, _ = ravel_pytree(footprint_params_from_state_dict(
            _sd_of(named, like), depth=DEPTH)[0])
        np.testing.assert_array_equal(np.asarray(moment), np.asarray(ref))

    # the file itself is the JAX flat layout, read back by the port too
    loaded = load_checkpoint(os.path.join(tmp_path, "weights_0", "checkpoint.npz"))
    assert sorted(loaded) == ["opt_state", "params", "state", "step"]


@pytest.fixture(scope="module")
def jax_two_steps(tmp_path_factory):
    """The JAX package trains 2 steps, checkpointing after the first."""
    folder = tmp_path_factory.mktemp("jax_ckpt")
    jnet, params, state, _ = jax_model(DEPTH, seed=6)
    params, state = jax.tree.map(np.array, (params, state))
    jmm = JaxModelManager(save_folder=str(folder), depth=DEPTH, steps_per_epoch=3)
    jmm.params, jmm.state = params, state
    step = jstep.build_train_step(jnet, jmm.config)
    ts = jax.tree.map(np.array, jmm.train_state())
    out = []
    for i, seed in enumerate((51, 52)):
        ts, metrics = step(ts, {k: jnp.asarray(v) for k, v in _batch(seed).items()})
        ts = jax.tree.map(np.array, ts)
        out.append((ts, metrics))
        if i == 0:
            jmm.set_train_state(ts)
            jmm.save_model("weights_0")
    return os.path.join(folder, "weights_0"), out


def test_jax_checkpoint_resumes_in_the_port(jax_two_steps):
    path, [(ts1, _), (ts2, metrics2)] = jax_two_steps
    mm = ModelManager(depth=DEPTH, steps_per_epoch=3, device="cpu")
    mm.load_model(path, load_optimiser=True)
    assert mm.step == 1
    before = jax_params_from_state_dict(mm.net.state_dict(), DEPTH)[0]
    metrics = _port_step(mm, _batch(52))
    got = mm.train_state()

    for k, v in metrics2.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    for a, b in zip(jax.tree.leaves(got["state"]), jax.tree.leaves(ts2["state"])):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert int(got["step"]) == int(ts2["step"]) == 2
    (count, mu, nu), (sched_count,) = got["opt_state"]
    (jcount, jmu, jnu), (jsched,) = ts2["opt_state"]
    assert int(count) == int(jcount) == int(sched_count) == int(jsched) == 2

    def per_leaf(flat_got, flat_ref):
        g = jax.tree.leaves(jax.tree.map(np.asarray, before))
        sizes = np.cumsum([a.size for a in g])[:-1]
        worst = 0.0
        for a, r in zip(np.split(flat_got, sizes), np.split(np.asarray(flat_ref), sizes)):
            worst = max(worst, np.linalg.norm(a - r) / max(np.linalg.norm(r), 1e-12))
        return worst

    assert per_leaf(mu, jmu) < 2e-2
    assert per_leaf(nu, jnu) < 2e-2
    # the second update itself: it depends on the resumed moments and count
    delta = ravel_pytree(got["params"])[0] - ravel_pytree(before)[0]
    jdelta = ravel_pytree(ts2["params"])[0] - ravel_pytree(ts1["params"])[0]
    assert per_leaf(np.asarray(delta), jdelta) < 2e-2
    # the same update without the resumed moments misses that bar
    fresh = ModelManager(depth=DEPTH, steps_per_epoch=3, device="cpu")
    fresh.load_model(path, load_optimiser=False)
    _port_step(fresh, _batch(52))
    fresh_delta = (ravel_pytree(fresh.train_state()["params"])[0]
                   - ravel_pytree(before)[0])
    assert per_leaf(np.asarray(fresh_delta), jdelta) > 2e-2


def test_model_pth_loads_weights_only(tmp_path, capsys):
    net_mm = ModelManager(depth=DEPTH, seed=7, device="cpu")
    torch.save(net_mm.net.state_dict(), tmp_path / "model.pth")
    mm = ModelManager(depth=DEPTH, seed=8, device="cpu")
    mm.load_model(str(tmp_path), load_optimiser=True)
    assert "optimiser state is not imported" in capsys.readouterr().out
    for a, b in zip(mm.net.state_dict().values(), net_mm.net.state_dict().values()):
        assert torch.equal(a, b)
    assert mm.step == 0 and not mm.optimizer.state


def test_pretrained_encoder_is_not_ported():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ModelManager(depth=DEPTH, device="cpu", pretrained_encoder="download")
