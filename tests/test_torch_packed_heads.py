"""The packed training heads of the port (models/footprint.py s2d_head and
p4_head, train/losses.py, data/compact.py) held against the JAX package on
the CPU, and one f32 train step of FootprintNetwork-18 with both heads on.

Tolerances:
  * the packs of the target maps (s2d_map, p4_map, and decompact_on_device's
    '@s2d'/'@s2d2' keys against decompact_batch): equal (np.array_equal);
  * the heads: each packed head unpacks to the port's standard head bit for
    bit (the port packs its standard head); against the JAX package's heads
    from the same weights, MAE < 1e-4 (the forward bar of
    tests/test_parity_full_res.py; JAX computes them in s2d form);
  * the packed loss against the standard loss on the same outputs: each
    term within 1e-6 relative and every parameter's gradient within
    ||d||/||ref|| < 1e-5 (the same pixelwise terms, summed in another
    order); against the JAX packed loss on the same packed outputs, each
    term within 1e-6 + 1e-6|ref| (the bar of test_torch_train_step.py's
    loss test);
  * one f32 step with both heads on, against the JAX step: the bars of
    tests/test_torch_train_step.py (loss terms 1e-5 + 1e-5|ref|, each
    gradient leaf ||d||/||ref|| < 2e-2, BN running stats 1e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from footprints_tpu.data.compact import BatchCompactor as JaxBatchCompactor
from footprints_tpu.data.compact import decompact_batch
from footprints_tpu.train import losses as jlosses
from footprints_tpu.train import step as jstep
from footprints_tpu_torch.convert import jax_params_from_state_dict, unravel_params
from footprints_tpu_torch.data.compact import BatchCompactor, decompact_on_device
from footprints_tpu_torch.model_manager import ModelManager
from footprints_tpu_torch.train import losses as tlosses
from footprints_tpu_torch.train import step as tstep
from footprints_tpu_torch.train.trainer import resolve_head

from ._torch_port import jax_model

H, W, N = 64, 96, 2
PACKED = {"1/1_s2d": "1/1", "1/2_s2d2": "1/2"}


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


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(N, H, W, 3).astype(np.float32), **_targets(N, H, W, seed + 1)}


def _unpack(y, s):
    """Inverse of the packs, written out from their lane contract: lane
    c s^2 + L(ry, rx) of packed pixel (i, j) holds full-res pixel
    (s i + ry, s j + rx) of channel c, where L is the nested phase lane of
    footprints_tpu/ops/s2d.py:_nested_phase_lane (lowest phase bits
    outermost)."""
    n, h, w, lanes = y.shape
    c = lanes // (s * s)
    out = np.zeros((n, s * h, s * w, c), y.dtype)
    bits = s.bit_length() - 1
    for ry in range(s):
        for rx in range(s):
            lane = sum((2 * ((ry >> k) & 1) + ((rx >> k) & 1)) * 4 ** (bits - 1 - k)
                       for k in range(bits))
            for ch in range(c):
                out[:, ry::s, rx::s, ch] = y[..., ch * s * s + lane]
    return out


# --- the packs -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 8, 12), (1, 16, 4)])
def test_s2d_map_and_p4_map_equal_jax(shape):
    t = np.random.RandomState(60).rand(*shape).astype(np.float32)
    for port, ref in ((tlosses.s2d_map, jlosses.s2d_map), (tlosses.p4_map, jlosses.p4_map)):
        got, want = port(torch.from_numpy(t)).numpy(), np.asarray(ref(jnp.asarray(t)))
        assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["exact", "none"])
def test_decompact_packed_keys_equal_jax(mode):
    host = _batch(61)
    compact = BatchCompactor(mode)(host)
    jcompact = JaxBatchCompactor(mode)(host)
    scheme = BatchCompactor(mode)
    scheme(host)
    keys = tlosses.TARGET_KEYS
    got = decompact_on_device({k: torch.from_numpy(v) for k, v in compact.items()},
                              scheme.scheme, keys, keys)
    want = decompact_batch({k: jnp.asarray(v) for k, v in jcompact.items()},
                           scheme.scheme, keys, keys)
    assert sorted(got) == sorted(want) and len(got) == 7 + 2 * len(keys)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    assert got["depth@s2d"].shape == (N, H // 2, W // 2, 4)
    assert got["depth@s2d2"].shape == (N, H // 4, W // 4, 16)


# --- the heads -----------------------------------------------------------------

@pytest.fixture(scope="module")
def heads():
    """The port's standard and packed outputs and the JAX package's packed
    outputs, from one set of weights and one image."""
    jnet, params, state, net = jax_model(18, seed=5)
    x = np.random.RandomState(62).rand(N, H, W, 3).astype(np.float32)
    with torch.no_grad():
        standard = net(torch.from_numpy(x))
        packed = net(torch.from_numpy(x), s2d_head=True, p4_head=True)
    ref, _ = jax.jit(lambda p, s, im: jnet.apply(p, s, im, train=False, s2d_head=True,
                                                 p4_head=True))(params, state, jnp.asarray(x))
    return standard, packed, {k: np.asarray(v) for k, v in ref.items()}


def test_packed_heads_unpack_to_the_standard_heads_bit_for_bit(heads):
    standard, packed, _ = heads
    assert list(packed) == ["1/8", "1/4", "1/2_s2d2", "1/1_s2d"]
    assert packed["1/1_s2d"].shape == (N, H // 2, W // 2, 16)
    assert packed["1/2_s2d2"].shape == (N, H // 4, W // 4, 64)
    for key, s in (("1/1_s2d", 2), ("1/2_s2d2", 4)):
        assert np.array_equal(_unpack(packed[key].numpy(), s), standard[PACKED[key]].numpy())
    for key in ("1/8", "1/4"):
        assert torch.equal(packed[key], standard[key])


def test_packed_heads_match_jax(heads):
    _, packed, ref = heads
    assert sorted(ref) == sorted(packed)  # jit returns dicts with sorted keys
    for k, v in ref.items():
        got = packed[k].numpy()
        assert got.shape == v.shape, k
        mae = np.abs(got - v).mean()
        print(f"{k}: MAE {mae:.2e}")
        assert mae < 1e-4, (k, mae)


# --- the packed loss -----------------------------------------------------------

@pytest.mark.parametrize("packed_targets", [False, True], ids=["inline", "batch_keys"])
def test_packed_loss_matches_the_standard_loss(packed_targets):
    """The same net and batch scored with and without the packed heads:
    the same terms under the same keys, and the same gradients; the packs
    come from the batch's '@' keys or are made in the loss."""
    _, _, _, net = jax_model(18, seed=6)
    net.train()
    b = {k: torch.from_numpy(v) for k, v in _batch(63).items()}
    if packed_targets:
        keys = tlosses.TARGET_KEYS
        b = decompact_on_device(b, None, keys, keys)

    def run(**heads):
        net.zero_grad(set_to_none=True)
        losses = tlosses.compute_losses(net(b["image"], **heads), b)
        losses["loss"].backward()
        return losses, {n: p.grad.clone() for n, p in net.named_parameters()
                        if p.grad is not None}

    want, g_want = run()
    got, g_got = run(s2d_head=True, p4_head=True)
    assert sorted(got) == sorted(want) and len(got) == 21
    for k, v in want.items():
        np.testing.assert_allclose(got[k].item(), v.item(), rtol=1e-6, atol=0, err_msg=k)
    assert g_got.keys() == g_want.keys()
    for k, v in g_want.items():
        rel = float((g_got[k] - v).norm() / v.norm().clamp_min(1e-30))
        assert rel < 1e-5, (k, rel)


def test_packed_loss_matches_jax_on_packed_outputs():
    rng = np.random.RandomState(64)
    preds = {"1/8": rng.randn(N, H, W, 4), "1/4": rng.randn(N, H, W, 4),
             "1/2_s2d2": rng.randn(N, H // 4, W // 4, 64),
             "1/1_s2d": rng.randn(N, H // 2, W // 2, 16)}
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    targets = _targets(N, H, W, 65)
    got = tlosses.compute_losses({k: torch.from_numpy(v) for k, v in preds.items()},
                                 {k: torch.from_numpy(v) for k, v in targets.items()})
    ref = jlosses.compute_losses({k: jnp.asarray(v) for k, v in preds.items()},
                                 {k: jnp.asarray(v) for k, v in targets.items()})
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].item(), float(v), rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("flag,dtype,on", [
    ("auto", "float32", False), ("auto", "bfloat16", True), ("on", "float32", True),
    ("off", "bfloat16", False), ("on", "bfloat16", True), ("off", "float32", False)])
def test_head_flags_resolve_as_the_jax_trainer(flag, dtype, on):
    """footprints_tpu/train/trainer.py: on, or auto with bfloat16."""
    assert resolve_head(flag, dtype) is on
    assert (flag == "on" or (flag == "auto" and dtype in ("bfloat16", "bf16"))) is on


# --- one f32 step with both heads -------------------------------------------------

@pytest.fixture(scope="module")
def f32_step():
    """One JAX train step and one port step with both heads on, from the
    same weights and batch."""
    jnet, params, state, _ = jax_model(18, seed=3)
    params, state = jax.tree.map(np.array, (params, state))
    batch = _batch(66)
    jconfig = jstep.TrainStepConfig(steps_per_epoch=5, s2d_head=True, p4_head=True)
    ts = {"params": params, "state": state,
          "opt_state": jstep.make_optimizer(jconfig).init(params),
          "step": jnp.zeros((), jnp.int32)}
    new_ts, jmetrics = jstep.build_train_step(jnet, jconfig)(
        ts, {k: jnp.asarray(v) for k, v in batch.items()})
    new_ts = jax.tree.map(np.asarray, new_ts)

    mm = ModelManager(depth=18, steps_per_epoch=5, device="cpu")
    mm.set_train_state({"params": params, "state": state, "opt_state": None, "step": 0})
    config = tstep.TrainStepConfig(steps_per_epoch=5, s2d_head=True, p4_head=True)
    metrics = tstep.build_train_step(mm.net, mm.optimizer, config)(
        0, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = {n: p.grad.clone() for n, p in mm.net.named_parameters() if p.grad is not None}
    return new_ts, jmetrics, mm, metrics, grads


def test_f32_step_with_packed_heads_matches_jax(f32_step):
    new_ts, jmetrics, mm, metrics, grads = f32_step
    assert sorted(metrics) == sorted(jmetrics) and len(metrics) == 22
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    # the port's gradient against JAX's, its first Adam moment over (1 - b1)
    (count, mu, _), _ = new_ts["opt_state"]
    template = jax_params_from_state_dict(mm.net.state_dict(), 18)[0]
    ref = unravel_params(np.asarray(mu) / 0.1, template)
    sd = {k: np.zeros(tuple(v.shape), np.float32) for k, v in mm.net.state_dict().items()}
    sd.update({k: v.numpy() for k, v in grads.items()})
    got = jax_params_from_state_dict(sd, 18)[0]
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    worst = max((np.linalg.norm(np.asarray(g) - flat_ref[p])
                 / max(np.linalg.norm(flat_ref[p]), 1e-12), jax.tree_util.keystr(p))
                for p, g in jax.tree_util.tree_flatten_with_path(got)[0])
    print(f"worst gradient leaf {worst[1]}: {worst[0]:.2e}")
    assert worst[0] < 2e-2, worst
    assert int(count) == 1 and len(grads) == len(jax.tree.leaves(template))


def test_f32_step_with_packed_heads_bn_state_matches_jax(f32_step):
    new_ts, _, mm, _, _ = f32_step
    got = mm.train_state()["state"]
    assert jax.tree.structure(got) == jax.tree.structure(new_ts["state"])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(new_ts["state"])):
        np.testing.assert_allclose(a, b, atol=1e-5)
