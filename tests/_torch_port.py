"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py):
layout conversion, a JAX FootprintNetwork mirrored into the port, and the
triplet indices the JAX RANSAC draws."""

import numpy as np
import torch

import jax

from footprints_tpu.models import FootprintNetwork as JaxFootprintNetwork
from footprints_tpu_torch.convert import state_dict_from_jax_params
from footprints_tpu_torch.models import FootprintNetwork


def nchw(a):
    """NHWC numpy -> NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    """NCHW torch tensor -> NHWC numpy."""
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _randomise_bn(tree, rng):
    """Give every BN non-trivial scale/bias/mean/var so the mapping shows."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias"}:
            c = np.asarray(tree["scale"]).shape[0]
            return {"scale": rng.rand(c).astype(np.float32) + 0.5,
                    "bias": rng.randn(c).astype(np.float32) * 0.1}
        if set(tree) == {"mean", "var"}:
            c = np.asarray(tree["mean"]).shape[0]
            return {"mean": rng.randn(c).astype(np.float32) * 0.1,
                    "var": rng.rand(c).astype(np.float32) + 0.5}
        return {k: _randomise_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomise_bn(v, rng) for v in tree]
    return tree


def jax_model(depth, seed=0):
    """JAX FootprintNetwork params/state with non-trivial BN, and the port's
    network carrying the same weights through the bridge."""
    jnet = JaxFootprintNetwork(depth)
    params, state = jnet.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    params, state = _randomise_bn(params, rng), _randomise_bn(state, rng)
    net = FootprintNetwork(depth).eval()
    net.load_state_dict(state_dict_from_jax_params(params, state, depth),
                        strict=True)
    return jnet, params, state, net


def jax_triplets(key, mask, n_iters=100):
    """The [n_iters, 3] point indices that the JAX fit_plane_masked draws
    from ``key`` over the points where ``mask`` is set, recomputed with its
    Gumbel formula (footprints_tpu/preprocessing/ground_truth_generation/
    ransac.py:50-53), to be fed to the port's RANSAC."""
    gumbel = np.asarray(jax.random.gumbel(key, (n_iters, 3, mask.shape[0])))
    logits = np.where(np.asarray(mask) > 0, 0.0, -np.inf)
    return np.argmax(logits[None, None, :] + gumbel, axis=-1)
