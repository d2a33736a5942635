"""The port's Segmentor against the JAX package's on the same weights (the
segmentor weight bridge), all 4 logit maps at MAE < 1e-4; the bridge's
round trip against footprints_tpu.convert.segmentor_params_from_state_dict;
and a strict load of the reference layout (tests/torch_oracle.Segmentor).

The JAX weights are the port's seeded init carried across in the JAX layout
(the pytree of ``Segmentor.init``, checked by shape): JAX's own init runs
eagerly and would cost most of this file's time."""

import functools

import jax
import numpy as np
import pytest
import torch

from footprints_tpu.convert import segmentor_params_from_state_dict
from footprints_tpu.models import Segmentor as JaxSegmentor
from footprints_tpu_torch.convert import (segmentor_jax_params_from_state_dict,
                                          segmentor_state_dict_from_jax_params)
from footprints_tpu_torch.models import Segmentor
from footprints_tpu_torch.ops import fused_conv as fc

from . import torch_oracle
from ._torch_port import _randomise_bn


def _mirrored(depth, use_psp, seed=0):
    """JAX Segmentor params/state (numpy, non-trivial BN), and the port's
    Segmentor carrying them through the bridge."""
    jnet = JaxSegmentor(depth, use_psp)
    seeded = Segmentor(depth, use_psp, generator=torch.Generator().manual_seed(seed))
    params, state = segmentor_jax_params_from_state_dict(seeded.state_dict(), depth,
                                                         use_psp)
    rng = np.random.RandomState(seed)
    params, state = _randomise_bn(params, rng), _randomise_bn(state, rng)
    net = Segmentor(depth, use_psp).eval()
    net.load_state_dict(segmentor_state_dict_from_jax_params(params, state, depth, use_psp),
                        strict=True)
    return jnet, params, state, net


def _check_forward(depth, use_psp, hw, batch=2):
    jnet, params, state, net = _mirrored(depth, use_psp)
    x = np.random.RandomState(1).rand(batch, *hw, 3).astype(np.float32)
    ref, _ = jax.jit(functools.partial(jnet.apply, train=False))(params, state, x)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert len(got) == len(ref) == 4
    for k, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape == (batch, hw[0] // 2 ** (3 - k),
                                             hw[1] // 2 ** (3 - k), 1)
        assert np.abs(g.numpy() - r).mean() < 1e-4, k


@pytest.mark.parametrize("use_psp", [True, False])
@pytest.mark.parametrize("depth", [18, 34, 50])
def test_segmentor_matches_jax(depth, use_psp):
    _check_forward(depth, use_psp, (64, 96))


def test_segmentor_matches_jax_at_192x640():
    _check_forward(34, True, (192, 640), batch=1)


def test_scales_pick_the_heads():
    _, _, _, net = _mirrored(18, True)
    x = torch.rand(1, 64, 96, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        full = net(x)
        (only,) = net(x, scales=("1/1",))
    torch.testing.assert_close(only, full[3], rtol=0, atol=0)


@pytest.mark.parametrize("use_psp", [True, False])
def test_bridge_layout_is_the_jax_init_pytree(use_psp):
    jnet = JaxSegmentor(50, use_psp)
    want = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
    got = segmentor_jax_params_from_state_dict(Segmentor(50, use_psp).state_dict(),
                                               50, use_psp)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert [np.shape(a) for a in jax.tree.leaves(got)] == \
        [a.shape for a in jax.tree.leaves(want)]


@pytest.mark.parametrize("use_psp", [True, False])
def test_bridge_round_trips_against_jax_converter(use_psp):
    _, params, state, net = _mirrored(18, use_psp)
    sd = net.state_dict()
    mine = segmentor_jax_params_from_state_dict(sd, 18, use_psp)
    ref = segmentor_params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, depth=18, use_psp=use_psp)
    for got, want in ((mine, ref), (mine, (params, state))):
        a, b = jax.tree.leaves(got), jax.tree.leaves(want)
        assert jax.tree.structure(got) == jax.tree.structure(
            jax.tree.map(np.asarray, want))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    back = segmentor_state_dict_from_jax_params(*mine, 18, use_psp)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_reference_layout_loads_strictly_and_matches():
    torch.manual_seed(0)
    oracle = torch_oracle.Segmentor(use_psp=True).eval()
    net = Segmentor(34, True).eval()
    net.load_state_dict(oracle.state_dict(), strict=True)
    x = torch.rand(1, 64, 96, 3, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = net(x)
        ref = oracle(x.permute(0, 3, 1, 2))
    for g, r in zip(got, ref):
        assert (g.permute(0, 3, 1, 2) - r).abs().mean() < 1e-4


def test_cpu_forward_launches_no_kernel():
    before = fc.fused_conv3x3.launches
    with torch.no_grad():
        Segmentor(18, True)(torch.rand(1, 64, 96, 3))
    assert fc.fused_conv3x3.launches == before
