"""The port's RANSAC, depth mask and moving-object mask (footprints_tpu_torch/
preprocessing/ground_truth_generation/{ransac,processing}.py) against the
JAX package's on the CPU.

The JAX RANSAC draws its triplets with ``jax.random.gumbel``; the tests
recompute those indices with the Gumbel formula of its ``fit_plane_masked``
(``_torch_port.jax_triplets``) and feed them to the port, so everything
after the draw is compared: the same winning hypothesis, coefficients
within 1e-6 + 1e-5|ref|, inlier masks differing at at most 1e-4 of the
points, and depth masks at at most 1e-3 of the pixels.  ``np_fit_plane`` is equal to JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from footprints_tpu.preprocessing.ground_truth_generation import processing as jproc
from footprints_tpu.preprocessing.ground_truth_generation import ransac as jransac
from footprints_tpu_torch.preprocessing.ground_truth_generation import processing as proc
from footprints_tpu_torch.preprocessing.ground_truth_generation import ransac

from ._torch_port import jax_triplets

H, W = 48, 160


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _plane_cloud(seed):
    rng = np.random.RandomState(seed)
    n = 800
    pts = np.stack([rng.rand(n) * 10, 1.5 + rng.randn(n) * 0.01,
                    rng.rand(n) * 10], 1)
    outliers = rng.rand(200, 3) * 10
    data = np.concatenate([pts, outliers]).astype(np.float32)
    mask = rng.rand(len(data)) > 0.1
    return data, mask


def _camera(h=H, w=W):
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 0.58 * w, 1.92 * h, 0.5 * w, 0.5 * h
    return K, np.linalg.pinv(K).astype(np.float32)


def _ground_scene(h=H, w=W, seed=0):
    """Flat ground 1.5 m down, boxes standing on it (non-ground, the depth
    of their front face), a far wall, and a few depth holes."""
    K, invK = _camera(h, w)
    ys = np.arange(h, dtype=np.float64)
    z = np.where(ys > K[1, 2], K[1, 1] * 1.5 / np.maximum(ys - K[1, 2], 1e-3), np.inf)
    depth = np.tile(np.minimum(z, 25.0)[:, None], (1, w))
    ground = np.tile((z < 25.0)[:, None], (1, w)).astype(np.float32)
    rng = np.random.RandomState(seed)
    for _ in range(4):
        zb = rng.uniform(6, 15)
        yb = int(K[1, 2] + K[1, 1] * 1.5 / zb)  # the box's base row
        x0 = rng.randint(0, w - 30)
        top = max(0, yb - int(K[1, 1] * 1.0 / zb))
        depth[top:yb + 1, x0:x0 + 25] = np.minimum(depth[top:yb + 1, x0:x0 + 25], zb)
        ground[top:yb + 1, x0:x0 + 25] = 0
    depth[rng.rand(h, w) < 0.02] = 0
    return depth.astype(np.float32), ground, K, invK


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_plane_with_jax_triplets(seed):
    data, mask = _plane_cloud(seed)
    key = jax.random.PRNGKey(seed)
    jc, jcount, jinl = jransac.fit_plane_masked(key, jnp.asarray(data), jnp.asarray(mask))
    idx = jax_triplets(key, mask)
    pc, pcount, pinl = ransac.fit_plane_masked(_t(data), torch.from_numpy(mask),
                                               idx=torch.from_numpy(idx))
    jc, pc = np.asarray(jc), pc.numpy()
    # the same winner: the hypothesis nearest to each result is one and the same
    t = data[idx].astype(np.float64)
    n = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
    hyps = np.concatenate([n, -np.einsum("ic,ic->i", n, t[:, 0])[:, None]], 1)
    assert (np.abs(hyps - jc).sum(1).argmin() == np.abs(hyps - pc).sum(1).argmin())
    np.testing.assert_allclose(pc, jc, rtol=1e-5, atol=1e-6)
    assert abs(int(pcount) - int(jcount)) <= 1e-4 * len(data)
    assert (pinl.numpy() != np.asarray(jinl)).mean() <= 1e-4
    normal = pc[:3] / np.linalg.norm(pc[:3])
    assert abs(abs(normal[1]) - 1) < 0.05 and int(pcount) > 600
    np.testing.assert_allclose(
        ransac.plane_distance(_t(pc), _t(data[:50])).numpy(),
        np.asarray(jransac.plane_distance(jnp.asarray(pc), jnp.asarray(data[:50]))),
        rtol=1e-5, atol=1e-6)


def test_fit_plane_drawn_from_the_generator():
    """Without indices: a seeded generator, the same plane found, only valid
    points drawn, and the same draw for the same seed."""
    data, mask = _plane_cloud(2)
    valid = torch.from_numpy(mask)
    idx = ransac.draw_triplets(valid, 100, torch.Generator().manual_seed(10))
    assert idx.shape == (100, 3) and mask[idx.numpy()].all()
    again = ransac.draw_triplets(valid, 100, torch.Generator().manual_seed(10))
    assert torch.equal(idx, again)
    coeffs, count, _ = ransac.fit_plane_masked(
        _t(data), valid, generator=torch.Generator().manual_seed(10))
    normal = coeffs[:3].numpy() / np.linalg.norm(coeffs[:3].numpy())
    assert abs(abs(normal[1]) - 1) < 0.05 and int(count) > 600


def test_degenerate_hypotheses_never_win():
    """Triplets of one point three times have a zero normal and score 0;
    of two tied hypotheses (the same plane, its normal flipped) the first
    wins, as with jnp.argmax."""
    data, mask = _plane_cloud(3)
    idx = np.zeros((100, 3), np.int64)
    idx[50] = [0, 1, 2]
    idx[60] = [1, 0, 2]
    coeffs, count, _ = ransac.fit_plane_masked(_t(data), torch.from_numpy(mask),
                                               idx=torch.from_numpy(idx))
    t = data[[0, 1, 2]]
    n = np.cross(t[1] - t[0], t[2] - t[0])
    np.testing.assert_allclose(coeffs[:3].numpy(), n, rtol=1e-5, atol=1e-6)
    assert int(count) > 0


@pytest.mark.parametrize("seed", [0, 3])
def test_np_fit_plane_equals_jax(seed):
    data, _ = _plane_cloud(seed)
    got = ransac.np_fit_plane(data.astype(np.float64))
    ref = jransac.np_fit_plane(data.astype(np.float64))
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1]
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(ransac.np_plane_distance(got[0], data),
                                  jransac.np_plane_distance(ref[0], data))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_depth_mask_with_jax_triplets(seed):
    depth, ground, K, invK = _ground_scene(seed=seed)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jproc.compute_depth_mask(
        key, jnp.asarray(depth), jnp.asarray(ground), jnp.asarray(K),
        jnp.asarray(invK), height=H, width=W))
    fit_mask = (ground.reshape(-1) > 0.75) & (depth.reshape(-1) > 0)
    idx = torch.from_numpy(jax_triplets(key, fit_mask))
    got = proc.compute_depth_mask(_t(depth), _t(ground), _t(K), _t(invK),
                                  height=H, width=W, idx=idx).numpy()
    assert got.dtype == np.bool_ and got.shape == (H, W)
    assert ref.sum() > 20  # the boxes' bases are flagged
    assert (got != ref).mean() <= 1e-3
    assert not (got & (ground > 0.5)).any()


def test_depth_mask_degenerate_plane_is_empty():
    """All ground pixels in depth holes: the under-determined plane gives
    the all-False mask; the triplets are drawn from the generator (no valid
    point to draw from)."""
    K, invK = _camera(24, 32)
    depth = np.full((24, 32), 8.0, np.float32)
    ground = np.zeros((24, 32), np.float32)
    ground[12:] = 1.0
    depth[12:] = 0.0
    got = proc.compute_depth_mask(_t(depth), _t(ground), _t(K), _t(invK),
                                  height=24, width=32,
                                  generator=torch.Generator().manual_seed(10))
    assert got.dtype == torch.bool and not got.any()


def test_moving_object_mask_matches_jax():
    """A moving camera, a blob of unexplained flow, and depth holes."""
    depth, _, K, invK = _ground_scene(seed=4)
    rng = np.random.RandomState(4)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.1, 0.0, -0.5]
    flow = (rng.randn(2, H, W) * 0.5).astype(np.float32)
    flow[0, 30:40, 50:70] += 6.0
    ref = np.asarray(jproc.compute_moving_object_mask(
        jnp.asarray(depth), jnp.asarray(T), jnp.asarray(K), jnp.asarray(invK),
        jnp.asarray(flow), height=H, width=W))
    got = proc.compute_moving_object_mask(_t(depth), _t(T), _t(K), _t(invK),
                                          _t(flow), height=H, width=W).numpy()
    assert got.dtype == np.bool_ and ref.sum() > 50
    assert (got != ref).mean() <= 1e-3
    assert not got[depth == 0].any()
