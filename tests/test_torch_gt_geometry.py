"""The port's GT geometry (footprints_tpu_torch/preprocessing/
ground_truth_generation/geometry.py) against the JAX package's on the CPU:
the projections at 1e-5, the splat on the same projected points equal to
both JAX splats, the masked median equal to JAX's and to np.ma.median, and
the hidden-depth aggregate on a synthetic ground-plane window (where both
maps are nonzero within 1e-5 relative; at most 1e-3 of the pixels zero in
one and nonzero in the other), plus the JAX tests' identity and translated
cases mirrored."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from footprints_tpu.preprocessing.ground_truth_generation import geometry as jgeo
from footprints_tpu_torch.preprocessing.ground_truth_generation import geometry as geo

H, W = 24, 32


def _camera(h=H, w=W, f=20.0):
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = f
    K[0, 2] = w / 2
    K[1, 2] = h / 2
    return K, np.linalg.pinv(K).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _random_frames(rng, n, h=H, w=W):
    K, invK = _camera(h, w)
    depth = (rng.rand(n, h, w) * 10 + 1).astype(np.float32)
    depth[rng.rand(n, h, w) < 0.2] = 0  # holes
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, 3] = rng.randn(n, 3).astype(np.float32) * 0.3
    angle = rng.randn(n) * 0.05
    poses[:, 0, 0] = poses[:, 2, 2] = np.cos(angle)
    poses[:, 0, 2], poses[:, 2, 0] = np.sin(angle), -np.sin(angle)
    return depth, poses, np.tile(K, (n, 1, 1)), np.tile(invK, (n, 1, 1))


def _plane_window(n=12, h=48, w=160):
    """A KITTI-like window: flat ground 1.5 m below a camera that moves
    0.5 m forward per frame, ground depth only (the rest zero), with two
    box-shaped holes (occluders) per frame; poses relative to frame n//2."""
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 0.58 * w, 1.92 * h, 0.5 * w, 0.5 * h
    invK = np.linalg.pinv(K).astype(np.float32)
    ys = np.arange(h, dtype=np.float64)
    z = np.where(ys > K[1, 2], K[1, 1] * 1.5 / np.maximum(ys - K[1, 2], 1e-3), 0)
    z[z > 40] = 0
    depths = np.tile(z[None, :, None], (n, 1, w)).astype(np.float32)
    rng = np.random.RandomState(5)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        poses[i, 2, 3] = 0.5 * (i - n // 2)
        poses[i, 0, 3] = 0.54 * (i % 2)  # both stereo sides
        for _ in range(2):
            y0, x0 = rng.randint(h // 2, h - 6), rng.randint(0, w - 20)
            depths[i, y0:y0 + 6, x0:x0 + 20] = 0
    return (depths, poses, np.tile(K, (n, 1, 1)), np.tile(invK, (n, 1, 1)))


def test_projections_match_jax():
    depth, poses, K, invK = _random_frames(np.random.RandomState(0), 5)
    jw = np.asarray(jgeo.project_to_world(jnp.asarray(depth), jnp.asarray(invK)))
    pw = geo.project_to_world(_t(depth), _t(invK))
    np.testing.assert_allclose(pw.numpy(), jw, rtol=1e-5, atol=1e-5)
    # both from the same world points
    jc = np.asarray(jgeo.project_to_camera(jnp.asarray(jw), jnp.asarray(poses),
                                           jnp.asarray(K)))
    pc = geo.project_to_camera(_t(jw), _t(poses), _t(K))
    np.testing.assert_allclose(pc.numpy(), jc, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(geo.pixel_grid(H, W).numpy(),
                                  np.asarray(jgeo.pixel_grid(H, W)))


def test_splat_equals_both_jax_splats():
    """Dense random points with many duplicate targets, out-of-bounds
    coordinates, negative depths, invalid flags and points on the strict
    x > 0 / y > 0 borders and the 1e-3 snap."""
    rng = np.random.RandomState(0)
    n, p = 3, 5000
    cam = rng.rand(n, 4, p).astype(np.float32)
    cam[:, 0] = cam[:, 0] * (W + 2) - 1
    cam[:, 1] = cam[:, 1] * (H + 2) - 1
    cam[:, 2] = cam[:, 2] * 30 - 1
    cam[:, 3] = (rng.rand(n, p) > 0.1).astype(np.float32)
    cam[:, 0, :40] = 0.0  # x == 0 is out
    cam[:, 1, 40:80] = 0.0
    cam[:, 0, 80:120] = np.float32(4.9995)  # snaps to pixel 5
    cam[:, 0, 120:160] = np.float32(W - 0.0005)  # snaps past the edge: clipped
    got = geo.extract_depth_from_projections(_t(cam), H, W).numpy()
    for i in range(n):
        a = np.asarray(jgeo._splat_one_scatter(jnp.asarray(cam[i]), H, W))
        b = np.asarray(jgeo._splat_one(jnp.asarray(cam[i]), H, W))
        np.testing.assert_array_equal(got[i], a)
        np.testing.assert_array_equal(got[i], b)


def test_splat_deterministic_min_and_invalid():
    cam = np.zeros((1, 4, 7), np.float32)
    cam[0, :, 0] = [3.2, 2.7, 7.0, 1.0]
    cam[0, :, 1] = [3.4, 2.1, 4.0, 1.0]
    cam[0, :, 2] = [6.5, 5.5, 9.0, 1.0]
    cam[0, :, 3] = [-1.0, 2.0, 5.0, 1.0]   # x out of bounds
    cam[0, :, 4] = [2.0, 2.0, -5.0, 1.0]   # negative depth
    cam[0, :, 5] = [2.0, 2.0, 5.0, 0.0]    # invalid flag
    cam[0, :, 6] = [W + 3, 2.0, 5.0, 1.0]  # x out of bounds high
    out = geo.extract_depth_from_projections(_t(cam), H, W).numpy()
    assert out[0, 2, 3] == 4.0 and out[0, 5, 6] == 9.0 and out.sum() == 13.0


@pytest.mark.parametrize("min_hits", [0, 2])
def test_masked_median_equals_jax_and_numpy(min_hits):
    """On the splats of real projections, and on sparse random hits with
    even and odd counts (the mean of the two middle ranks)."""
    depth, poses, K, invK = _random_frames(np.random.RandomState(1), 7)
    cam = geo.project_to_camera(geo.project_to_world(_t(depth), _t(invK)),
                                _t(poses), _t(K))
    proj = geo.extract_depth_from_projections(cam, H, W).numpy()
    rng = np.random.RandomState(2)
    sparse = rng.rand(8, 5, 6).astype(np.float32) * 10
    sparse[sparse < 4] = 0
    for p in (proj, sparse):
        got = geo.masked_median(_t(p), min_hits=min_hits).numpy()
        ref = np.asarray(jgeo.masked_median(jnp.asarray(p), min_hits=min_hits))
        np.testing.assert_array_equal(got, ref)
        keep = (p > 0).sum(0) > min_hits
        ma = np.ma.median(np.ma.MaskedArray(p * keep, mask=(p * keep) == 0),
                          axis=0).filled(0)
        np.testing.assert_array_equal(got, ma.astype(np.float32))


def test_masked_median_pixel_chunks_are_exact(monkeypatch):
    p = np.random.RandomState(3).rand(9, 7, 11).astype(np.float32)
    p[p < 0.5] = 0
    whole = geo.masked_median(_t(p), min_hits=2).numpy()
    monkeypatch.setattr(geo, "MEDIAN_CHUNK_ELEMENTS", 9 * 5)  # 5 pixels a chunk
    np.testing.assert_array_equal(geo.masked_median(_t(p), min_hits=2).numpy(), whole)


@pytest.mark.parametrize("robust", [True, False])
def test_aggregate_plane_window_matches_jax(robust):
    depths, poses, K, invK = _plane_window()
    h, w = depths.shape[1:]
    got = geo.aggregate_hidden_depth(_t(depths), _t(poses), _t(K), _t(invK),
                                     height=h, width=w, robust=robust).numpy()
    ref = np.asarray(jgeo.aggregate_hidden_depth(
        jnp.asarray(depths), jnp.asarray(poses), jnp.asarray(K), jnp.asarray(invK),
        height=h, width=w, robust=robust))
    assert got.dtype == np.float32 and got.shape == (h, w)
    assert (ref > 0).sum() > 0.2 * h * w
    both = (got > 0) & (ref > 0)
    np.testing.assert_allclose(got[both], ref[both], rtol=1e-5)
    assert ((got > 0) != (ref > 0)).mean() <= 1e-3


def test_aggregate_frame_chunks_are_exact(monkeypatch):
    depths, poses, K, invK = _plane_window()
    args = (_t(depths), _t(poses), _t(K), _t(invK))
    whole = geo.aggregate_hidden_depth(*args, height=48, width=160).numpy()
    monkeypatch.setattr(geo, "FRAME_CHUNK", 5)
    np.testing.assert_array_equal(
        geo.aggregate_hidden_depth(*args, height=48, width=160).numpy(), whole)


def test_aggregate_identity_reproduces_depth():
    """One frame, identity pose: the input depth map comes back (strictly
    interior pixels; border pixels are dropped by the > 0 checks)."""
    K, invK = _camera()
    depth = np.random.RandomState(2).rand(1, H, W).astype(np.float32) * 5 + 2
    out = geo.aggregate_hidden_depth(_t(depth), torch.eye(4)[None], _t(K[None]),
                                     _t(invK[None]), height=H, width=W,
                                     robust=False).numpy()
    np.testing.assert_allclose(out[1:, 1:], depth[0, 1:, 1:], rtol=1e-4)


def test_aggregate_translated_frame():
    """A frame shifted +1 px in x (via the pose) lands its depths one pixel
    over."""
    K, invK = _camera()
    depth = np.full((1, H, W), 10.0, np.float32)
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = 10.0 / K[0, 0]  # fx*dx/Z = 20*(10/20)/10 = 1 px
    out = geo.aggregate_hidden_depth(_t(depth), _t(T[None]), _t(K[None]),
                                     _t(invK[None]), height=H, width=W,
                                     robust=False).numpy()
    assert out[5, 5] == pytest.approx(10.0, rel=1e-5)
    assert out[:, 0].sum() == 0
