"""The port's GT-generation host loaders (footprints_tpu_torch/preprocessing/
ground_truth_generation/data_loader.py) against the JAX package's on the
same synthetic trees: every array np.array_equal, and the window, buffer,
purge, rescaling and scan-cache behaviour of tests/test_gt_data_loader.py
mirrored."""

import os

import numpy as np
import pytest
from PIL import Image

from footprints_tpu.preprocessing.ground_truth_generation import data_loader as jdl
from footprints_tpu_torch.preprocessing.ground_truth_generation import data_loader as dl

H, W = 8, 12
SEQ = "seq0"
RAW_HW = (6, 20)  # raw shapes differ from the loader's target (H, W)


def _write_kitti_frame(td, frame, rng, sides=("image_02", "image_03"),
                       disp_value=None, with_flow=False):
    """Random disparities (some <= 0), ground_seg and flow; a distinct pose."""
    f = str(frame).zfill(10)
    for side in sides:
        d = os.path.join(td, "stereo_matching_disps", SEQ, side)
        os.makedirs(d, exist_ok=True)
        disp = (rng.rand(*RAW_HW) * 10 - 1).astype(np.float32)
        if disp_value is not None:
            disp[:] = disp_value
        np.save(os.path.join(d, f + ".npy"), disp)
        g = os.path.join(td, "ground_seg", SEQ, side, "data")
        os.makedirs(g, exist_ok=True)
        np.save(os.path.join(g, f + ".npy"),
                rng.rand(1, *RAW_HW).astype(np.float16))
        if with_flow:
            fl = os.path.join(td, "optical_flow", SEQ, side, "data")
            os.makedirs(fl, exist_ok=True)
            np.save(os.path.join(fl, f + ".npy"),
                    rng.randn(2, *RAW_HW).astype(np.float32))
    p = os.path.join(td, "poses", SEQ, "orbslam_poses")
    os.makedirs(p, exist_ok=True)
    pose = np.eye(4)[:3] + rng.randn(3, 4) * 0.01
    pose[0, 3] = frame  # distinguishable translation
    np.save(os.path.join(p, f + ".npy"), pose.astype(np.float32))


@pytest.fixture
def kitti_tree(tmp_path):
    td = str(tmp_path / "training_data")
    rng = np.random.RandomState(0)
    for frame in (0, 2, 4, 5):
        _write_kitti_frame(td, frame, rng, with_flow=True)
    return td


def _loaders(td, **kwargs):
    return (dl.KITTILoader("", td, H, W, **kwargs),
            jdl.KITTILoader("", td, H, W, **kwargs))


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("frame", [2, 4, 5])
def test_kitti_window_equals_jax(kitti_tree, frame):
    port, ref = _loaders(kitti_tree, num_frames_bwd=2, num_frames_fwd=4)
    _equal(port.load_data(SEQ, frame), ref.load_data(SEQ, frame))
    assert port.max_window_frames == ref.max_window_frames == 6
    np.testing.assert_array_equal(port.K, ref.K)
    np.testing.assert_array_equal(port.invK, ref.invK)


def test_kitti_window_skips_missing_frames(kitti_tree):
    port, _ = _loaders(kitti_tree, num_frames_bwd=2, num_frames_fwd=4)
    data = port.load_data(SEQ, 2)  # frames {0, 2, 4} x both sides
    assert data["depths"].shape == (6, H, W)
    assert data["sides"] == ["image_02", "image_03"] * 3
    port.purge_buffer()
    data = port.load_data(SEQ, 4)  # frames {2, 4}; 6 is missing
    assert data["depths"].shape == (4, H, W)
    assert data["poses"][0, 0, 3] == 2


@pytest.mark.parametrize("flags", [dict(load_flow=True, use_buffer=False),
                                   dict(use_buffer=False, threshold_ground=False),
                                   dict()])
def test_kitti_frame_data_equals_jax(kitti_tree, flags):
    port, ref = _loaders(kitti_tree)
    for side in ("image_02", "image_03"):
        _equal(port.load_frame_data(SEQ, 5, side, **flags),
               ref.load_frame_data(SEQ, 5, side, **flags))
    assert port.load_frame_data(SEQ, 7, "image_02", **flags) is None


def test_kitti_disparity_rescale_and_depth(tmp_path):
    td = str(tmp_path / "training_data")
    rng = np.random.RandomState(1)
    for frame in (0, 2, 4):
        _write_kitti_frame(td, frame, rng, disp_value=5.0)
    port, _ = _loaders(td, num_frames_bwd=2, num_frames_fwd=4)
    data = port.load_data(SEQ, 2)
    disp = 5.0 * (W / 20.0)
    np.testing.assert_allclose(data["depths"], (0.58 * W) * 0.54 / disp, rtol=1e-5)
    assert data["intrinsics"].shape == (6, 4, 4)


def test_kitti_nonpositive_disparity_gives_zero_depth(tmp_path):
    td = str(tmp_path / "training_data")
    _write_kitti_frame(td, 0, np.random.RandomState(2), disp_value=0.0)
    port, _ = _loaders(td, num_frames_bwd=0, num_frames_fwd=2)
    assert (port.load_data(SEQ, 0)["depths"] == 0.0).all()


def test_kitti_buffer_caches_until_purged(kitti_tree):
    port, _ = _loaders(kitti_tree)
    first = port.load_frame_data(SEQ, 2, "image_02")
    _write_kitti_frame(kitti_tree, 2, np.random.RandomState(3), disp_value=50.0)
    cached = port.load_frame_data(SEQ, 2, "image_02")
    np.testing.assert_array_equal(cached["disparity"], first["disparity"])
    port.purge_buffer()
    fresh = port.load_frame_data(SEQ, 2, "image_02")
    assert fresh["disparity"].min() > first["disparity"].max()


def _write_matterport_frame(raw, td, scan, pos, h, d, rng, fx=1000.0):
    scan_path = os.path.join(raw, scan, scan)
    g = os.path.join(td, "ground_seg", scan, "data")
    os.makedirs(g, exist_ok=True)
    np.save(os.path.join(g, f"{pos}_{h}_{d}.npy"),
            rng.rand(1, 16, 24).astype(np.float16))
    dd = os.path.join(scan_path, "matterport_depth_images")
    os.makedirs(dd, exist_ok=True)
    Image.fromarray(rng.randint(0, 40000, (32, 40)).astype(np.uint16)).save(
        os.path.join(dd, f"{pos}_d{h}_{d}.png"))
    pp = os.path.join(scan_path, "matterport_camera_poses")
    os.makedirs(pp, exist_ok=True)
    with open(os.path.join(pp, f"{pos}_pose_{h}_{d}.txt"), "w") as fh:
        fh.write(" ".join(str(v) for v in (np.eye(4) + rng.randn(4, 4) * 0.1).ravel()))
    ii = os.path.join(scan_path, "matterport_camera_intrinsics")
    os.makedirs(ii, exist_ok=True)
    with open(os.path.join(ii, f"{pos}_intrinsics_{h}.txt"), "w") as fh:
        fh.write(f"1280 1024 {fx} 900.0 640.0 512.0")


def test_matterport_scan_data_equals_jax(tmp_path):
    raw, td = str(tmp_path / "raw"), str(tmp_path / "td")
    rng = np.random.RandomState(4)
    _write_matterport_frame(raw, td, "scanA", "p0", 1, 0, rng)
    _write_matterport_frame(raw, td, "scanA", "p1", 1, 2, rng, fx=1100.0)
    _write_matterport_frame(raw, td, "scanB", "q0", 2, 3, rng)
    port = dl.MatterportLoader(raw, td, H, W)
    ref = jdl.MatterportLoader(raw, td, H, W)
    _equal(port.load_data("scanA", "p0", 1, 0), ref.load_data("scanA", "p0", 1, 0))
    assert port.pose_tracker.keys() == ref.pose_tracker.keys() == {
        ("p0", "1", "0"), ("p1", "1", "2")}
    for k in port.pose_tracker:
        np.testing.assert_array_equal(port.pose_tracker[k], ref.pose_tracker[k])
    for got, want in zip(port.load_frame_data("scanA", "p1", 1, 2),
                         ref.load_frame_data("scanA", "p1", 1, 2)):
        np.testing.assert_array_equal(got, want)

    # same scan -> cached (a change on disk is not seen)
    data = port.load_data("scanA", "p0", 1, 0)
    _write_matterport_frame(raw, td, "scanA", "p0", 1, 0, rng)
    np.testing.assert_array_equal(port.load_data("scanA", "p1", 1, 2)["depths"],
                                  data["depths"])
    # scan change -> reload and a fresh pose tracker
    other = port.load_data("scanB", "q0", 2, 3)
    _equal(other, ref.load_data("scanB", "q0", 2, 3))
    assert set(port.pose_tracker) == {("q0", "2", "3")}
