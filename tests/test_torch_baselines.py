"""The port's classical baselines (footprints_tpu_torch/baselines/) against
the JAX package's: the geometry twins, every predictor's output
np.array_equal to the JAX predictor's on synthetic inputs, the loaders on a
synthetic prediction tree, ``run_all``'s files, and tests/test_baselines.py
mirrored (no ground-truth download unless the ground truth is read)."""

import os

import cv2
import numpy as np
import pytest

from footprints_tpu.baselines import footprint_baseline as jfb
from footprints_tpu.baselines import geometry as jgeom
from footprints_tpu.baselines import prepare_test_data as jptd
from footprints_tpu_torch.baselines import footprint_baseline as fb
from footprints_tpu_torch.baselines import geometry as geom
from footprints_tpu_torch.baselines import prepare_test_data as ptd

H, W = 48, 64
N_KITTI = 20  # main's --tiny subset


def _camera():
    K = np.eye(3)
    K[0, 0] = K[1, 1] = 40.0
    K[0, 2], K[1, 2] = W / 2, H / 2
    return K, np.linalg.pinv(K)


def _plane_scene():
    """Ground plane 1.5 m down plus a box; the plane depth and the visible
    ground."""
    K, inv_K = _camera()
    depth = np.zeros((H, W))
    plane_depth = np.zeros((H, W))
    visible = np.zeros((H, W), bool)
    for y in range(H):
        z = min(K[1, 1] * 1.5 / (y - K[1, 2]) if y > K[1, 2] else 1e3, 40.0)
        plane_depth[y, :] = depth[y, :] = z
        visible[y, :] = y > K[1, 2] and z < 40
    depth[20:35, 30:40] = 5.0
    visible[20:35, 30:40] = False
    return depth, plane_depth, visible, inv_K


def _inputs(seed):
    rng = np.random.RandomState(seed)
    depth, _, visible, inv_K = _plane_scene()
    ground = visible * rng.uniform(0.4, 1.0, (H, W))
    ground[rng.rand(H, W) < 0.05] = 0.3
    return {"visible_ground": ground, "depth": depth + rng.rand(H, W) * 0.01,
            "inv_K": inv_K, "bounding_box_mask": (rng.rand(H, W) > 0.2) * 1.0}


def _pair(name):
    cls, jcls = getattr(fb, name), getattr(jfb, name)
    return cls.__new__(cls), jcls.__new__(jcls)


def test_geometry_equals_jax():
    K, inv_K = _camera()
    depth = np.random.RandomState(0).rand(H, W) * 10 + 1
    xyz = geom.BackprojectDepth(H, W)(depth, inv_K)
    np.testing.assert_array_equal(xyz, jgeom.BackprojectDepth(H, W)(depth, inv_K))
    K4, pts = np.eye(4), np.concatenate([xyz.T, np.ones((1, H * W))])
    K4[:3, :3] = K
    pix = geom.Project3D(H, W)(pts, K4, np.eye(4))
    np.testing.assert_array_equal(pix, jgeom.Project3D(H, W)(pts, K4, np.eye(4)))
    xs, ys = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
    np.testing.assert_allclose(pix[0].reshape(H, W), xs, atol=1e-4)
    np.testing.assert_allclose(pix[1].reshape(H, W), ys, atol=1e-4)
    rays = geom.generate_camera_rays(H, W, inv_K)
    np.testing.assert_array_equal(rays, jgeom.generate_camera_rays(H, W, inv_K))
    np.testing.assert_allclose(rays[2], 1.0, atol=1e-9)
    v = np.arange(1.0, 4.0)
    np.testing.assert_array_equal(geom.norm(v), jgeom.norm(v))


@pytest.mark.parametrize("name", ["VisibleGround", "ConvexHull", "RansacPlane",
                                  "RansacPlaneOracle"])
@pytest.mark.parametrize("seed", [0, 1])
def test_predictor_equals_jax(name, seed):
    port, ref = _pair(name)
    inputs = _inputs(seed)
    got, want = port.frame_predict(dict(inputs)), ref.frame_predict(dict(inputs))
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, w)


def test_bounding_box_predictor_equals_jax():
    inputs = _inputs(2)
    port = fb.BoundingBox("kitti", "3d_boundingbox", loader=ptd.KittiTestLoader(download=False))
    ref = jfb.BoundingBox("kitti", "3d_boundingbox", loader=jptd.KittiTestLoader(download=False))
    got, want = port.frame_predict(inputs), ref.frame_predict(inputs)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] is None and port.get_baseline_type() == ref.get_baseline_type()


def test_convex_hull_fills_the_interior():
    ch = fb.ConvexHull.__new__(fb.ConvexHull)
    vis = np.zeros((20, 20))
    vis[5, 5] = vis[5, 15] = vis[15, 5] = vis[15, 15] = 1.0
    mask, _ = ch.frame_predict({"visible_ground": vis})
    assert mask[10, 10] and not mask[1, 1]


def test_ransac_plane_inpaint_recovers_plane_depth():
    depth, plane_depth, visible, inv_K = _plane_scene()
    rp = fb.RansacPlane.__new__(fb.RansacPlane)
    out, _ = rp.frame_predict({"visible_ground": visible.astype(float), "depth": depth,
                               "inv_K": inv_K})
    assert np.median(np.abs(out - plane_depth)[visible]) < 0.1
    assert np.median(np.abs(out - plane_depth)[25:33, 32:38]) < 1.0


def test_ransac_plane_too_few_ground_pixels_passthrough():
    rp = fb.RansacPlane.__new__(fb.RansacPlane)
    depth = np.ones((H, W))
    out, out_d = rp.frame_predict({"visible_ground": np.zeros((H, W)), "depth": depth,
                                   "inv_K": np.eye(3)})
    np.testing.assert_array_equal(out, depth)
    np.testing.assert_array_equal(out_d, depth)


def _prediction_tree(root):
    """KITTI dumps (ours/<idx>_color.npy) and bounding boxes; Matterport
    dumps, intrinsics and ground truth."""
    rng = np.random.RandomState(3)
    kitti = root / "predictions" / "kitti"
    os.makedirs(kitti / "ours")
    os.makedirs(kitti / "bounding_box_detections")
    for i in range(N_KITTI):
        np.save(kitti / "ours" / f"{i:03d}_color.npy",
                rng.rand(4, 96, 320).astype(np.float16))
        cv2.imwrite(str(kitti / "bounding_box_detections" / f"{i:03d}_colorfootprint.png"),
                    (rng.rand(96, 320, 3) > 0.3).astype(np.uint8) * 255)
    mp = root / "predictions" / "matterport"
    os.makedirs(mp)
    lines = ["scanA p0 1 0", "scanA p1 2 3"]
    gt = root / "mp_gt"
    os.makedirs(gt)
    for line in lines:
        scan, pos, h, d = line.split()
        np.save(mp / f"{scan}_{pos}_{h}_{d}.npy", rng.rand(4, 256, 320).astype(np.float16))
        np.save(gt / f"{scan}_{pos}_{h}_{d}_groundtruth.npy", rng.rand(256, 320) > 0.5)
        folder = root / "mp_raw" / scan / scan / "matterport_camera_intrinsics"
        os.makedirs(folder, exist_ok=True)
        np.savetxt(folder / f"{pos}_intrinsics_{h}.txt",
                   [[1280, 1024, 1075.0, 1075.0, 640.0, 512.0]])
    return kitti, mp, gt, lines


def test_loaders_and_run_all_equal_jax(tmp_path):
    kitti, mp, gt, lines = _prediction_tree(tmp_path)
    mp_roots = {"predictions_root": str(mp), "dataset_root": str(tmp_path / "mp_raw"),
                "gt_dir": str(gt)}
    cases = [("KittiTestLoader", {"predictions_root": str(kitti)}, range(N_KITTI),
              dict(load_visible_ground="pred")),
             ("KittiTestLoader", {"predictions_root": str(kitti)}, range(N_KITTI),
              dict(load_visible_ground=None, load_bounding_box_predictions=True)),
             ("MatterportTestLoader", mp_roots, lines,
              dict(load_visible_ground="pred", baseline_type="ransac_plane")),
             ("MatterportTestLoader", mp_roots, lines,
              dict(load_visible_ground="ground_truth", baseline_type="ransac_plane_oracle"))]
    for name, roots, keys, flags in cases:
        port = getattr(ptd, name)(download=False, **roots, **flags)
        ref = getattr(jptd, name)(download=False, **roots, **flags)
        for key in keys:
            got, want = port(key), ref(key)
            assert got.keys() == want.keys() and got
            for k in got:
                np.testing.assert_array_equal(got[k], want[k])

    # run_all writes the same files as the JAX predictor
    for package, loader_mod in ((fb, ptd), (jfb, jptd)):
        for cls in ("VisibleGround", "ConvexHull"):
            predictor = getattr(package, cls)(
                "kitti", loader=loader_mod.KittiTestLoader(predictions_root=str(kitti),
                                                           download=False))
            predictor.filenames = list(range(N_KITTI))
            predictor.run_all()
            os.rename(kitti.parent / "predictions_rerun" / predictor.get_baseline_type(),
                      tmp_path / f"{package.__name__.split('.')[0]}_{cls}")
    for cls in ("VisibleGround", "ConvexHull"):
        port_dir, jax_dir = (tmp_path / f"footprints_tpu_torch_{cls}",
                             tmp_path / f"footprints_tpu_{cls}")
        assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) != []
        for f in os.listdir(jax_dir):
            np.testing.assert_array_equal(cv2.imread(str(port_dir / f)),
                                          cv2.imread(str(jax_dir / f)))


def test_matterport_loader_dataset_root_error_is_clear(tmp_path, monkeypatch):
    loader = ptd.MatterportTestLoader(download=False)
    monkeypatch.chdir(tmp_path)  # no paths.yaml here
    with pytest.raises(ValueError, match="dataset_root"):
        loader._resolve_dataset_root()


def test_loaders_do_not_download_gt_unless_accessed(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("GT download triggered eagerly")

    monkeypatch.setattr(ptd, "download_ground_truths_if_dont_exist", boom)
    kl, ml = ptd.KittiTestLoader(), ptd.MatterportTestLoader()
    with pytest.raises(AssertionError):
        _ = kl.gt_dir
    with pytest.raises(AssertionError):
        _ = ml.gt_dir
    assert ptd.KittiTestLoader(gt_dir="/x").gt_dir == "/x"


def test_main_never_downloads_for_the_kitti_baselines(tmp_path, monkeypatch):
    """main over KITTI runs the prediction-only baselines: no ground-truth
    read, so no download."""
    def boom(*a, **k):
        raise AssertionError("GT download triggered")

    monkeypatch.setattr(ptd, "download_ground_truths_if_dont_exist", boom)
    kitti, _, _, _ = _prediction_tree(tmp_path)
    monkeypatch.chdir(kitti.parent.parent)
    monkeypatch.setattr(fb, "KittiTestLoader", lambda: ptd.KittiTestLoader(
        predictions_root=str(kitti)))
    fb.main(["--dataset", "kitti", "--tiny"])
    rerun = kitti.parent / "predictions_rerun"
    assert sorted(os.listdir(rerun)) == ["bounding_box_3d_boundingbox", "convex_hull",
                                         "visible_ground"]
    assert all(len(os.listdir(rerun / d)) == N_KITTI for d in os.listdir(rerun))
