"""The port's offline metric harness against the JAX package's, equal to
1e-12, with ``download=False`` on synthetic ground truth: KITTI IoU (png
pairs, one baseline ``_ground_mask.png`` prediction), Matterport IoU and
depth (npy pairs, one empty ground-truth mask: the NaN path); and the mask,
depth and convex-hull helpers."""

import os

import cv2
import numpy as np
import pytest

from footprints_tpu.eval import evaluate_model as jax_eval
from footprints_tpu_torch.eval import evaluate_model as port_eval

H, W = 40, 56
N_KITTI = 4
MP_LINES = ["scanA p0 1 0", "scanA p1 1 2", "scanB p2 0 1"]


def _masks(rng):
    return (rng.rand(H, W) > 0.5).astype(np.uint8) * 255


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.RandomState(0)
    kitti_gt, kitti_pred = root / "kitti_gt", root / "kitti_pred"
    os.makedirs(kitti_gt)
    os.makedirs(kitti_pred)
    for i in range(N_KITTI):
        cv2.imwrite(str(kitti_gt / f"{i:05d}_combined.png"), _masks(rng))
        cv2.imwrite(str(kitti_gt / f"{i:05d}_ground.png"), _masks(rng))
        if i < N_KITTI - 1:
            np.save(kitti_pred / f"{i:03d}.npy",
                    rng.rand(4, H, W).astype(np.float16))
        else:  # a baseline's binary mask in place of a network's npy
            cv2.imwrite(str(kitti_pred / f"{i}_ground_mask.png"), _masks(rng))

    mp_gt, mp_pred = root / "mp_gt", root / "mp_pred"
    os.makedirs(mp_gt)
    for k, line in enumerate(MP_LINES):
        scan, pos, h, d = line.split()
        hidden = (rng.rand(H, W) * 25) * (rng.rand(H, W) > 0.4)
        if k == 1:
            hidden[:] = 0  # empty mask: NaN mask metrics, an empty depth set
        np.save(mp_gt / f"{scan}_{pos}_{h}_{d}_groundtruth.npy", hidden)
        np.save(mp_gt / f"{scan}_{pos}_{h}_{d}_freespace.npy", rng.rand(H, W))
        os.makedirs(mp_pred / scan, exist_ok=True)
        np.save(mp_pred / scan / f"{pos}_{h}_{d}.npy", rng.rand(4, H, W).astype(np.float16))
    os.makedirs(root / "splits" / "matterport")
    (root / "splits" / "matterport" / "test.txt").write_text("\n".join(MP_LINES))
    return root


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if np.isnan(b[k]):
            assert np.isnan(a[k]), k
        else:
            assert abs(a[k] - b[k]) <= 1e-12, (k, a[k], b[k])


def test_kitti_iou_matches_jax(trees):
    kw = dict(gt_dir=str(trees / "kitti_gt"), n_kitti=N_KITTI, download=False,
              verbose=False)
    got = port_eval.evaluate(str(trees / "kitti_pred"), "kitti", "iou", **kw)
    ref = jax_eval.evaluate(str(trees / "kitti_pred"), "kitti", "iou", **kw)
    _same(got, ref)
    assert all(np.isfinite(v) for v in got.values())
    with pytest.raises(ValueError, match="depth"):
        port_eval.evaluate(str(trees / "kitti_pred"), "kitti", "depth", **kw)


@pytest.mark.parametrize("metric,keys", [
    ("iou", ["footprint_f1", "footprint_iou", "freespace_f1", "freespace_iou"]),
    ("depth", ["a1", "abs_rel", "rmse", "sq_rel"])])
def test_matterport_matches_jax(trees, metric, keys):
    kw = dict(gt_dir=str(trees / "mp_gt"), split_root=str(trees / "splits"),
              download=False, verbose=False)
    got = port_eval.evaluate(str(trees / "mp_pred"), "matterport", metric, **kw)
    ref = jax_eval.evaluate(str(trees / "mp_pred"), "matterport", metric, **kw)
    assert sorted(got) == keys
    _same(got, ref)
    assert all(np.isfinite(v) for v in got.values())  # nanmean skips the empty one


def test_mask_and_depth_helpers_match_jax():
    rng = np.random.RandomState(5)
    for _ in range(3):
        true, pred = rng.rand(H, W), rng.rand(H, W)
        _same(port_eval.evaluate_mask(true, pred), jax_eval.evaluate_mask(true, pred))
        gt, pd = rng.rand(50) * 30, rng.rand(50) * 30
        _same(port_eval.evaluate_depth(gt, pd), jax_eval.evaluate_depth(gt, pd))
    empty = port_eval.evaluate_mask(np.zeros((H, W)), rng.rand(H, W))
    assert all(np.isnan(v) for v in empty.values())
    assert all(np.isnan(v) for v in port_eval.evaluate_depth(np.zeros(0),
                                                             np.zeros(0)).values())


def test_convex_hull_matches_jax_and_empty_mask_gives_zeros(capsys):
    mask = np.zeros((H, W), bool)
    mask[5, 6] = mask[30, 10] = mask[12, 50] = True
    got = port_eval.safe_convex_hull_image(mask)
    np.testing.assert_array_equal(got, jax_eval.safe_convex_hull_image(mask))
    assert got.sum() > 3 and got[5, 6] and got[30, 10]
    empty = port_eval.safe_convex_hull_image(np.zeros((H, W), bool))
    assert empty.shape == (H, W) and not empty.any()
    assert "failed to compute convex hull" in capsys.readouterr().out
    with pytest.raises(ValueError):
        port_eval.convex_hull_image(np.zeros((H, W), bool))


def test_unknown_datatype_and_metric_raise(trees):
    with pytest.raises(ValueError, match="datatype"):
        port_eval.evaluate(str(trees), "nyu", "iou", download=False)
    with pytest.raises(ValueError, match="metric"):
        port_eval.evaluate(str(trees / "mp_pred"), "matterport", "psnr",
                           gt_dir=str(trees / "mp_gt"), split_root=str(trees / "splits"),
                           download=False)
    args = port_eval.parse_args(["--predictions", "p", "--datatype", "kitti",
                                 "--metric", "iou"])
    assert (args.predictions, args.datatype, args.metric) == ("p", "kitti", "iou")
