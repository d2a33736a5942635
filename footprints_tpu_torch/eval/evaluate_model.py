"""Offline metric harness, numpy on the host (counterpart of
footprints_tpu/eval/evaluate_model.py).

  * mask metrics: gt thresholded > 0.1, pred > 0.5; iou/precision/recall/f1,
    NaN when the gt mask is empty; aggregated with np.nanmean
  * "freespace" on the hidden-ground channel; "footprint" on the inverted
    masks restricted to the free-space region
  * depth metrics (matterport only): a1/abs_rel/sq_rel/rmse on values
    clipped to [0.5, 20] m, over gt > 0 pixels
  * KITTI GT: png pairs "{:05d}_combined.png" / "_ground.png", binarised
    > 128; Matterport GT: per-test-line npy pairs
  * predictions: [4,H,W] npy (channels-first) or a baseline's
    "<idx>_ground_mask.png"

cv2 is imported where a png is read or a hull drawn, so Matterport scores
on a host without OpenCV.  ``download=False`` reads a local ``gt_dir``.

  python -m footprints_tpu_torch.eval.evaluate_model --predictions <dir> \\
      --datatype kitti --metric iou
"""

import argparse
import os

import numpy as np

from ..core.config import readlines
from ..core.ops import np_sigmoid_to_depth
from ..utils import GROUND_TRUTH_DIR, download_ground_truths_if_dont_exist

# Channels in the .npy prediction arrays
VISIBLE_GROUND = 0
HIDDEN_GROUND = 1
DEPTH = 2
HIDDEN_DEPTH = 3


def load_mask(filepath):
    import cv2

    if not os.path.exists(filepath):
        raise FileNotFoundError(filepath)
    return cv2.imread(filepath, cv2.IMREAD_GRAYSCALE) > 128


def convex_hull_image(mask):
    """Convex hull of a binary mask (cv2-based; skimage-equivalent)."""
    import cv2

    mask = np.asarray(mask)
    points = cv2.findNonZero(mask.astype(np.uint8))
    if points is None:
        raise ValueError("empty mask has no convex hull")
    hull = cv2.convexHull(points)
    out = np.zeros(mask.shape, np.uint8)
    cv2.fillConvexPoly(out, hull, 1)
    return out.astype(bool)


def safe_convex_hull_image(im):
    try:
        return convex_hull_image(im)
    except ValueError:
        print("Warning - failed to compute convex hull")
        return im * 0


def evaluate_depth(gt, pred, max_depth=20):
    gt = np.clip(gt, 0.5, max_depth)
    pred = np.clip(pred, 0.5, max_depth)
    if gt.size == 0:
        return {k: np.nan for k in ["a1", "abs_rel", "sq_rel", "rmse"]}
    thresh = np.maximum(gt / pred, pred / gt)
    return {
        "a1": (thresh < 1.25).mean(),
        "abs_rel": np.mean(np.abs(gt - pred) / gt),
        "sq_rel": np.mean((gt - pred) ** 2 / gt),
        "rmse": np.sqrt(((gt - pred) ** 2).mean()),
    }


def evaluate_mask(true, pred):
    true_mask = true > 0.1
    pred_mask = pred > 0.5
    if true_mask.sum() == 0:
        return {k: np.nan for k in ["iou", "precision", "recall", "f1"]}
    union = np.logical_or(true_mask, pred_mask).sum()
    tp = np.logical_and(true_mask, pred_mask).sum()
    fp = np.logical_and(~true_mask, pred_mask).sum()
    fn = np.logical_and(true_mask, ~pred_mask).sum()
    iou = tp / union if union > 0 else 0
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) > 0 else 0)
    return {"iou": iou, "precision": precision, "recall": recall, "f1": f1}


def load_kitti_ground_truth(im_idx, gt_dir=None):
    gt_dir = gt_dir or os.path.join(GROUND_TRUTH_DIR, "kitti_ground_truth",
                                    "kitti_ground_truth")
    ground_truth = load_mask(os.path.join(gt_dir, f"{im_idx:05d}_combined.png"))
    free_space = load_mask(os.path.join(gt_dir, f"{im_idx:05d}_ground.png"))
    return ground_truth, free_space


def load_matterport_ground_truth(filename, gt_dir=None):
    gt_dir = gt_dir or os.path.join(GROUND_TRUTH_DIR, "matterport_ground_truth",
                                    "matterport_ground_truth")
    hidden_ground = np.load(os.path.join(
        gt_dir, "{}_{}_{}_{}_groundtruth.npy".format(*filename)))
    free_space = np.load(os.path.join(
        gt_dir, "{}_{}_{}_{}_freespace.npy".format(*filename))) > 0.5
    return hidden_ground, free_space


def evaluate(pred_folder, datatype, metric, *, gt_dir=None, split_root="splits",
             n_kitti=697, download=True, verbose=True):
    """Evaluate a folder of predictions.  Returns the aggregated score dict."""
    if datatype == "kitti":
        if download:
            download_ground_truths_if_dont_exist("kitti")
        filenames = range(n_kitti)
        if metric == "depth":
            raise ValueError("The kitti annotations do not contain depth data")
    elif datatype == "matterport":
        if download:
            download_ground_truths_if_dont_exist("matterport")
        filenames = [x.split() for x in
                     readlines(os.path.join(split_root, "matterport", "test.txt"))]
    else:
        raise ValueError(f"unknown datatype {datatype}")

    all_scores = []
    for filename in filenames:
        if datatype == "kitti":
            ground_truth, free_space = load_kitti_ground_truth(filename, gt_dir)
            try:
                pred = np.load(os.path.join(pred_folder, f"{filename:03d}.npy"))
            except FileNotFoundError:
                pred = load_mask(os.path.join(pred_folder,
                                              f"{filename:d}_ground_mask.png"))
        else:
            ground_truth, free_space = load_matterport_ground_truth(filename, gt_dir)
            pred = np.load(os.path.join(pred_folder, filename[0],
                                        "{}_{}_{}.npy".format(*filename[1:])))

        if metric == "iou":
            if pred.ndim == 3:
                pred = pred[HIDDEN_GROUND]
            all_scores.append({
                "freespace": evaluate_mask(ground_truth, pred),
                "footprint": evaluate_mask(1 - ground_truth[free_space],
                                           1 - pred[free_space]),
            })
        elif metric == "depth":
            if pred.ndim == 3:
                pred = np_sigmoid_to_depth(pred[HIDDEN_DEPTH])
            mask = ground_truth > 0
            all_scores.append(evaluate_depth(ground_truth[mask], pred[mask]))
        else:
            raise ValueError(f"unknown metric {metric}")

    if metric == "iou":
        results = {
            "freespace_iou": np.nanmean([s["freespace"]["iou"] for s in all_scores]),
            "freespace_f1": np.nanmean([s["freespace"]["f1"] for s in all_scores]),
            "footprint_iou": np.nanmean([s["footprint"]["iou"] for s in all_scores]),
            "footprint_f1": np.nanmean([s["footprint"]["f1"] for s in all_scores]),
        }
        if verbose:
            print(f"Freespace IoU:  {results['freespace_iou']:0.3f}")
            print(f"Freespace F1:   {results['freespace_f1']:0.3f}")
            print(f"Footprint IoU:  {results['footprint_iou']:0.3f}")
            print(f"Footprint F1:   {results['footprint_f1']:0.3f}")
    else:
        results = {k: np.nanmean([s[k] for s in all_scores])
                   for k in ["a1", "rmse", "abs_rel", "sq_rel"]}
        if verbose:
            print(f"a1:       {results['a1']:0.3f}")
            print(f"rmse:     {results['rmse']:0.3f}")
            print(f"Abs. rel: {results['abs_rel']:0.3f}")
            print(f"Sq. rel:  {results['sq_rel']:0.3f}")
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate footprints predictions.")
    parser.add_argument("--predictions", type=str, required=True)
    parser.add_argument("--datatype", type=str, required=True,
                        choices=["kitti", "matterport"])
    parser.add_argument("--metric", type=str, required=True,
                        choices=["iou", "depth"])
    return parser.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    evaluate(pred_folder=args.predictions, datatype=args.datatype,
             metric=args.metric)
