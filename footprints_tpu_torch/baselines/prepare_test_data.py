"""Test-time input loaders for the baselines (counterpart of
footprints_tpu/baselines/prepare_test_data.py).

Every root is a constructor argument with a paths.yaml-compatible default.
The ground truth is downloaded on its first access only, so the
prediction-only baselines never touch the archives.  OpenCV is imported
where an image is read or resized.
"""

import os

import numpy as np

from ..core.ops import np_sigmoid_to_depth
from ..utils import GROUND_TRUTH_DIR, download_ground_truths_if_dont_exist


def cv2_imread_strict(im_path, *args):
    import cv2

    if os.path.isfile(im_path):
        return cv2.imread(im_path, *args)[:, :, ::-1]
    raise FileNotFoundError(im_path)


def _resize(image, size):
    import cv2

    return cv2.resize(image, size)


class TestLoader:
    #: dataset key for the lazy ground-truth download ('kitti'/'matterport')
    GT_KEY = None

    def __init__(self, load_bounding_box_predictions=False,
                 load_visible_ground="pred", baseline_type="",
                 gt_dir=None, download=True):
        self.load_bounding_box_predictions = load_bounding_box_predictions
        self.load_visible_ground = load_visible_ground
        self.baseline_type = baseline_type
        self._gt_dir = gt_dir
        self._download = download

    @property
    def gt_dir(self):
        """Resolved (and downloaded, if allowed) on first access only, so
        baselines that never read the ground truth work offline."""
        if self._gt_dir is None:
            if self._download:
                download_ground_truths_if_dont_exist(self.GT_KEY)
            sub = f"{self.GT_KEY}_ground_truth"
            self._gt_dir = os.path.join(GROUND_TRUTH_DIR, sub, sub)
        return self._gt_dir


class KittiTestLoader(TestLoader):
    W, H = 640, 192
    GT_KEY = "kitti"

    def __init__(self, predictions_root="predictions/kitti", **kwargs):
        super().__init__(**kwargs)
        self.predictions_root = predictions_root

    def __call__(self, frame_num):
        inputs = {}
        if self.load_visible_ground == "pred":
            pred = np.load(os.path.join(self.predictions_root, "ours",
                                        f"{frame_num:03d}_color.npy"))
            inputs["visible_ground"] = pred[0]  # VISIBLE_GROUND channel
        elif self.load_visible_ground == "ground_truth":
            inputs["visible_ground"] = cv2_imread_strict(
                os.path.join(self.gt_dir, f"{frame_num:05d}_ground.png"))

        if self.load_bounding_box_predictions:
            inputs["bounding_box_mask"] = cv2_imread_strict(os.path.join(
                self.predictions_root, "bounding_box_detections",
                f"{frame_num:03d}_colorfootprint.png"))[:, :, 0]

        for key in inputs:
            inputs[key] = _resize(inputs[key].astype(np.float32), (self.W, self.H))
        return inputs

    def get_save_path(self, baseline_type, test_file_line):
        save_path = os.path.join(self.predictions_root, "..",
                                 "predictions_rerun", baseline_type,
                                 str(test_file_line))
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        return save_path


class MatterportTestLoader(TestLoader):
    H, W = 512, 640
    GT_KEY = "matterport"

    def __init__(self, predictions_root="predictions/matterport",
                 dataset_root=None, **kwargs):
        super().__init__(**kwargs)
        self.predictions_root = predictions_root
        self.dataset_root = dataset_root

    def _pred_path(self, frame_data):
        return os.path.join(self.predictions_root,
                            "{}_{}_{}_{}.npy".format(*frame_data))

    def _resolve_dataset_root(self):
        """The ransac baselines need the raw-dataset intrinsics; resolve
        from paths.yaml when not given, with a clear error otherwise."""
        if self.dataset_root is None:
            try:
                from ..core.config import load_config

                self.dataset_root = load_config("paths.yaml")["matterport"][
                    "dataset"]
            except Exception:
                pass
        if self.dataset_root is None:
            raise ValueError(
                "MatterportTestLoader needs dataset_root (the raw matterport "
                "tree, for camera intrinsics) — pass --dataset_root or set "
                "matterport.dataset in paths.yaml")
        return self.dataset_root

    def load_intrinsics(self, frame_data, depth):
        path = os.path.join(
            self._resolve_dataset_root(),
            "{}/{}/matterport_camera_intrinsics/{}_intrinsics_{}.txt".format(
                frame_data[0], frame_data[0], frame_data[1], frame_data[2]))
        vals = np.loadtxt(path)
        K = np.eye(3)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = vals[2], vals[3], vals[4], vals[5]
        # depth is already resized to (W,H), so these factors are 1.0; kept
        # for a caller that passes raw depth
        K[0, :] *= depth.shape[1] / self.W
        K[1, :] *= depth.shape[0] / self.H
        return K, np.linalg.pinv(K)

    def __call__(self, test_file_line):
        frame_data = test_file_line.strip().split()
        inputs = {}
        pred = None
        if "ransac_plane" in self.baseline_type:
            pred = np.load(self._pred_path(frame_data))
            depth = _resize(np_sigmoid_to_depth(pred[2]).astype(np.float32),
                            (self.W, self.H))
            K, inv_K = self.load_intrinsics(frame_data, depth)
            inputs.update({"depth": depth, "inv_K": inv_K, "K": K})

        if self.load_visible_ground == "pred":
            if pred is None:
                pred = np.load(self._pred_path(frame_data))
            inputs["visible_ground"] = _resize(pred[0].astype(np.float32),
                                               (self.W, self.H))
        elif self.load_visible_ground == "ground_truth":
            gt = np.load(os.path.join(
                self.gt_dir, "{}_{}_{}_{}_groundtruth.npy".format(*frame_data)))
            inputs["visible_ground"] = _resize(gt.astype(np.float32),
                                               (self.W, self.H))

        if self.load_bounding_box_predictions:
            mask = cv2_imread_strict(os.path.join(
                self.predictions_root, "bounding_box_detections",
                self.bounding_box_training_data,
                "{}_{}_{}_{}.png".format(*frame_data)))
            inputs["bounding_box_mask"] = _resize(mask.astype(np.float32),
                                                  (self.W, self.H))[:, :, 0]
        return inputs

    def get_save_path(self, baseline_type, test_file_line):
        save_path = os.path.join(self.predictions_root, "..",
                                 "predictions_rerun", baseline_type,
                                 str(test_file_line).replace(" ", "_"))
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        return save_path
