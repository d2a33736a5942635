"""Classical baselines, numpy and OpenCV on the host (counterpart of
footprints_tpu/baselines/footprint_baseline.py).

  visible_ground      hidden ground = empty set
  convex_hull         hull of the visible-ground mask
  bounding_box        hull minus externally-detected 3D-bbox footprints
  ransac_plane        RANSAC ground plane fit, depths inpainted by
                      ray/plane intersection (pred visible ground)
  ransac_plane_oracle same with ground-truth visible ground

  python -m footprints_tpu_torch.baselines.footprint_baseline --dataset kitti

reads ``predictions/<dataset>/`` (the dumps' ``ours/<idx>_color.npy`` for
KITTI, ``<scan>_<pos>_<h>_<d>.npy`` for Matterport) and writes
``predictions/predictions_rerun/<baseline>/``.  Every path comes from the
loaders' configuration; the ground truth is read, and downloaded, only by
the oracle baseline.
"""

import argparse
import os

import numpy as np

from ..core.config import readlines
from ..eval.evaluate_model import safe_convex_hull_image
from ..preprocessing.ground_truth_generation.ransac import (
    np_fit_plane,
    np_plane_distance,
)
from .geometry import BackprojectDepth, generate_camera_rays
from .prepare_test_data import KittiTestLoader, MatterportTestLoader


class BaselineParentClass:
    load_bounding_box_predictions = False
    load_visible_ground = "pred"
    baseline_type = "base"

    def __init__(self, dataset_type, loader=None):
        self.filenames = []
        self.dataset_type = dataset_type
        if loader is None:
            loader = {"kitti": KittiTestLoader,
                      "matterport": MatterportTestLoader}[dataset_type]()
        loader.load_bounding_box_predictions = self.load_bounding_box_predictions
        loader.load_visible_ground = self.load_visible_ground
        loader.baseline_type = self.baseline_type
        self.loader = loader

    def run_all(self):
        import cv2

        for test_file_line in self.filenames:
            inputs = self.loader(test_file_line)
            ground_mask, ground_depth = self.frame_predict(inputs)
            save_path = self.loader.get_save_path(self.get_baseline_type(),
                                                  test_file_line)
            cv2.imwrite(save_path + "_ground_mask.png",
                        (ground_mask * 255).astype(np.uint8))
            if ground_depth is not None:
                np.save(save_path + "_ground_depth.npy", ground_depth)

    def frame_predict(self, inputs):
        raise NotImplementedError

    def get_baseline_type(self):
        return self.baseline_type

    def ransac_depth_inpaint(self, depth, inv_K, visible_ground_mask):
        """Plane-fit the visible ground; replace depths by the exact
        ray/plane intersection z-depth: along the ray r(s) = s*dir (dir_z =
        1, so s is the z-depth) the plane crossing is at
        s* = depth - dist(P0) / (n_hat . dir)."""
        backprojector = BackprojectDepth(*depth.shape)
        xyz = backprojector(depth, inv_K)

        m, _, _ = np_fit_plane(xyz[visible_ground_mask.ravel()])

        rays = generate_camera_rays(*visible_ground_mask.shape, inv_K).T
        n_hat = m[:3] / np.linalg.norm(m[:3])
        dot = rays @ n_hat  # rays keep z=1 scaling: s parameter == z-depth
        distances = np_plane_distance(m, xyz)
        extra = distances / dot
        return depth - extra.reshape(depth.shape)


class VisibleGround(BaselineParentClass):
    """Hidden ground = empty set."""

    baseline_type = "visible_ground"

    def frame_predict(self, inputs):
        return inputs["visible_ground"] > 0.1, inputs.get("depth")


class ConvexHull(BaselineParentClass):
    baseline_type = "convex_hull"

    def frame_predict(self, inputs):
        visible = inputs["visible_ground"] > 0.5
        return safe_convex_hull_image(visible), None


class BoundingBox(ConvexHull):
    """Convex hull minus external 3D-bounding-box footprints."""

    baseline_type = "bounding_box"
    load_bounding_box_predictions = True

    def __init__(self, dataset_type, bounding_box_training_data, loader=None):
        super().__init__(dataset_type, loader)
        self.bounding_box_training_data = bounding_box_training_data
        self.loader.bounding_box_training_data = bounding_box_training_data

    def frame_predict(self, inputs):
        visible = inputs["visible_ground"] > 0.5
        all_floor = safe_convex_hull_image(visible).astype(np.uint8)
        all_floor[inputs["bounding_box_mask"] < 0.5] = 0
        all_floor[visible] = 1
        return all_floor, None

    def get_baseline_type(self):
        return f"{self.baseline_type}_{self.bounding_box_training_data}"


class RansacPlane(BaselineParentClass):
    baseline_type = "ransac_plane"
    load_visible_ground = "pred"

    def frame_predict(self, inputs):
        visible = inputs["visible_ground"] > 0.5
        if visible.sum() < 20:
            return inputs["depth"], inputs["depth"]
        floor_depth = self.ransac_depth_inpaint(
            inputs["depth"], inputs["inv_K"], visible)
        return floor_depth, floor_depth


class RansacPlaneOracle(RansacPlane):
    baseline_type = "ransac_plane_oracle"
    load_visible_ground = "ground_truth"


BASELINES = {
    "visible_ground": VisibleGround,
    "convex_hull": ConvexHull,
    "ransac_plane": RansacPlane,
    "ransac_plane_oracle": RansacPlaneOracle,
}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Footprint baselines.")
    parser.add_argument("--dataset", type=str, required=True,
                        choices=["matterport", "kitti"])
    parser.add_argument("--tiny", action="store_true",
                        help="evaluate on a 20-image subset (debugging)")
    parser.add_argument("--test_split", type=str, default=None,
                        help="matterport test split txt (default "
                             "splits/matterport/test.txt)")
    parser.add_argument("--dataset_root", type=str, default=None,
                        help="raw matterport tree (camera intrinsics for "
                             "the ransac baselines); default: "
                             "matterport.dataset from paths.yaml")
    opts = parser.parse_args(argv)

    if opts.dataset == "matterport":
        split = opts.test_split or os.path.join("splits", "matterport", "test.txt")
        test_filenames = readlines(split)[:500]
    else:
        test_filenames = list(range(697))
    if opts.tiny:
        test_filenames = test_filenames[:20]
    print(f"Testing on {len(test_filenames)} images")

    if opts.dataset == "matterport":
        # each predictor sets its loader's flags -> one loader each
        def mk():
            return MatterportTestLoader(dataset_root=opts.dataset_root)
        runs = [VisibleGround(opts.dataset, loader=mk()),
                ConvexHull(opts.dataset, loader=mk()),
                RansacPlaneOracle(opts.dataset, loader=mk()),
                RansacPlane(opts.dataset, loader=mk())]
    else:
        runs = [VisibleGround(opts.dataset), ConvexHull(opts.dataset),
                BoundingBox(opts.dataset, "3d_boundingbox")]
    for predictor in runs:
        predictor.filenames = test_filenames
        predictor.run_all()


if __name__ == "__main__":
    main()
