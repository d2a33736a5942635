"""KITTI training dataset (counterpart of footprints_tpu/data/kitti.py).

  * split line "<seq> <frame> <l|r>"; image at
    <raw>/<seq>/image_02|03/data/<frame:010d>.jpg
  * intrinsics fx = 0.58 W; stereo baseline 0.54 m
  * ground_seg npy thresholded at 0.75 (INTER_AREA resize)
  * hidden_depths npy -> ground_depth (INTER_AREA), zeroed where depth_mask
  * depth_masks npy (INTER_NEAREST) -> small-component filter; a missing
    file gives zeros; ``no_depth_mask`` zeroes it
  * PSMNet stereo disparity npy: INTER_AREA resize with width-ratio rescale,
    then the -1.25 disparity correction, then disparity -> depth
  * moving_objects npy when moving_objects_method == 'ours', zeroed where
    visible ground or depth mask
  * ``project_down_baseline`` replaces ground_depth with ones (and needs
    moving_objects_method == 'none')
"""

import os

import numpy as np

from ..core.ops import np_pixel_disp_to_depth
from .base import FootprintsDataset


class KITTIDataset(FootprintsDataset):
    BASELINE = 0.54
    FOOTPRINT_THRESHOLD = 0.75
    DISPARITY_CORRECTION = 1.25  # PSMNet systematic offset

    def __init__(self, raw_data_path, training_data_path, filenames, height, width,
                 no_depth_mask=False, moving_objects_method="ours",
                 project_down_baseline=False, is_train=False, seed=0, **kwargs):
        super().__init__(raw_data_path, training_data_path, filenames, height, width,
                         is_train, seed)
        self.fx = 0.58 * width
        self.no_depth_mask = no_depth_mask
        self.moving_objects_method = moving_objects_method
        self.project_down_baseline = project_down_baseline
        if project_down_baseline and moving_objects_method != "none":
            raise ValueError("project_down_baseline is incompatible with "
                             "moving-object masking")

    def _paths(self, index):
        seq, frame, side = self.filenames[index].split()
        cam = "image_02" if side == "l" else "image_03"
        return seq, cam, frame.zfill(10)

    def __getitem__(self, index):
        import cv2

        seq, cam, frame = self._paths(index)
        do_flip, do_color_aug = self.draw_augmentations()
        td = self.training_data_path

        image = self.load_and_resize_image(
            os.path.join(self.raw_data_path, seq, cam, "data", frame + ".jpg"), do_flip
        )

        visible_ground = self.load_and_resize_npy(
            os.path.join(td, "ground_seg", seq, cam, "data", frame + ".npy"),
            do_flip, method=cv2.INTER_AREA,
        ) > self.FOOTPRINT_THRESHOLD

        ground_depth = self.load_and_resize_npy(
            os.path.join(td, "hidden_depths", seq, cam, "data", frame + ".npy"),
            do_flip, method=cv2.INTER_AREA,
        )
        if self.project_down_baseline:
            ground_depth = np.ones_like(ground_depth)

        try:
            depth_mask = self.load_and_resize_npy(
                os.path.join(td, "depth_masks", seq, cam, "data", frame + ".npy"), do_flip
            )
            depth_mask = self.filter_depth_mask(depth_mask)
        except FileNotFoundError:
            depth_mask = np.zeros_like(ground_depth)
        if self.no_depth_mask:
            depth_mask = depth_mask * 0

        ground_depth[depth_mask.astype(bool)] = 0

        pixel_disparity = self.load_and_resize_npy(
            os.path.join(td, "stereo_matching_disps", seq, cam, frame + ".npy"),
            do_flip, rescale=True, method=cv2.INTER_AREA,
        ) - self.DISPARITY_CORRECTION
        depth = np_pixel_disp_to_depth(pixel_disparity, self.fx, self.BASELINE)

        if self.moving_objects_method == "ours":
            moving_objects = self.load_and_resize_npy(
                os.path.join(td, "moving_objects", seq, cam, "data", frame + ".npy"),
                do_flip,
            )
        else:
            moving_objects = np.zeros((self.height, self.width))
        moving_objects = moving_objects * (1 - visible_ground) * (1 - depth_mask)

        return self.preprocess(
            {
                "image": image,
                "visible_ground": visible_ground,
                "depth": depth,
                "ground_depth": ground_depth,
                "moving_object_mask": moving_objects,
                "depth_mask": depth_mask,
            },
            do_color_aug,
        )
