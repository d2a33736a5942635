"""Matterport training dataset (counterpart of footprints_tpu/data/matterport.py).

  * split line "<scan> <pos> <height> <direction>"
  * image <raw>/<scan>/<scan>/matterport_color_images/<pos>_i<h>_<dir>.jpg
  * 16-bit depth PNG (NEAREST resize) scaled as float64 by 0.00025 to metres
  * ground_seg thresholded at 0.75 (INTER_AREA)
  * hidden_depth: the 0.1 sentinel -> 0, clipped to < 10 m; zeroed where
    depth_mask
  * depth_masks small-component filtered; a missing file gives zeros
  * no moving objects
"""

import os

import numpy as np

from .base import FootprintsDataset


class MatterportDataset(FootprintsDataset):
    DEPTH_SCALING = 0.00025  # 16-bit png -> metres (Matterport spec)
    FOOTPRINT_THRESHOLD = 0.75
    MAX_HIDDEN_DEPTH = 10.0

    def __init__(self, raw_data_path, training_data_path, filenames, height, width,
                 no_depth_mask=False, is_train=False, seed=0, **kwargs):
        super().__init__(raw_data_path, training_data_path, filenames, height, width,
                         is_train, seed)
        self.no_depth_mask = no_depth_mask

    def __getitem__(self, index):
        import cv2
        from PIL import Image

        scan, pos, cam_height, direction = self.filenames[index].split()
        do_flip, do_color_aug = self.draw_augmentations()
        td = self.training_data_path
        stem = f"{pos}_{cam_height}_{direction}"
        scan_dir = os.path.join(self.raw_data_path, scan, scan)

        image = self.load_and_resize_image(
            os.path.join(scan_dir, "matterport_color_images",
                         f"{pos}_i{cam_height}_{direction}.jpg"), do_flip)

        depth = np.array(self.load_and_resize_image(
            os.path.join(scan_dir, "matterport_depth_images",
                         f"{pos}_d{cam_height}_{direction}.png"),
            do_flip, method=Image.NEAREST,
        )).astype(np.float64) * self.DEPTH_SCALING

        visible_ground = self.load_and_resize_npy(
            os.path.join(td, "ground_seg", scan, "data", stem + ".npy"),
            do_flip, method=cv2.INTER_AREA,
        ) > self.FOOTPRINT_THRESHOLD

        ground_depth = self.load_and_resize_npy(
            os.path.join(td, "hidden_depth", scan, "data", stem + ".npy"),
            do_flip, method=cv2.INTER_AREA,
        )
        ground_depth[ground_depth == 0.1] = 0  # missing-pixel sentinel
        ground_depth = ground_depth * (ground_depth < self.MAX_HIDDEN_DEPTH)

        try:
            depth_mask = self.load_and_resize_npy(
                os.path.join(td, "depth_masks", scan, "data", stem + ".npy"), do_flip)
            depth_mask = self.filter_depth_mask(depth_mask)
        except FileNotFoundError:
            depth_mask = np.zeros_like(depth)
        if self.no_depth_mask:
            depth_mask = depth_mask * 0

        ground_depth[depth_mask.astype(bool)] = 0

        return self.preprocess(
            {
                "image": image,
                "visible_ground": visible_ground,
                "depth": depth,
                "ground_depth": ground_depth,
                "moving_object_mask": np.zeros_like(depth),
                "depth_mask": depth_mask,
            },
            do_color_aug,
        )
