"""Base training dataset: per-sample loading and preprocessing on the host,
numpy only (counterpart of footprints_tpu/data/base.py).

  * images load with PIL and resize with LANCZOS to (width, height), in
    the native resampler with FOOTPRINTS_NATIVE_RESIZE=1;
  * npy targets resize with cv2 (INTER_NEAREST or INTER_AREA per target),
    with an optional horizontal flip and disparity rescale by width ratio;
  * at train time each sample draws a 50% h-flip and a 50% colour jitter
    from the dataset's own ``np.random.default_rng(seed)``, in the JAX
    package's order, so one seed draws the same augmentations;
  * ``all_ground`` = (ground_depth + visible_ground) > 0;
  * depth masks drop connected components >= 1% of the image area.

Samples are dicts of float32 arrays; the image is [H,W,3] in [0,1].  PIL
and cv2 are imported where they are used.
"""

import os

import numpy as np

from ..core.labels import filter_small_components
from .augment import color_jitter


class FootprintsDataset:
    def __init__(self, raw_data_path, training_data_path, filenames, height, width,
                 is_train=False, seed=0):
        self.raw_data_path = raw_data_path
        self.training_data_path = training_data_path
        self.filenames = filenames
        self.height = height
        self.width = width
        self.is_train = is_train
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.filenames)

    def __getitem__(self, index):
        raise NotImplementedError

    # -- shared loading helpers ------------------------------------------------

    def load_and_resize_image(self, path, do_flip, method=None):
        """``method``: a PIL resampling filter, LANCZOS by default.

        With ``FOOTPRINTS_NATIVE_RESIZE=1`` the LANCZOS resize runs in the
        native resampler (native/fp_image.cpp, equal to PIL's byte for
        byte); PIL still decodes and flips.  Where that library cannot be
        built or loaded this raises, where the JAX package uses PIL."""
        from PIL import Image

        if method is None and os.environ.get("FOOTPRINTS_NATIVE_RESIZE") == "1":
            from .. import native

            arr = np.asarray(Image.open(path).convert("RGB"))
            image = Image.fromarray(native.resize_lanczos(arr, self.height, self.width))
            if do_flip:
                image = image.transpose(method=Image.FLIP_LEFT_RIGHT)
            return image
        image = Image.open(path).resize(
            (self.width, self.height),
            resample=Image.LANCZOS if method is None else method)
        if do_flip:
            image = image.transpose(method=Image.FLIP_LEFT_RIGHT)
        return image

    def load_and_resize_npy(self, path, do_flip, rescale=False, method=None):
        """``method``: a cv2 interpolation flag, INTER_NEAREST by default."""
        import cv2

        npy = np.load(path).astype(np.float64)
        if npy.ndim == 3:
            npy = npy[0]
        if do_flip:
            npy = np.fliplr(npy)
        multiplier = self.width / npy.shape[1] if rescale else 1.0
        interpolation = cv2.INTER_NEAREST if method is None else method
        return cv2.resize(npy, (self.width, self.height),
                          interpolation=interpolation) * multiplier

    def filter_depth_mask(self, depth_mask):
        return filter_small_components(depth_mask, self.width * self.height / 100)

    # -- preprocessing ---------------------------------------------------------

    def draw_augmentations(self):
        """(do_flip, do_color_aug) for this sample; train-time only."""
        if not self.is_train:
            return False, False
        return bool(self._rng.random() > 0.5), bool(self._rng.random() > 0.5)

    def preprocess(self, inputs, do_color_aug):
        """Jitter, to float, and derive all_ground.  inputs['image'] is PIL."""
        image = inputs["image"]
        if do_color_aug:
            image = color_jitter(image, self._rng)
        arr = np.asarray(image, dtype=np.float32) / 255.0
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=-1)
        out = {"image": np.ascontiguousarray(arr[..., :3])}
        for key, val in inputs.items():
            if key != "image":
                out[key] = np.asarray(val, dtype=np.float32)
        out["all_ground"] = (
            (out["ground_depth"] + out["visible_ground"]) > 0
        ).astype(np.float32)
        return out
