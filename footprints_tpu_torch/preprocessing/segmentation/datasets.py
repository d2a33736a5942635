"""Ground-segmentation datasets, the inference half (counterpart of
footprints_tpu/preprocessing/segmentation/datasets.py).

  * samples: {'image': [H,W,3] float32 in [0,1] (RGB, LANCZOS resize),
    'idx': int}
  * results: <save>/<per-dataset folder>/data/<name:010>.npy as float16,
    visualisations under <save>/<per-dataset folder>/visualisations/
  * KITTI: <data>/<seq>/image_02|03/data/<frame:010>.<ext>, saved under
    <seq>/<cam>/; Matterport: <data>/sample_dataset/v1/scans/<scan>/<scan>/
    matterport_color_images/<pos>_i<h>_<dir>.jpg, saved under <scan>/ as
    <pos>_<h>_<dir>

The training datasets (ADE20K, cityscapes, Matterport, kitti-semantics)
arrive with the segmentation-training slice.  PIL is imported where an
image is read, matplotlib where a visualisation is written.
"""

import os

import numpy as np

from ...utils import pil_loader


class SegInferenceDataset:
    def __init__(self, data_path, filenames, height, width):
        self.data_path = data_path
        self.filenames = filenames
        self.height = height
        self.width = width

    def __len__(self):
        return len(self.filenames)

    def _load_image(self, index):
        raise NotImplementedError

    def __getitem__(self, index):
        from PIL import Image

        image = self._load_image(index).resize((self.width, self.height), Image.LANCZOS)
        return {"image": np.asarray(image, np.float32)[..., :3] / 255.0,
                "idx": index}

    def _write(self, savepath, filename, prediction, visualisation=None):
        data_dir = os.path.join(savepath, "data")
        os.makedirs(data_dir, exist_ok=True)
        np.save(os.path.join(data_dir, f"{str(filename).zfill(10)}.npy"),
                np.asarray(prediction).astype(np.float16))
        if visualisation is not None:
            import matplotlib.pyplot as plt

            vis_dir = os.path.join(savepath, "visualisations")
            os.makedirs(vis_dir, exist_ok=True)
            plt.imsave(os.path.join(vis_dir, f"{str(filename).zfill(10)}.jpg"),
                       visualisation)


class KITTISegInferenceDataset(SegInferenceDataset):
    def __init__(self, data_path, filenames, height, width, image_ext="jpg"):
        super().__init__(data_path, filenames, height, width)
        self.image_ext = image_ext

    def _parse_index(self, index):
        seq, frame, side = self.filenames[index].split()
        return seq, frame, "image_02" if side == "l" else "image_03"

    def _load_image(self, index):
        seq, frame, cam = self._parse_index(index)
        return pil_loader(os.path.join(
            self.data_path, seq, cam, "data", f"{frame.zfill(10)}.{self.image_ext}"))

    def save_result(self, index, prediction, savepath, visualisation=None):
        seq, frame, cam = self._parse_index(int(index))
        self._write(os.path.join(savepath, seq, cam), frame, prediction, visualisation)


class MatterportSegInferenceDataset(SegInferenceDataset):
    def _load_image(self, index):
        scan, pos, h, d = self.filenames[index].split()
        return pil_loader(os.path.join(
            self.data_path, "sample_dataset/v1/scans", scan, scan,
            "matterport_color_images", f"{pos}_i{h}_{d}.jpg"))

    def save_result(self, index, prediction, savepath, visualisation=None):
        scan, pos, h, d = self.filenames[int(index)].split()
        self._write(os.path.join(savepath, scan), f"{pos}_{h}_{d}",
                    prediction, visualisation)


def get_dataset_class(name):
    raise NotImplementedError(
        f"the {name} segmentation training dataset is not ported yet; it "
        "arrives with the segmentation-training slice")


def get_inference_dataset_class(name):
    return {
        "kitti": KITTISegInferenceDataset,
        "matterport": MatterportSegInferenceDataset,
    }[name]
