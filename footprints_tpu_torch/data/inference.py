"""Test-split inference datasets and their result writers (counterpart of
footprints_tpu/data/inference.py).

  * samples: {'image': [H,W,3] float32 in [0,1] (LANCZOS resize), 'idx': int}
  * results are saved as float16 ``.npy``, with an optional jpg
    visualisation beside each
  * KITTI names a result by its zero-padded index ("000.npy"); Matterport
    nests one folder per scan with "<pos>_<height>_<dir>.npy"

PIL is imported where an image is read, matplotlib where a visualisation
is written.
"""

import os

import numpy as np


class InferenceDataset:
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
        arr = np.asarray(image, dtype=np.float32) / 255.0
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=-1)
        return {"image": np.ascontiguousarray(arr[..., :3]), "idx": index}

    def _write(self, savepath, filename, prediction, visualisation=None):
        os.makedirs(savepath, exist_ok=True)
        np.save(os.path.join(savepath, f"{filename}.npy"),
                np.asarray(prediction).astype(np.float16))
        if visualisation is not None:
            import matplotlib.pyplot as plt

            plt.imsave(os.path.join(savepath, f"{filename}.jpg"), visualisation)


class KITTIInferenceDataset(InferenceDataset):
    def __init__(self, data_path, filenames, height, width, image_ext="jpg", **kwargs):
        super().__init__(data_path, filenames, height, width)
        self.image_ext = image_ext

    def _load_image(self, index):
        from PIL import Image

        seq, frame, side = self.filenames[index].split()
        cam = "image_02" if side == "l" else "image_03"
        return Image.open(os.path.join(
            self.data_path, seq, cam, "data", f"{frame.zfill(10)}.{self.image_ext}"))

    def save_result(self, index, prediction, savepath, visualisation=None):
        self._write(savepath, str(int(index)).zfill(3), prediction, visualisation)


class MatterportInferenceDataset(InferenceDataset):
    def __init__(self, data_path, filenames, height, width, **kwargs):
        super().__init__(data_path, filenames, height, width)

    def _load_image(self, index):
        from PIL import Image

        scan, pos, h, direction = self.filenames[index].split()
        return Image.open(os.path.join(
            self.data_path, scan, scan, "matterport_color_images",
            f"{pos}_i{h}_{direction}.jpg"))

    def save_result(self, index, prediction, savepath, visualisation=None):
        scan, pos, h, direction = self.filenames[int(index)].split()
        self._write(os.path.join(savepath, scan), f"{pos}_{h}_{direction}",
                    prediction, visualisation)
