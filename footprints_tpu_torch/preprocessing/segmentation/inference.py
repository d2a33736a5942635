"""Segmentation Tester (counterpart of
footprints_tpu/preprocessing/segmentation/inference.py): runs the Segmentor
over the sorted train+val split and writes the ``ground_seg`` float16 npy
tree that GT generation and the main training read, one [1,H,W] map of
sigmoid(full-scale logit) per image.

The dump loop is the batch inference's (``eval/inference.py:
dump_predictions``): padded tail batch, and with ``overlap=True`` the card
computes batch n+1 while the host saves batch n.
"""

import os

import numpy as np
import torch

from ...checkpoint import load_checkpoint
from ...convert import segmentor_state_dict_from_jax_params
from ...core.config import load_config, readlines
from ...data.loader import DataLoader
from ...eval.inference import dump_predictions
from ...models import Segmentor
from ...utils import select_device
from .datasets import get_inference_dataset_class


def load_segmentor_weights(net, load_path):
    """Load ``net``'s weights from a reference state_dict ``.pth``
    (epoch_<n>.pth), a directory holding ``checkpoint.npz``, or the ``.npz``
    itself (the JAX package's layout, mapped through ``convert``)."""
    if load_path.endswith(".pth"):
        sd = torch.load(load_path, map_location="cpu", weights_only=True)
    else:
        ckpt = load_path if load_path.endswith(".npz") else os.path.join(
            load_path, "checkpoint.npz")
        loaded = load_checkpoint(ckpt)
        sd = segmentor_state_dict_from_jax_params(
            loaded["params"], loaded["state"], depth=net.depth, use_psp=net.use_psp)
    net.load_state_dict(sd, strict=True)


class Tester:
    def __init__(self, options):
        print("setting up...")
        self.opt = options
        self.device = select_device(getattr(self.opt, "device", "cuda"))
        self.net = Segmentor(depth=getattr(self.opt, "encoder_depth", 34),
                             use_psp=not self.opt.no_PSP, device=self.device).eval()
        load_segmentor_weights(self.net, self.opt.load_path)
        self.loader, self.dataset, self.save_path = self.create_dataloaders()

    def create_dataloaders(self):
        """(loader, dataset, save path) over the sorted train+val split."""
        path_data = load_config(self.opt.config_path)[self.opt.test_data_type]
        save_path = os.path.join(path_data["training_data"], self.opt.test_save_folder)
        split_root = getattr(self.opt, "split_root", "splits")
        filenames = []
        for textfile in ["train.txt", "val.txt"]:
            filenames += readlines(os.path.join(
                split_root, self.opt.test_data_type, textfile))
        filenames = sorted(filenames)

        dataset = get_inference_dataset_class(self.opt.test_data_type)(
            path_data["dataset"], filenames, self.opt.height, self.opt.width)
        loader = DataLoader(dataset, self.opt.batch_size, shuffle=False,
                            drop_last=False, num_workers=self.opt.num_workers)
        return loader, dataset, save_path

    def forward(self, images):
        """[B,H,W,3] -> [B,H,W] float16 on the device: sigmoid of the
        full-scale logits (the other heads are not computed)."""
        logits = self.net(images, scales=("1/1",))[0]
        return torch.sigmoid(logits[..., 0]).to(torch.float16)

    def test(self, overlap=True):
        """Dump ground_seg predictions over train+val; returns the image
        count.  ``overlap``: see ``dump_predictions``."""
        print("running inference...")

        def save_batch(writer, inputs, preds):
            for i, pred in enumerate(preds):
                viz = None
                if self.opt.save_test_visualisations:
                    import matplotlib.pyplot as plt

                    viz = np.concatenate(
                        [inputs["image"][i],
                         plt.get_cmap("plasma")(pred.astype(np.float32))[..., :3]], axis=1)
                # saved as [1,H,W], the reference artifact's shape
                writer.submit(self.dataset.save_result, inputs["idx"][i], pred[None],
                              self.save_path, viz)

        count = dump_predictions(self.loader, self.forward, save_batch,
                                 batch_size=self.opt.batch_size, device=self.device,
                                 overlap=overlap)
        print(f"finished testing! ({count} images)")
        return count
