"""Batch test-split inference (counterpart of footprints_tpu/eval/inference.py).

Writes one float16 ``.npy`` per image, channels-first [4,H,W] with the
sigmoid applied to the two mask channels (predict_simple deliberately does
not: the reference's two paths differ and the port keeps both), into
``<load_path>/<data_type>_predictions`` by default.

``dump_predictions`` is the dump loop, shared with the segmentation
Tester: the tail batch is padded to the batch size, and with
``overlap=True`` the card computes batch n+1 while the host saves batch n.
"""

import os

import numpy as np
import torch

from ..core.config import load_config, readlines
from ..data import DataLoader, get_inference_dataset_class
from ..data.loader import BackgroundWriter
from ..model_manager import ModelManager
from ..telemetry import span


def pad_batch(images, batch_size):
    """Zero-pad a [n,H,W,3] batch to ``batch_size`` rows.  In eval mode the
    rows are independent, so padding changes no real row; it keeps one
    batch shape, on which cuDNN's choice of algorithm depends."""
    n = images.shape[0]
    if n < batch_size:
        pad = np.zeros((batch_size - n,) + images.shape[1:], images.dtype)
        images = np.concatenate([images, pad])
    return images


def dump_predictions(loader, forward, save_batch, *, batch_size, device, overlap=True):
    """Run ``forward`` over every batch of ``loader`` and pass each batch's
    predictions to ``save_batch(writer, inputs, preds)``, which queues the
    saves on a ``BackgroundWriter``.

    ``forward`` maps a [B,H,W,3] f32 tensor on ``device`` to a tensor on
    ``device`` whose first dim is the batch; it runs under
    ``torch.inference_mode()``.  ``preds`` is numpy with the padded rows
    dropped.  Returns the number of images dumped.

    On CUDA each batch goes up from pinned memory and its predictions come
    back into pinned memory with ``non_blocking=True``, followed by an
    event.  With ``overlap=True`` batch n+1's copy and forward are queued
    before the host waits on batch n's event, so the card computes n+1
    while the host saves n; ``overlap=False`` waits for each batch before
    queueing the next (the serial order, for measurement).  The order of the
    work on the card is the same, so both write the same bytes.

    Spans (telemetry.py), each with the batch's number as its unit:
    ``dump.submit`` (pad, pin, upload, the forward and the copy back
    queued, the event recorded), ``dump.wait`` (the wait on the event) and
    ``dump.save`` (``save_batch``, blocking on a full queue included); the
    writer's thread records ``writer.write`` for each save.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"

    def submit(unit, inputs):
        with span("dump.submit", unit=unit):
            x = torch.from_numpy(np.ascontiguousarray(pad_batch(inputs["image"], batch_size)))
            if cuda:
                x = x.pin_memory()
            with torch.inference_mode():
                preds = forward(x.to(device, non_blocking=True))
            if not cuda:
                return unit, preds, None, x, inputs
            host = torch.empty(preds.shape, dtype=preds.dtype, pin_memory=True)
            host.copy_(preds, non_blocking=True)
            done = torch.cuda.current_stream(device).record_event()
        # x and host ride along until `done` has been waited on: a pinned
        # buffer freed and reused while its copy is in flight would ship
        # another batch's bytes
        return unit, host, done, x, inputs

    def drain(writer, unit, host, done, x, inputs):
        with span("dump.wait", unit=unit):
            if done is not None:
                done.synchronize()
        with span("dump.save", unit=unit):
            save_batch(writer, inputs, host.numpy()[:len(inputs["idx"])])

    count = 0
    with BackgroundWriter() as writer:
        pending = None
        for unit, inputs in enumerate(loader):
            count += len(inputs["idx"])
            nxt = submit(unit, inputs)
            if not overlap:
                drain(writer, *nxt)
                continue
            if pending is not None:
                drain(writer, *pending)
            pending = nxt
        if pending is not None:
            drain(writer, *pending)
    return count


class InferenceManager:
    def __init__(self, options):
        print("---------------\nsetting up...")
        self.opt = options

        if self.opt.inference_save_path is None:
            self.savepath = os.path.join(
                self.opt.load_path, f"{self.opt.inference_data_type}_predictions")
        else:
            self.savepath = self.opt.inference_save_path
        print(f"saving output to {self.savepath}")

        self.model_manager = ModelManager(
            is_inference=True, depth=getattr(self.opt, "encoder_depth", 34),
            device=getattr(self.opt, "device", "cuda"))
        self.device = self.model_manager.device
        self.model_manager.load_model(weights_path=self.opt.load_path)
        print("models done!")

        self.loader, self.dataset = self.create_dataloaders()
        print("inference setup complete!\n---------------")

    def forward(self, images):
        """[B,H,W,3] -> [B,4,H,W] float16 on the device: the '1/1' head
        with the sigmoid on channels 0-1, cast on the device so the host
        fetches half the bytes."""
        pred = self.model_manager.net(images, scales=("1/1",))["1/1"].permute(0, 3, 1, 2)
        pred = torch.cat([torch.sigmoid(pred[:, :2]), pred[:, 2:]], 1)
        return pred.to(torch.float16).contiguous()

    def create_dataloaders(self):
        name = self.opt.inference_data_type
        raw_data_path = load_config(self.opt.config_path)[name]["dataset"]
        split_root = getattr(self.opt, "split_root", "splits")
        test_files = readlines(os.path.join(split_root, name, "test.txt"))
        dataset = get_inference_dataset_class(name)(
            raw_data_path, test_files, self.opt.height, self.opt.width)
        loader = DataLoader(dataset, self.opt.batch_size, shuffle=False,
                            num_workers=self.opt.num_workers, drop_last=False)
        return loader, dataset

    def run(self, overlap=True):
        """Dump predictions for the test split; returns the image count.
        ``overlap``: see ``dump_predictions``."""
        print("running inference...")

        def save_batch(writer, inputs, preds):
            visualisations = (self._make_visualisations(inputs["image"], preds)
                              if self.opt.save_test_visualisations
                              else [None] * len(preds))
            for i, pred in enumerate(preds):
                writer.submit(self.dataset.save_result, inputs["idx"][i], pred,
                              self.savepath, visualisations[i])

        count = dump_predictions(self.loader, self.forward, save_batch,
                                 batch_size=self.opt.batch_size, device=self.device,
                                 overlap=overlap)
        print(f"finished testing! ({count} images)")
        return count

    @staticmethod
    def _make_visualisations(images, preds):
        import matplotlib.pyplot as plt

        colormap = plt.get_cmap("plasma")
        return [np.concatenate([image, colormap((pred[1] > 0.5).astype(float))[..., :3]],
                               axis=1)
                for image, pred in zip(images, preds)]
