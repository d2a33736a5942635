"""Tensorboard and console logging, and wall-time accounting (counterpart
of footprints_tpu/train/logger.py): lr and per-term scalars and, for up to
4 batch items, the input image, target disparity and masks, and the
full-scale predictions (disparity plasma-coloured).  matplotlib is imported
only to colour an image panel."""

import collections
import time

import numpy as np

from ..core.ops import np_sigmoid_to_depth
from ..utils import normalise_image


def _plasma(x):
    import matplotlib.pyplot as plt

    return plt.get_cmap("plasma")(normalise_image(x))[..., :3]


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def log(writer, inputs, outputs, losses, lr, step, max_images=4):
    """Write scalars and image panels for one logging event.

    inputs: dict of numpy batch arrays (NHWC image, [N,H,W] targets).
    outputs: full-scale prediction [N,H,W,4] numpy (or None to skip images).
    """
    writer.add_scalar("lr", lr, step)
    for key, val in losses.items():
        writer.add_scalar(str(key), float(val), step)

    if outputs is None or inputs is None:
        return
    for i in range(min(max_images, outputs.shape[0])):
        writer.add_image(f"image/{i}", np.transpose(inputs["image"][i], (2, 0, 1)), step)
        writer.add_image(f"target_visible_ground/{i}", inputs["visible_ground"][i][None], step)
        writer.add_image(f"target_all_ground/{i}", inputs["all_ground"][i][None], step)
        if "depth" in inputs:
            target_disp = 1.0 / np.maximum(inputs["depth"][i], 1e-3)
            writer.add_image(f"target_disp/{i}",
                             np.transpose(_plasma(target_disp), (2, 0, 1)), step)
        writer.add_image(f"pred_visible_ground/{i}", _sigmoid(outputs[i, ..., 0])[None], step)
        writer.add_image(f"pred_all_ground/{i}", _sigmoid(outputs[i, ..., 1])[None], step)
        depth = np_sigmoid_to_depth(outputs[i, ..., 2])
        writer.add_image(f"pred_disp/{i}", np.transpose(_plasma(1.0 / depth), (2, 0, 1)), step)
        hidden_depth = np_sigmoid_to_depth(outputs[i, ..., 3])
        writer.add_image(f"pred_hidden_disp/{i}",
                         np.transpose(_plasma(1.0 / hidden_depth), (2, 0, 1)), step)


class TimeLogger:
    """Wall-clock accumulators (train/val/log), reference-style printout."""

    def __init__(self):
        self.timings = collections.defaultdict(float)

    def add_time(self, timer, seconds):
        self.timings[timer] += seconds

    def print_time(self, printer=print):
        for name, total in sorted(self.timings.items()):
            printer(f"  {name}: {total:.1f}s")


class Timer:
    """Context manager feeding a TimeLogger."""

    def __init__(self, logger: TimeLogger, name: str):
        self.logger = logger
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.logger.add_time(self.name, time.time() - self.t0)
