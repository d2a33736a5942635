"""Numeric primitives (counterpart of footprints_tpu/core/ops.py); the
``np_`` functions are numpy twins for host-side code.

The network's depth channels are "sigmoid disparities" in [0, 1], mapped
affinely onto [1/max_depth, 1/min_depth] and inverted to metric depth.
"""

import numpy as np


def sigmoid_to_depth(disp, min_depth: float = 0.1, max_depth: float = 100.0):
    """Convert a sigmoid-disparity tensor in [0, 1] to metric depth.

    depth = 1 / (1/max_depth + (1/min_depth - 1/max_depth) * disp)
    """
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    return 1.0 / (min_disp + (max_disp - min_disp) * disp)


def np_sigmoid_to_depth(disp, min_depth: float = 0.1, max_depth: float = 100.0):
    """Numpy twin of ``sigmoid_to_depth`` for host-side code."""
    return sigmoid_to_depth(np.asarray(disp), min_depth, max_depth)


def np_pixel_disp_to_depth(disp, focal_length: float, baseline: float):
    """Stereo pixel disparity -> metric depth.  Zero disparity gives depth 0
    (the -1 denominator makes it negative) and negative depths clamp to 0."""
    disp = np.asarray(disp)
    safe = disp - (disp == 0)
    depth = focal_length * baseline / safe
    depth[depth < 0] = 0
    return depth
