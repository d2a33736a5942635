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


def s2d_pack(x):
    """[N,H,W,C] -> [N,H/2,W/2,4C], channel-major space-to-depth: lane
    ``4c + 2a + b`` holds ``x[:, 2i + a, 2j + b, c]`` (torch's
    ``pixel_unshuffle(2)`` order).  The layout of the packed '1/1_s2d'
    training head and its '@s2d' targets (footprints_tpu/train/losses.py:
    s2d_map, per channel)."""
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4).reshape(
        n, h // 2, w // 2, 4 * c)


def p4_pack(x):
    """[N,H,W,C] -> [N,H/4,W/4,16C], the period-4 pack: lane
    ``16c + 4(2a + b) + (2alpha + beta)`` holds
    ``x[:, 4i + 2alpha + a, 4j + 2beta + b, c]``.  The low phase bits form
    the outer lane group, so this is not ``pixel_unshuffle(4)``'s order.
    The layout of the packed '1/2_s2d2' training head and its '@s2d2'
    targets (footprints_tpu/train/losses.py:p4_map, per channel)."""
    n, h, w, c = x.shape
    return x.reshape(n, h // 4, 2, 2, w // 4, 2, 2, c).permute(
        0, 1, 4, 7, 3, 6, 2, 5).reshape(n, h // 4, w // 4, 16 * c)


def s2d_map(t):
    """[N,H,W] target map -> [N,H/2,W/2,4], phase (a, b) at lane 2a + b."""
    return s2d_pack(t[..., None])


def p4_map(t):
    """[N,H,W] target map -> [N,H/4,W/4,16], the period-4 pack (lane
    4(2a + b) + (2alpha + beta) holds row 4i + 2alpha + a)."""
    return p4_pack(t[..., None])
