"""Numpy camera geometry for the host-side baselines (counterpart of
footprints_tpu/baselines/geometry.py)."""

import numpy as np


def norm(x):
    return x / np.sqrt((x ** 2).sum())


def generate_camera_rays(h, w, inv_K):
    """[3, h*w] ray directions through every pixel."""
    xs, ys = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    pix = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)])
    return inv_K[:3, :3] @ pix


class BackprojectDepth:
    """Depth image -> [h*w, 3] point cloud."""

    def __init__(self, height, width):
        self.height = height
        self.width = width
        xs, ys = np.meshgrid(range(width), range(height), indexing="xy")
        self.pix_coords = np.stack(
            [xs.ravel(), ys.ravel(), np.ones(height * width)])

    def __call__(self, depth, inv_K):
        cam_points = inv_K[:3, :3] @ self.pix_coords
        return (depth.reshape(1, -1) * cam_points).T


class Project3D:
    """[4/3, P] world points -> [2, P] pixel coordinates."""

    def __init__(self, height, width, eps=1e-7):
        self.height = height
        self.width = width
        self.eps = eps

    def __call__(self, points, K, T):
        P = (K @ T)[:3, :]
        cam = P @ points
        return cam[:2] / (cam[2, None, :] + self.eps)
