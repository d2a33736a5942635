"""Per-frame GT computations on the device (counterpart of
footprints_tpu/preprocessing/ground_truth_generation/processing.py).

  * compute_depth_mask: RANSAC-fit the ground plane, flatten the non-ground
    points onto it, splat each as an 8x8 grid of points +-0.1 m on the
    plane, reproject, and keep the pixels whose splat depth is within 10%
    of the visible depth and < 30 m;
  * compute_moving_object_mask: the flow that depth and the relative pose
    induce against the observed optical flow; moving where they differ by
    more than 3 px.

Point subsets are validity flags through the splat, as in the JAX
functions; nothing here syncs with the host.
"""

import numpy as np
import torch

from .geometry import (
    extract_depth_from_projections,
    pixel_grid,
    project_to_camera,
    project_to_world,
)
from .ransac import fit_plane_masked, plane_distance

SPLAT_OFFSETS = np.arange(-0.1, 0.1, 0.025, dtype=np.float32)  # 8 per axis
MAX_MASK_DEPTH = 30.0
DEPTH_AGREEMENT = 0.10
FLOW_THRESHOLD = 3.0


def compute_depth_mask(depth, ground_seg, K, invK, *, height, width,
                       footprint_threshold=0.75, idx=None, generator=None):
    """Untraversable-pixel ("definitely not ground") mask [H,W] (bool).

    depth, ground_seg [H,W]; K, invK [4,4]; f32 tensors on one device.
    ``idx`` [100,3] gives RANSAC's triplets; else they are drawn from
    ``generator`` (ransac.fit_plane_masked).
    """
    device = depth.device
    ground_pix = (ground_seg > footprint_threshold).reshape(-1)

    world4 = project_to_world(depth[None], invK[None])[0]  # [4,P]
    world = world4[:3].T  # [P,3]
    valid_depth = world4[3] > 0

    fit_mask = ground_pix & valid_depth
    coeffs, _, _ = fit_plane_masked(world, fit_mask, idx=idx, generator=generator)
    normal = coeffs[:3] / (torch.linalg.vector_norm(coeffs[:3]) + 1e-12)
    dists = plane_distance(coeffs, world)
    flattened = world - normal[None, :] * dists[:, None]

    # two in-plane axes for the splat grid; a normal along the optical axis
    # makes them zero, as in the JAX function
    z_axis = torch.eye(3, device=device)[2]
    v1 = torch.linalg.cross(normal, z_axis, dim=-1)
    v2 = torch.linalg.cross(normal, v1, dim=-1)

    offs = torch.from_numpy(SPLAT_OFFSETS).to(device)
    d1, d2 = torch.meshgrid(offs, offs, indexing="ij")
    offsets = d1.reshape(-1, 1) * v1[None] + d2.reshape(-1, 1) * v2[None]
    # [64, P, 3] -> [3, 64*P]
    pts = (flattened[None, :, :] + offsets[:, None, :]).reshape(-1, 3).T

    # only non-ground, valid-depth source pixels may splat
    src_valid = ((~ground_pix) & valid_depth).to(pts.dtype)
    valid = src_valid.repeat(offsets.shape[0])
    world_pts = torch.cat([pts, valid[None, :]], dim=0)[None]  # [1,4,64P]

    eye = torch.eye(4, dtype=pts.dtype, device=device)[None]
    cam = project_to_camera(world_pts, eye, K[None])
    projection = extract_depth_from_projections(cam, height, width)[0]

    mask = (
        (projection > 0)
        & (ground_seg < 0.5)
        & ((projection - depth).abs() / (depth + 1e-7) < DEPTH_AGREEMENT)
        & (projection < MAX_MASK_DEPTH)
        & (depth > 0)
    )
    # under-determined plane (all ground pixels in depth holes): the safe
    # all-False mask
    return mask & (fit_mask.sum() >= 3)


def compute_moving_object_mask(depth, T, K, invK, flow, *, height, width):
    """Moving-object mask [H,W] (bool): induced flow vs observed flow > 3 px.

    depth [H,W], T/K/invK [4,4], flow [2,H,W]; f32 tensors on one device.
    """
    world = project_to_world(depth[None], invK[None])
    cam = project_to_camera(world, T[None], K[None])
    grid = pixel_grid(height, width, depth.device)
    induced = cam[0, :2] - grid[:2]  # [2, P]
    diff = induced.reshape(2, height, width) - flow
    moving = torch.sqrt(diff[0] ** 2 + diff[1] ** 2) > FLOW_THRESHOLD
    # invalid depth (0) projects to garbage induced flow: never moving
    return moving & (depth > 0)
