"""Batched projective geometry for GT generation, in torch on the device
(counterpart of footprints_tpu/preprocessing/ground_truth_generation/
geometry.py).

  * project_to_world / project_to_camera: batched einsums over the frames
    in f32 (run after ``utils.select_device``, which turns TF32 off: a
    pixel's index is ``floor(x + 1e-3)`` of a projected coordinate, so
    TF32 would move points across pixel borders);
  * the splat is the JAX package's scatter-min spec (``_splat_one_scatter``)
    as one ``scatter_reduce_(..., "amin")`` over all frames at once (flat
    index ``n*H*W + k``): min does not depend on order, so it is
    deterministic on CUDA as on the CPU;
  * masked_median: sort with +inf padding and the mean of the two middle
    ranks, as ``np.ma.median`` (``torch.median`` returns the lower one).

``aggregate_hidden_depth`` splats the frames in chunks and takes the median
over pixel chunks.  Both are exact (the splat is per frame, the median per
pixel), and they bound the device memory of a Matterport scan of ~2000
frames.  The frame count is dynamic: no padded frames are needed.
"""

import torch

# frames projected and splatted at once, and sorted elements per median
# chunk: [FRAME_CHUNK, 4, 480*640] f32 is 315 MB; a median chunk sorts
# MEDIAN_CHUNK_ELEMENTS values (256 MB) with int64 indices (512 MB)
FRAME_CHUNK = 256
MEDIAN_CHUNK_ELEMENTS = 1 << 26


def pixel_grid(height, width, device=None):
    """[3, H*W] homogeneous pixel coordinates (x, y, 1), f32, made on
    `device` (no host copy)."""
    y, x = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=device),
                          torch.arange(width, dtype=torch.float32, device=device),
                          indexing="ij")
    return torch.stack([x, y, torch.ones_like(x)]).reshape(3, -1)


def project_to_world(depth, invK, grid=None):
    """depth [N,H,W], invK [N,4,4] -> world points [N,4,H*W].

    The 4th row is the validity mask (depth > 0).
    """
    n, h, w = depth.shape
    if grid is None:
        grid = pixel_grid(h, w, depth.device)
    rays = torch.einsum("nij,jp->nip", invK[:, :3, :3], grid)
    pts = rays * depth.reshape(n, 1, -1)
    valid = (depth.reshape(n, -1) > 0).to(pts.dtype)
    return torch.cat([pts, valid[:, None, :]], dim=1)


def project_to_camera(world_points, T, K):
    """world [N,4,P], T [N,4,4], K [N,4,4] -> cam pix [N,4,P].

    Rows 0-1: pixel xy (z-normalised); row 2: depth z; row 3: validity.
    """
    cam = torch.einsum("nij,njp->nip", K,
                       torch.einsum("nij,njp->nip", T, world_points))
    z = cam[:, 2:3]
    xy = cam[:, :2] / (z + 1e-7)
    return torch.cat([xy, cam[:, 2:]], dim=1)


def _splat_keys(cam_pix, height, width):
    """[..., 4, P] -> (flat pixel index [..., P] int64, invalid -> H*W;
    depth [..., P]).  Strict ``x > 0`` and ``y > 0``, and the 1e-3 snap
    before ``floor``, as the JAX function."""
    x, y, z = cam_pix[..., 0, :], cam_pix[..., 1, :], cam_pix[..., 2, :]
    valid = ((x > 0) & (x < width) & (y > 0) & (y < height)
             & (z > 0) & (cam_pix[..., 3, :] > 0))
    # clamp before the cast: an invalid point's coordinate may be inf or nan
    xi = torch.floor(x + 1e-3).clamp(0, width - 1).long()
    yi = torch.floor(y + 1e-3).clamp(0, height - 1).long()
    flat_idx = torch.where(valid, yi * width + xi, height * width)
    return flat_idx, z


def extract_depth_from_projections(cam_pix, height, width):
    """[N,4,P] -> [N,H,W] splatted depth images (min z per pixel, 0 where
    no point lands)."""
    n, p = cam_pix.shape[0], cam_pix.shape[-1]
    n_pix = height * width
    flat_idx, z = _splat_keys(cam_pix, height, width)
    hit = flat_idx < n_pix
    # an invalid point scatters +inf, which changes no minimum, into a slot
    # of its own frame spread by its index: one shared sentinel slot would
    # take every invalid point's atomic on the card, one after another
    spread = torch.arange(p, device=cam_pix.device) % n_pix
    frame = torch.arange(n, device=cam_pix.device)[:, None] * n_pix
    target = torch.where(hit, flat_idx, spread) + frame
    src = torch.where(hit, z, torch.inf)
    out = torch.full((n * n_pix,), torch.inf, dtype=z.dtype, device=z.device)
    out.scatter_reduce_(0, target.reshape(-1), src.reshape(-1), reduce="amin")
    out = torch.where(torch.isinf(out), 0.0, out)
    return out.reshape(n, height, width)


def masked_median(projections, min_hits=0):
    """Median over frames of the positive entries per pixel (np.ma.median:
    the mean of the two middle ranks); pixels hit by <= min_hits frames ->
    0 when min_hits > 0.  projections: [N,H,W]; the pixels are taken in
    chunks of at most MEDIAN_CHUNK_ELEMENTS sorted values."""
    n, h, w = projections.shape
    flat = projections.reshape(n, h * w)
    out = torch.empty(h * w, dtype=projections.dtype, device=projections.device)
    step = max(1, MEDIAN_CHUNK_ELEMENTS // max(n, 1))
    for s in range(0, h * w, step):
        chunk = flat[:, s:s + step]
        pos = chunk > 0
        counts = pos.sum(dim=0)
        vals = torch.where(pos, chunk, torch.inf).sort(dim=0).values
        lo_idx = ((counts - 1) // 2).clamp_min(0)
        hi_idx = (counts // 2).clamp_min(0)
        lo = vals.gather(0, lo_idx[None])[0]
        hi = vals.gather(0, hi_idx[None])[0]
        med = 0.5 * (lo + hi)
        med = torch.where(counts > 0, med, 0.0)
        med = torch.where(torch.isinf(med), 0.0, med)
        if min_hits > 0:
            med = torch.where(counts > min_hits, med, 0.0)
        out[s:s + step] = med
    return out.reshape(h, w)


def aggregate_hidden_depth(depths, poses, K, invK, *, height, width,
                           robust=True):
    """The hidden-depth pipeline for one target frame.

    depths [N,H,W] (already masked to ground pixels), poses [N,4,4]
    (relative to the target camera), K/invK [N,4,4], all f32 tensors on one
    device.  Returns the median-aggregated hidden ground depth [H,W].
    A frame whose depth is all zero adds no point, so frames may be left
    out rather than zeroed.
    """
    n = depths.shape[0]
    grid = pixel_grid(depths.shape[1], depths.shape[2], depths.device)
    projections = torch.empty((n, height, width), dtype=depths.dtype,
                              device=depths.device)
    for s in range(0, n, FRAME_CHUNK):
        e = min(n, s + FRAME_CHUNK)
        world = project_to_world(depths[s:e], invK[s:e], grid)
        cam = project_to_camera(world, poses[s:e], K[s:e])
        projections[s:e] = extract_depth_from_projections(cam, height, width)
    return masked_median(projections, min_hits=2 if robust else 0)
