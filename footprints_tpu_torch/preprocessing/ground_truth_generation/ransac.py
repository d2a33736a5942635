"""RANSAC plane fitting, all hypotheses at once (counterpart of
footprints_tpu/preprocessing/ground_truth_generation/ransac.py).

  * [n_iters, 3] point triplets, drawn uniformly with replacement over the
    valid points, or given by the caller (``idx``);
  * a plane through 3 points is the cross-product normal;
  * every point is scored against every hypothesis in one [I,3]x[3,P]
    matmul, and ``torch.argmax`` (the first maximum, as ``jnp.argmax``)
    picks the winner; degenerate hypotheses (normal norm <= 1e-8) never win.

The JAX function draws its triplets with ``jax.random.gumbel``, which torch
cannot reproduce: without ``idx`` the port draws from a ``torch.Generator``,
so the two agree in distribution, not pixel for pixel.  Given the same
``idx`` they pick the same hypothesis.

``np_fit_plane`` / ``np_plane_distance`` are the numpy twins the host-side
baselines use, copied.
"""

import numpy as np
import torch

DEFAULT_ITERS = 100
DEFAULT_THRESHOLD = 0.05


def draw_triplets(mask, n_iters, generator=None):
    """[n_iters, 3] indices drawn uniformly, with replacement, over the
    points where ``mask`` is set.  With no valid point the draw is uniform
    over all points (``torch.multinomial`` refuses all-zero weights); the
    caller's result is then discarded by its own count check."""
    weights = mask.to(torch.float32)
    weights = weights + (weights.sum() == 0).to(weights.dtype)
    idx = torch.multinomial(weights, 3 * n_iters, replacement=True,
                            generator=generator)
    return idx.reshape(n_iters, 3)


def _planes_from_triplets(t):
    """t [I,3,3] -> plane coeffs [I,4] (a,b,c,d) with ax+by+cz+d=0."""
    n = torch.linalg.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0], dim=-1)
    d = -(n * t[:, 0]).sum(dim=-1)
    return torch.cat([n, d[:, None]], dim=1)


def fit_plane_masked(points, mask, idx=None, generator=None,
                     n_iters=DEFAULT_ITERS, threshold=DEFAULT_THRESHOLD):
    """Fit a plane to ``points[mask]``.

    points [P,3], mask [P] bool; idx [n_iters,3] triplet indices, or None
    to draw them from ``generator``.  Returns (coeffs [4], inlier_count,
    inlier_mask [P]) as tensors on the points' device; no host sync.
    """
    valid = mask > 0
    if idx is None:
        idx = draw_triplets(valid, n_iters, generator)
    coeffs = _planes_from_triplets(points[idx])  # [I,4]
    norms = torch.linalg.vector_norm(coeffs[:, :3], dim=-1, keepdim=True)
    dists = (coeffs[:, :3] @ points.T + coeffs[:, 3:4]).abs() / (norms + 1e-12)
    inliers = (dists < threshold) & valid[None, :]
    counts = inliers.sum(dim=1)
    counts = torch.where(norms[:, 0] > 1e-8, counts, 0)
    best = torch.argmax(counts)
    return coeffs[best], counts[best], inliers[best]


def plane_distance(coeffs, points):
    """Signed distances of points [P,3] to plane coeffs [4]."""
    n = torch.linalg.vector_norm(coeffs[:3])
    return (points @ coeffs[:3] + coeffs[3]) / (n + 1e-12)


# numpy twin (host-side baselines; same hypothesis->score->argmax semantics)

def np_fit_plane(points, n_iters=DEFAULT_ITERS, threshold=DEFAULT_THRESHOLD,
                 seed=10):
    """points [P,3] -> (coeffs [4], inlier_count, inlier_mask [P])."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(points.shape[0], size=(n_iters, 3))
    triplets = points[idx]
    n = np.cross(triplets[:, 1] - triplets[:, 0], triplets[:, 2] - triplets[:, 0])
    d = -np.einsum("ic,ic->i", n, triplets[:, 0])
    coeffs = np.concatenate([n, d[:, None]], axis=1)
    norms = np.linalg.norm(coeffs[:, :3], axis=-1, keepdims=True)
    dists = np.abs(coeffs[:, :3] @ points.T + coeffs[:, 3:4]) / (norms + 1e-12)
    inliers = dists < threshold
    counts = inliers.sum(axis=1)
    counts[norms[:, 0] <= 1e-8] = 0  # degenerate hypotheses never win
    best = int(np.argmax(counts))
    return coeffs[best], int(counts[best]), inliers[best]


def np_plane_distance(coeffs, points):
    n = np.linalg.norm(coeffs[:3])
    return (points @ coeffs[:3] + coeffs[3]) / (n + 1e-12)
