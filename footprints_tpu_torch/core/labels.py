"""Connected-component filtering of the depth masks (counterpart of
footprints_tpu/core/labels.py).  scipy.ndimage.label is 4-connected by
default; the full 3x3 structure makes it 8-connected, as skimage's
``measure.label`` is in 2-D."""

import numpy as np
import scipy.ndimage

_EIGHT_CONNECTED = np.ones((3, 3), dtype=bool)


def filter_small_components(mask, max_area):
    """Keep only the 8-connected components with area < max_area, as a 0/1
    mask of ``mask``'s dtype (the reference drops components >= 1% of the
    image)."""
    mask = np.asarray(mask)
    labeled, n = scipy.ndimage.label(mask != 0, structure=_EIGHT_CONNECTED)
    if n == 0:
        return np.zeros_like(mask)
    areas = scipy.ndimage.sum_labels(np.ones_like(labeled), labeled, range(1, n + 1))
    keep = np.concatenate([[False], areas < max_area])  # index 0 = background
    return keep[labeled].astype(mask.dtype)
