"""Photometric augmentation (counterpart of footprints_tpu/data/augment.py):
colour jitter with the reference's ranges (brightness, contrast and
saturation in [0.8, 1.2], hue in [-0.1, 0.1]) on PIL images with
ImageEnhance, in a random order per sample.  The draws from ``rng`` are the
JAX package's, in its order, so one seed gives the same jitter.  PIL is
imported where it is used."""

import numpy as np


def color_jitter(image, rng: np.random.Generator,
                 brightness=(0.8, 1.2), contrast=(0.8, 1.2),
                 saturation=(0.8, 1.2), hue=(-0.1, 0.1)):
    """Random-order brightness/contrast/saturation/hue jitter on a PIL image."""
    from PIL import ImageEnhance

    ops = []
    b = rng.uniform(*brightness)
    ops.append(lambda im: ImageEnhance.Brightness(im).enhance(b))
    c = rng.uniform(*contrast)
    ops.append(lambda im: ImageEnhance.Contrast(im).enhance(c))
    s = rng.uniform(*saturation)
    ops.append(lambda im: ImageEnhance.Color(im).enhance(s))
    h = rng.uniform(*hue)
    ops.append(lambda im: _shift_hue(im, h))
    for i in rng.permutation(4):
        image = ops[i](image)
    return image


def _shift_hue(image, hue_factor: float):
    """Shift hue by hue_factor (a fraction of the full hue circle)."""
    from PIL import Image

    if image.mode != "RGB":
        return image
    if int(hue_factor * 255) == 0:
        # the quantised shift is a no-op: skip the lossy RGB->HSV->RGB trip
        return image
    hsv = np.array(image.convert("HSV"), dtype=np.uint8)
    shift = (np.uint8(int(hue_factor * 255)) if hue_factor >= 0
             else np.uint8(256 + int(hue_factor * 255)))
    hsv[..., 0] = (hsv[..., 0].astype(np.int16) + np.int16(shift)) % 256
    return Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")
