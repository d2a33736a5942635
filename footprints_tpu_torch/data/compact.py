"""Compact host->device batch encoding: ship uint8/f16, decode on the card
(counterpart of footprints_tpu/data/compact.py; ``BatchCompactor`` and
``decompact_batch_np`` are its numpy code, copied).

The f32 training batch is about 4.2 MB per image at 192x640, but the image
is uint8/255 from PIL and four of the six maps are binary, so 'exact' mode
ships them as uint8 (bitwise lossless) and 'f16' mode also ships the depth
maps as float16 (about 1e-3 relative loss, opt-in).  A map whose values are
all float16-representable ships as 'f16x', also lossless.  The per-key
scheme locks on the first batch, and the exactness guard stays live on
every batch: a strided spot check, and a full proof every
FULL_VERIFY_EVERY-th batch of a key.

``decompact_on_device`` is the torch decode: u8 image -> f32 through a
256-entry table computed on the host with numpy's IEEE divide (a device
``u8 / 255`` may multiply by the reciprocal instead, which differs by one
ulp for about half the codes), u8 and f16 maps -> f32.  So 'exact'
transport decodes bitwise equal to raw f32 transport.
"""

import numpy as np
import torch

# strided-subsample stride: a prime so the sample never aligns with image
# row/channel periodicities; samples ~0.4% of elements per batch
SPOT_STRIDE = 251
# full re-proof cadence per key under verify="strided"
FULL_VERIFY_EVERY = 64

F16_MAX = float(np.finfo(np.float16).max)


def _u8_image_exact(a):
    """uint8 encoding of a [0,1] f32 image, or None if not exactly u8/255."""
    u8 = np.rint(a * np.float32(255.0)).astype(np.uint8)
    if (u8.astype(np.float32) / np.float32(255.0) == a).all():
        return u8
    return None


def _u8_map_exact(a):
    """uint8 encoding of an integral-valued f32 map, or None."""
    u8 = a.astype(np.uint8)
    if (u8.astype(np.float32) == a).all():
        return u8
    return None


def _f16_safe(a):
    """True iff casting to f16 cannot overflow to inf (a value > 65504
    silently becoming inf is far worse than the ~1e-3 loss)."""
    return bool(np.max(np.abs(a), initial=0.0) <= F16_MAX)


def _f16_exact(a):
    """float16 encoding of an f32 array whose values are all exactly
    f16-representable, or None.  Holds for maps that originate in float16
    .npy files and only pass through value-preserving ops (NEAREST resize,
    sentinel zeroing, clipping) — e.g. the matterport hidden_depth
    (data/matterport.py); KITTI's hidden_depths go through INTER_AREA
    averaging and legitimately stay f32."""
    with np.errstate(over="ignore"):  # out-of-range probe values fail the
        f16 = a.astype(np.float16)    # equality check; the warning is noise
    if (f16.astype(np.float32) == a).all():
        return f16
    return None


class BatchCompactor:
    """Callable batch -> compact batch; locks its per-key scheme on the
    first batch it sees.  mode: 'none' | 'exact' | 'f16';
    verify: 'strided' (default) | 'always' | 'first'.

    The locked scheme is exposed as `.scheme` (key -> 'u8_image' | 'u8' |
    'f16x' | 'f16' | None) so the device decode can be driven by it instead
    of inferring encodings from dtypes (see decompact_on_device)."""

    def __init__(self, mode="exact", verify="strided"):
        if mode not in ("none", "exact", "f16"):
            raise ValueError(f"mode={mode!r}: one of none/exact/f16")
        if verify not in ("strided", "first", "always"):
            raise ValueError(f"verify={verify!r}: one of strided/first/always")
        self.mode = mode
        self.verify = verify
        # key -> 'u8_image' | 'u8' | 'f16x' | 'f16' | None; locked per key
        # on first sight (train/val batches may carry different key sets)
        self._scheme = {}
        self._seen = {}  # key -> batches encoded since lock

    @property
    def scheme(self):
        """Immutable view of the locked per-key encodings."""
        return dict(self._scheme)

    def _lock_key(self, key, a):
        enc = None
        if self.mode != "none" and a.dtype == np.float32:
            if key == "image":
                if _u8_image_exact(a) is not None:
                    enc = "u8_image"
            elif _u8_map_exact(a) is not None:
                enc = "u8"
            elif _f16_exact(a) is not None:
                # bitwise-lossless f16 transport: available even in 'exact'
                # mode because the locking batch PROVED representability
                # (and every later batch is guarded like the u8 tiers)
                enc = "f16x"
            elif self.mode == "f16" and _f16_safe(a):
                enc = "f16"
        self._scheme[key] = enc
        self._seen[key] = 0
        return enc

    def _check_level(self, key):
        """'full' | 'spot' | None for this (key, batch) under self.verify."""
        if self.verify == "always":
            return "full"
        if self.verify == "first":
            return None
        n = self._seen[key]
        return "full" if n % FULL_VERIFY_EVERY == 0 else "spot"

    def __call__(self, batch):
        out = {}
        for key, val in batch.items():
            a = np.asarray(val)
            enc = (self._scheme[key] if key in self._scheme
                   else self._lock_key(key, a))
            if enc is None:
                out[key] = val
                continue
            level = self._check_level(key)
            self._seen[key] += 1
            if enc == "u8_image":
                if level == "full":
                    u8 = _u8_image_exact(a)
                else:
                    u8 = np.rint(a * np.float32(255.0)).astype(np.uint8)
                    if level == "spot" and not (
                        u8.reshape(-1)[::SPOT_STRIDE].astype(np.float32)
                        / np.float32(255.0)
                        == a.reshape(-1)[::SPOT_STRIDE]
                    ).all():
                        u8 = None
                if u8 is None:
                    raise ValueError(
                        "image batch is no longer exactly uint8/255; "
                        "the locked 'exact' compaction would be lossy")
                out[key] = u8
            elif enc == "u8":
                if level == "full":
                    u8 = _u8_map_exact(a)
                else:
                    u8 = a.astype(np.uint8)
                    if level == "spot" and not (
                        u8.reshape(-1)[::SPOT_STRIDE].astype(np.float32)
                        == a.reshape(-1)[::SPOT_STRIDE]
                    ).all():
                        u8 = None
                if u8 is None:
                    raise ValueError(
                        f"batch[{key!r}] is no longer integral uint8; "
                        "the locked 'exact' compaction would be lossy")
                out[key] = u8
            elif enc == "f16x":
                if level == "full":
                    f16 = _f16_exact(a)
                else:
                    f16 = a.astype(np.float16)
                    if level == "spot" and not (
                        f16.reshape(-1)[::SPOT_STRIDE].astype(np.float32)
                        == a.reshape(-1)[::SPOT_STRIDE]
                    ).all():
                        f16 = None
                if f16 is None:
                    raise ValueError(
                        f"batch[{key!r}] is no longer exactly "
                        "float16-representable; the locked lossless 'f16x' "
                        "compaction would quantize")
                out[key] = f16
            elif enc == "f16":
                if level is not None:
                    sample = (a if level == "full"
                              else a.reshape(-1)[::SPOT_STRIDE])
                    if not _f16_safe(sample):
                        raise ValueError(
                            f"batch[{key!r}] exceeds float16 range; the "
                            "locked 'f16' compaction would overflow to inf")
                out[key] = a.astype(np.float16)
        return out


def decompact_batch_np(batch, scheme=None):
    """Host-side (numpy) twin of decompact_on_device, for logging/panels that
    fetch compact device batches back to the host."""
    out = {}
    for key, val in batch.items():
        a = np.asarray(val)
        enc = scheme.get(key) if scheme is not None else (
            "u8_image" if a.dtype == np.uint8 and key == "image"
            else "u8" if a.dtype == np.uint8
            else "f16" if a.dtype == np.float16 else None)
        if enc == "u8_image":
            out[key] = a.astype(np.float32) / np.float32(255.0)
        elif enc in ("u8", "f16", "f16x"):
            out[key] = a.astype(np.float32)
        else:
            out[key] = a
    return out


def decompact_batch_np(batch, scheme=None):
    """Host-side (numpy) twin of decompact_on_device, for logging/panels that
    fetch compact device batches back to the host."""
    out = {}
    for key, val in batch.items():
        a = np.asarray(val)
        enc = scheme.get(key) if scheme is not None else (
            "u8_image" if a.dtype == np.uint8 and key == "image"
            else "u8" if a.dtype == np.uint8
            else "f16" if a.dtype == np.float16 else None)
        if enc == "u8_image":
            out[key] = a.astype(np.float32) / np.float32(255.0)
        elif enc in ("u8", "f16", "f16x"):
            out[key] = a.astype(np.float32)
        else:
            out[key] = a
    return out


_IMAGE_LUT = np.arange(256, dtype=np.float32) / np.float32(255.0)


def decompact_on_device(batch, scheme=None, s2d_keys=(), p4_keys=()):
    """Torch decode of a compact batch of tensors, on their device (a no-op
    on a plain f32 batch).  With ``scheme`` (a BatchCompactor.scheme) the
    decode follows the locked encodings, so keys the compactor passed
    through keep their dtypes; without it, it infers them from dtypes.

    ``s2d_keys``/``p4_keys`` (the packed '@s2d'/'@s2d2' targets of the
    packed training heads) are not ported yet and raise."""
    if s2d_keys or p4_keys:
        raise NotImplementedError(
            "packed '@s2d'/'@s2d2' targets arrive with the packed training "
            "heads (s2d_head/p4_head), which are not ported yet")
    out = {}
    lut = None
    for key, val in batch.items():
        enc = scheme.get(key) if scheme is not None else (
            "u8_image" if val.dtype == torch.uint8 and key == "image"
            else "u8" if val.dtype == torch.uint8
            else "f16" if val.dtype == torch.float16 else None)
        if enc == "u8_image":
            if lut is None:
                lut = torch.from_numpy(_IMAGE_LUT).to(val.device)
            out[key] = lut[val.long()]
        elif enc in ("u8", "f16", "f16x"):
            out[key] = val.float()
        else:
            out[key] = val
    return out
