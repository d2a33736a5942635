"""Segmentation loss (counterpart of
footprints_tpu/preprocessing/segmentation/losses.py), f32 on the device.

Each of the 4 logit maps is upcast to f32 and resized bilinearly
(align_corners=False, no antialiasing: the maps are only upsampled) to the
input size; then BCE-with-logits masked by ``labelled_pix`` and normalised
per image by the labelled-pixel count (+1e-7).  The total is the mean over
the 4 scales.

Row-sharded (a spatial ``mesh``: the maps and targets are this rank's rows
of each image), the resize exchanges one halo row per seam, and each
image's masked sum and labelled count are summed over the spatial group
before the division: the per-image normalisation of the whole image.  That
sum is differentiable, and its adjoint sums the cotangents of the k
spatial ranks, each of which holds the whole per-image loss: so the ranks'
gradients sum to k times the data group's, and the world mean of
``all_reduce_gradients`` is the global loss's gradient (train/step.py).
"""

import torch
import torch.nn.functional as F

from ...nn.layers import all_reduce_sum
from ...parallel.halo import exchange_rows, seam_rows
from ...train.losses import bce_with_logits


def upsample_to(x, height, width, mesh=None):
    """NHWC [N,h,w,C] -> [N,height,width,C], bilinear, half-pixel centres.
    On a row shard (spatial ``mesh``), ``height`` is this rank's rows: the
    map is resized with one neighbour row per seam (none when ``height`` is
    ``h``, where the resize reads each row alone) and cropped, the
    unsharded rows bit for bit (nn/layers.py:upsample_bilinear)."""
    x = x.permute(0, 3, 1, 2)
    if mesh is None:
        y = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False)
        return y.permute(0, 2, 3, 1)
    scale, halo = height // x.shape[2], (0, 0)
    if scale > 1:
        halo = seam_rows(mesh, 1, 1)
        x = exchange_rows(x, 1, 1, mesh)
    y = F.interpolate(x, size=(x.shape[2] * scale, width), mode="bilinear",
                      align_corners=False)
    return y[:, :, scale * halo[0]:y.shape[2] - scale * halo[1]].permute(0, 2, 3, 1)


def compute_seg_losses(outputs, ground_mask, labelled_pix, mesh=None):
    """outputs: list of 4 [N,h_s,w_s,1] logit maps; targets [N,H,W]; with a
    spatial ``mesh``, this rank's rows of each (module doc).

    Returns a dict with per-scale 'ground_loss_<s>' and the scalar 'loss'."""
    height, width = ground_mask.shape[1:3]
    losses = {}
    total = 0.0
    valid = labelled_pix.sum((1, 2))
    sums = [(bce_with_logits(upsample_to(out.float(), height, width, mesh)[..., 0],
                             ground_mask) * labelled_pix).sum((1, 2)) for out in outputs]
    if mesh is not None:
        valid, *sums = all_reduce_sum(torch.stack([valid, *sums]), mesh.spatial_group).unbind()
    for scale, masked in enumerate(sums):
        per_image = masked / (valid + 1e-7)
        losses[f"ground_loss_{scale}"] = per_image.mean()
        total = total + per_image.mean()
    losses["loss"] = total / len(outputs)
    return losses
