"""Training losses (counterpart of footprints_tpu/train/losses.py), f32,
computed on the device with nothing synced to the host.

Per scale, four terms on the 4-channel prediction [N,H,W,4]:
  ch0 visible ground: BCE-with-logits against ``visible_ground``, plain mean.
  ch1 all/hidden ground: ThreeClassLoss, i.e. per-pixel BCE against
      ``all_ground`` masked to (all_ground | depth_mask), times
      (1 - moving_object_mask), plus ``prior_weight`` x BCE(pred, 0) on the
      unlabelled pixels; mean over all pixels.
  ch2 visible depth: sigmoid -> depth, log-L1 ``log(|pred - gt| + 1)``
      masked to gt > 0, mean over all pixels.
  ch3 hidden-ground depth: as ch2 against ``ground_depth``.

Keys: '<term>/<scale>' and 'loss/<scale>' per scale; 'loss' is the sum over
scales divided by their number.  Only the full-resolution form is ported:
the packed '1/1_s2d' and '1/2_s2d2' heads are not.
"""

import dataclasses

import torch

from ..core.ops import sigmoid_to_depth


@dataclasses.dataclass(frozen=True)
class LossConfig:
    min_depth: float = 0.1
    max_depth: float = 100.0
    footprint_prior_weight: float = 0.25


def bce_with_logits(logits, targets):
    """Numerically stable elementwise binary cross-entropy on logits."""
    return (logits.clamp_min(0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def supervised_depth_loss(pred_depth, target_depth, mask):
    """Mean over ALL pixels of log(|pred - gt| + 1) * mask."""
    return torch.mean(torch.log((pred_depth - target_depth).abs() + 1.0) * mask)


def three_class_loss(logits, ground_target, depth_mask, moving_mask, prior_weight):
    """Hidden-ground loss: labelled BCE plus a weighted negative prior on the
    unlabelled pixels."""
    labeled = ((ground_target + depth_mask) > 0).to(logits.dtype)
    loss = bce_with_logits(logits, ground_target) * labeled * moving_mask
    unlabeled = 1.0 - labeled
    loss = loss + prior_weight * bce_with_logits(logits, torch.zeros_like(logits)) * unlabeled
    return torch.mean(loss)


def compute_losses(predictions, targets, config: LossConfig = LossConfig()):
    """predictions: {scale: [N,H,W,4]}; targets: dict of [N,H,W] maps.
    Returns the losses dict described in the module doc."""
    valid_depth = (targets["depth"] > 0).float()
    moving_mask = 1.0 - targets["moving_object_mask"]
    valid_ground_depth = (targets["ground_depth"] > 0).float()

    losses = {}
    total = 0.0
    for scale_key, output in predictions.items():
        if scale_key in ("1/1_s2d", "1/2_s2d2"):
            raise NotImplementedError(
                f"the packed {scale_key!r} head is not ported yet; it arrives "
                "with the bf16 mixed-precision training slice")
        output = output.float()
        l_vis = torch.mean(bce_with_logits(output[..., 0], targets["visible_ground"]))
        l_all = three_class_loss(output[..., 1], targets["all_ground"],
                                 targets["depth_mask"], moving_mask,
                                 config.footprint_prior_weight)
        pred_depth = sigmoid_to_depth(output[..., 2], config.min_depth, config.max_depth)
        l_depth = supervised_depth_loss(pred_depth, targets["depth"], valid_depth)
        pred_gdepth = sigmoid_to_depth(output[..., 3], config.min_depth, config.max_depth)
        l_gdepth = supervised_depth_loss(pred_gdepth, targets["ground_depth"],
                                         valid_ground_depth)

        losses[f"visible_ground/{scale_key}"] = l_vis
        losses[f"all_ground/{scale_key}"] = l_all
        losses[f"depth/{scale_key}"] = l_depth
        losses[f"ground_depth/{scale_key}"] = l_gdepth
        scale_loss = l_vis + l_all + l_depth + l_gdepth
        losses[f"loss/{scale_key}"] = scale_loss
        total = total + scale_loss

    losses["loss"] = total / len(predictions)
    return losses
