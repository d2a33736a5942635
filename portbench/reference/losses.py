"""The plain training loss of the FootprintNetwork, written from the
reference's specification (nianticlabs/footprints ``train.py``: the
4-scale supervised loss), in plain PyTorch on NCHW maps.

Per scale, on the 4-channel prediction at full resolution:
  ch0 visible ground: BCE with logits against ``visible_ground``, mean.
  ch1 hidden ground: BCE with logits against ``all_ground`` on the labelled
      pixels (all_ground or depth_mask), times (1 - moving_object_mask),
      plus 0.25 x BCE(logit, 0) on the unlabelled pixels; mean over all.
  ch2 depth: the sigmoid disparity as depth in [0.1, 100],
      log(|depth - gt| + 1) where gt > 0, mean over all pixels.
  ch3 hidden-ground depth: the same against ``ground_depth``.
The loss is the sum of the four terms, summed over the scales and divided
by their number.
"""

import torch
import torch.nn.functional as F

MIN_DEPTH, MAX_DEPTH = 0.1, 100.0
PRIOR_WEIGHT = 0.25


def to_depth(disp):
    min_disp, max_disp = 1.0 / MAX_DEPTH, 1.0 / MIN_DEPTH
    return 1.0 / (min_disp + (max_disp - min_disp) * disp)


def depth_term(disp, gt):
    return torch.mean(torch.log((to_depth(disp) - gt).abs() + 1.0) * (gt > 0).float())


def scale_loss(pred, t):
    """pred: [N,4,H,W]; t: the target maps, each [N,H,W]."""
    bce = lambda x, y: F.binary_cross_entropy_with_logits(x, y, reduction="none")  # noqa: E731
    vis = torch.mean(bce(pred[:, 0], t["visible_ground"]))
    labelled = ((t["all_ground"] + t["depth_mask"]) > 0).float()
    hidden = (bce(pred[:, 1], t["all_ground"]) * labelled * (1.0 - t["moving_object_mask"])
              + PRIOR_WEIGHT * bce(pred[:, 1], torch.zeros_like(pred[:, 1])) * (1.0 - labelled))
    return (vis + torch.mean(hidden) + depth_term(pred[:, 2], t["depth"])
            + depth_term(pred[:, 3], t["ground_depth"]))


def total_loss(outputs, targets):
    """outputs: {scale: [N,4,H,W]} (the reference model's); the mean over
    scales of each scale's loss."""
    return sum(scale_loss(pred, targets) for pred in outputs.values()) / len(outputs)
