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
scales divided by their number.

Every term is a mean over all the pixels it is given.  Sharded over a mesh
(the batch over data, the rows over spatial: parallel/mesh.py), each rank's
term is its shard's sum over its count, and the shards are equal, so the
global term, the global sum over the global count, is the mean of the
ranks' terms: the eval step takes it with one all-reduce
(parallel/mesh.py:mean_over_ranks).

The packed training heads (models/footprint.py) arrive as '1/1_s2d'
[N,H/2,W/2,16] and '1/2_s2d2' [N,H/4,W/4,64], contract channel c at lanes
``width*c .. width*c + width - 1`` (width 4 and 16).  Each term is pixelwise
and then averaged, so it is scored against the targets packed the same way:
the batch's '<name>@s2d' / '<name>@s2d2' keys (data/compact.py), else packed
here.  The same numbers up to the order of the sums; the keys stay
'<term>/1/1' and '<term>/1/2'.
"""

import dataclasses

import torch

from ..core.ops import p4_map, s2d_map, sigmoid_to_depth

# the target maps of the loss, which the packed heads score packed
TARGET_KEYS = ("visible_ground", "all_ground", "depth", "ground_depth",
               "depth_mask", "moving_object_mask")


@dataclasses.dataclass(frozen=True)
class LossConfig:
    min_depth: float = 0.1
    max_depth: float = 100.0
    footprint_prior_weight: float = 0.25


def bce_with_logits(logits, targets):
    """Numerically stable elementwise binary cross-entropy on logits.

    Its gradient is sigmoid(x) - t everywhere, also at a logit of exactly 0:
    ``torch.maximum`` splits a tie's gradient in halves, where ``clamp_min``
    would give the tie all of it (1 - t).  bf16 logits are exactly 0 at a
    fraction of the pixels where a bias cancels a conv's rounded output, and
    there that gradient would be off by 0.5 (the JAX function gives -t
    there: ``jnp.maximum``'s half is cancelled by ``jnp.abs``'s subgradient
    of 1 at 0, where ``torch.abs``'s is 0)."""
    return (torch.maximum(logits, logits.new_zeros(())) - logits * targets
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


# packed head key -> (standard scale key, target key suffix, lanes per
# channel, the pack of a target map)
PACKED_HEADS = {"1/1_s2d": ("1/1", "@s2d", 4, s2d_map),
                "1/2_s2d2": ("1/2", "@s2d2", 16, p4_map)}


def compute_losses(predictions, targets, config: LossConfig = LossConfig()):
    """predictions: {scale: [N,H,W,4]}, or a packed head (module doc);
    targets: dict of [N,H,W] maps, and optionally their packs.
    Returns the losses dict described in the module doc."""
    losses = {}
    total = 0.0
    for scale_key, output in predictions.items():
        output = output.float()
        if scale_key in PACKED_HEADS:
            scale_key, suffix, width, pack = PACKED_HEADS[scale_key]
            t = {k: targets[k + suffix] if k + suffix in targets
                 else pack(targets[k]) for k in TARGET_KEYS}
            ch = [output[..., width * c:width * (c + 1)] for c in range(4)]
        else:
            t, ch = targets, output.unbind(-1)
        l_vis = torch.mean(bce_with_logits(ch[0], t["visible_ground"]))
        l_all = three_class_loss(ch[1], t["all_ground"], t["depth_mask"],
                                 1.0 - t["moving_object_mask"],
                                 config.footprint_prior_weight)
        pred_depth = sigmoid_to_depth(ch[2], config.min_depth, config.max_depth)
        l_depth = supervised_depth_loss(pred_depth, t["depth"], (t["depth"] > 0).float())
        pred_gdepth = sigmoid_to_depth(ch[3], config.min_depth, config.max_depth)
        l_gdepth = supervised_depth_loss(pred_gdepth, t["ground_depth"],
                                         (t["ground_depth"] > 0).float())

        losses[f"visible_ground/{scale_key}"] = l_vis
        losses[f"all_ground/{scale_key}"] = l_all
        losses[f"depth/{scale_key}"] = l_depth
        losses[f"ground_depth/{scale_key}"] = l_gdepth
        scale_loss = l_vis + l_all + l_depth + l_gdepth
        losses[f"loss/{scale_key}"] = scale_loss
        total = total + scale_loss

    losses["loss"] = total / len(predictions)
    return losses
