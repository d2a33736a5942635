"""The reference side of every check: the plain model of ``reference/``
loaded with the seeded weights made again from the seed, run on the
frames made again from the seed, in blocks, after the program's state is
freed; and the numbers that compare the program's outputs with it.

``tf32=True`` computes the reference with TF32 on: the control, the
nearest precision below the configurations' f32 (TF32 off), put in the
program's place.
"""

import numpy as np
import torch

import harness
from reference.losses import total_loss


def reference_net(config, seed, device):
    net = harness.reference_model(config, "meta")
    net.load_state_dict(harness.seeded_weights(config, seed, device), assign=True)
    return net


def served_maps(config, outputs):
    """The maps the program serves, from the reference's outputs: the
    FootprintNetwork's '1/1' [n,4,H,W] with the sigmoid on the two mask
    channels (the depth channels are sigmoids already), the Segmentor's
    [n,1,H,W] sigmoid of its full-scale logit."""
    if config["model"] == "FootprintNetwork":
        full = outputs["1/1"]
        return torch.cat([torch.sigmoid(full[:, :2]), full[:, 2:]], 1)
    return torch.sigmoid(outputs[-1])


def reference_maps(config, seed, frames, block, device, tf32=False):
    """The reference's served maps of ``frames`` ([n,H,W,3] on ``device``),
    ``block`` images a forward, as f32 host arrays."""
    harness.f32_policy(tf32)
    try:
        net = reference_net(config, seed, device).eval()
        out = []
        with torch.no_grad():
            for i in range(0, len(frames), block):
                x = frames[i:i + block].permute(0, 3, 1, 2).contiguous()
                out.append(served_maps(config, net(x)).float().cpu().numpy())
        return np.concatenate(out)
    finally:
        harness.f32_policy(False)


def max_gap(got, ref):
    """Widest gap between served maps and the reference's, over all
    pixels, channels and images."""
    return float(np.max(np.abs(np.asarray(got, np.float32) - ref)))


def excess_gap(got, ref):
    """Widest gap of float16 maps from the reference's f32 maps past the
    reference's own rounding to float16: max of |got - ref| - |f16(ref) -
    ref|.  Rounding alone reads 0 where both sides round alike and under
    twice the f32 gap where they round to neighbours, so what float16 hides
    of a gap shows here."""
    got = np.asarray(got, np.float32)
    own = np.abs(ref.astype(np.float16).astype(np.float32) - ref)
    return float(np.max(np.abs(got - ref) - own))


def norm_gaps(got, ref, leaves):
    """Worst leaf of |‖got‖ - ‖ref‖| over the larger of the leaf's
    reference norm and the median leaf's reference norm."""
    median = float(np.median([ref[k] for k in leaves]))
    return max(abs(got[k] - ref[k]) / max(ref[k], median) for k in leaves)


def train_reference(config, seed, feed, steps, hyper, device, tf32=False):
    """``steps`` plain steps of the reference (train-mode BN, the plain
    4-scale loss, ``torch.optim.Adam``) from the seeded weights on
    ``feed``'s first batches.  Returns (losses, first gradient's norm by
    leaf, the change of every floating state leaf by leaf after the
    steps)."""
    harness.f32_policy(tf32)
    try:
        net = reference_net(config, seed, device).train()
        start = {k: v.detach().clone() for k, v in net.state_dict().items()
                 if v.is_floating_point()}
        opt = torch.optim.Adam(net.parameters(), lr=hyper["learning_rate"],
                               betas=tuple(hyper["betas"]), eps=hyper["eps"])
        losses, grads = [], None
        for step in range(steps):
            batch = feed[step]
            x = batch["image"].permute(0, 3, 1, 2).contiguous()
            opt.zero_grad(set_to_none=True)
            loss = total_loss(net(x), batch)
            loss.backward()
            if grads is None:
                grads = {n: float(p.grad.norm()) for n, p in net.named_parameters()
                         if p.grad is not None}
            opt.step()
            losses.append(float(loss.detach()))
        changes = {k: float((v - start[k]).norm()) for k, v in net.state_dict().items()
                   if k in start}
        return losses, grads, changes
    finally:
        harness.f32_policy(False)


def train_gaps(program, reference):
    """The three numbers of a train cell's check from (losses, gradient
    norms, change norms) of both sides: the first step's loss gap relative
    to the reference's loss (the later steps' losses swing with Adam's
    steps on near-zero gradients: PERF.md), and the worst leaf's gap of
    gradient norms and of change norms.  Leaves whose reference gradient is under a thousandth
    of the median leaf's move by round-off alone and are left out of the
    change, as are leaves the program does not train."""
    (p_loss, p_grad, p_change), (r_loss, r_grad, r_change) = program, reference
    loss_gap = abs(p_loss[0] - r_loss[0]) / abs(r_loss[0])
    trained = sorted(set(p_grad) & set(r_grad))
    grad_gap = norm_gaps(p_grad, r_grad, trained)
    median = float(np.median([r_grad[k] for k in trained]))
    moved = [k for k in r_change if k in p_change
             and (k not in r_grad or r_grad[k] >= 1e-3 * median)]
    change_gap = norm_gaps(p_change, r_change, moved)
    return {"first_loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
