"""The plain reference of the ResNet-50 Segmentor with PSP, and of the
segmentation loss it trains on, in plain PyTorch.

The network is nianticlabs/footprints' ground-segmentation Segmentor
(``preprocessing/segmentation/network.py``: ``Segmentor``, ``PSP``,
``PSPBlock``, built with ``--encoder_depth 50``): torchvision's
``resnet50`` encoder (He et al., "Deep Residual Learning for Image
Recognition", CVPR 2016; the v1.5 Bottleneck) as Monodepth2's
``ResnetEncoder(num_layers=50)`` wraps it (``reference/footprint_r50.py``),
under the segmentation decoder of ``reference/models.py``.  Its features
are (64, 256, 512, 1024, 2048) wide; the pyramid pools the 2048-channel
1/32 feature, reduces each pool to 512 channels with a bias-free 1x1 conv
and resizes it back, and the concat is 4096 wide: the widths of PSPNet's
ResNet-50 pyramid pooling module (Zhao, Shi, Qi, Wang, Jia, "Pyramid Scene
Parsing Network", CVPR 2017).  Block1's pre-concat ConvBlock takes that
concat to 256 channels.  State-dict keys are the port's, so both sides load
one seeded state dict.  It imports nothing of the port.

Departures from PSPNet, as footprints builds the module:

- bins of 1, 2, 4 and 6 cells, where PSPNet pools to 1, 2, 3 and 6;
- no BN and no ReLU after a branch's 1x1 reduce;
- an undilated encoder, so the pyramid sits at an output stride of 32, not
  PSPNet's dilated 8;
- footprints' U-Net skip decoder with a 1-channel logit head at each of 4
  scales (1/8, 1/4, 1/2, 1/1), where PSPNet has one 3x3 conv head over the
  concat.

Departures from footprints' published training, which the benchmark's
traffic stands in for: seeded weights (``weights.py``; the segmentation
model starts from ImageNet ``resnet50`` weights, not in the repo), and
seeded batches in place of the ADE20K + Cityscapes loader.

``seg_loss`` is the loss of footprints' segmentation trainer: each logit
map resized bilinearly (``align_corners=False``) to the input size,
binary cross-entropy with logits masked by ``labelled_pix``, normalised per
image by the labelled count + 1e-7, then the mean over the batch and over
the 4 scales.  ``train_steps`` runs it under ``torch.optim.Adam``.
"""

import torch
import torch.nn.functional as F

from reference import footprint_r50, models


def segmentor(config):
    """The Segmentor of ``config``: ResNet-50, PSP as ``use_psp`` says."""
    if config["encoder_depth"] != 50:
        raise ValueError(f"{config['name']}: this reference's encoder is ResNet-50, "
                         f"not ResNet-{config['encoder_depth']}")
    return models.Segmentor(use_psp=config["use_psp"], encoder=footprint_r50.ResnetEncoder(),
                            enc_channels=footprint_r50.CHANNELS)


def seg_loss(outputs, ground_mask, labelled_pix):
    """``outputs``: the reference's 4 NCHW [N,1,h,w] logit maps;
    ``ground_mask`` and ``labelled_pix``: [N,H,W] of 0/1.  A scalar."""
    height, width = ground_mask.shape[1:]
    valid = labelled_pix.sum((1, 2))
    total = 0.0
    for logits in outputs:
        up = F.interpolate(logits, size=(height, width), mode="bilinear",
                           align_corners=False)[:, 0]
        bce = F.binary_cross_entropy_with_logits(up, ground_mask, reduction="none")
        total = total + ((bce * labelled_pix).sum((1, 2)) / (valid + 1e-7)).mean()
    return total / len(outputs)


def train_steps(net, feed, steps, hyper):
    """``steps`` plain steps of ``net`` (train-mode BN, ``seg_loss``,
    ``torch.optim.Adam`` with ``hyper``'s learning rate, betas and eps) on
    ``feed``'s first batches ({'image': [N,H,W,3], 'ground_mask',
    'labelled_pix'}).  Returns (losses, the first gradient's norm by leaf,
    the change of every floating state leaf by leaf after the steps)."""
    net.train()
    start = {k: v.detach().clone() for k, v in net.state_dict().items()
             if v.is_floating_point()}
    opt = torch.optim.Adam(net.parameters(), lr=hyper["learning_rate"],
                           betas=tuple(hyper["betas"]), eps=hyper["eps"])
    losses, grads = [], None
    for step in range(steps):
        batch = feed[step]
        x = batch["image"].permute(0, 3, 1, 2).contiguous()
        opt.zero_grad(set_to_none=True)
        loss = seg_loss(net(x), batch["ground_mask"], batch["labelled_pix"])
        loss.backward()
        if grads is None:
            grads = {n: float(p.grad.norm()) for n, p in net.named_parameters()
                     if p.grad is not None}
        opt.step()
        losses.append(float(loss.detach()))
    changes = {k: float((v - start[k]).norm()) for k, v in net.state_dict().items()
               if k in start}
    return losses, grads, changes
