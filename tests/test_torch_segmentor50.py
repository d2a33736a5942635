"""Segmentor-50 with PSP (the ResNet-50 Bottleneck encoder, PSPNet's
ResNet-50 pyramid widths) held against the benchmark's plain reference of
it, ``portbench/reference/segmentor_r50.py``, loaded by path as the
benchmark's harness loads it.  No JAX: the reference is plain PyTorch, and
so is the port on the CPU (the fused kernel's plain version).

Both sides load one seeded state dict (``portbench/weights.py``, the
benchmark's weights) at a small size: batch 2, 64x96.
"""

import os
import subprocess
import sys

import pytest
import torch

from footprints_tpu_torch.models import Segmentor
from footprints_tpu_torch.models.footprint import kernel_sites
from footprints_tpu_torch.preprocessing.segmentation import losses as seg_losses
from footprints_tpu_torch.preprocessing.segmentation import trainer
from footprints_tpu_torch.train import step as tstep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTBENCH = os.path.join(ROOT, "portbench")
if PORTBENCH not in sys.path:
    sys.path.append(PORTBENCH)  # the reference imports its decoders as the harness does

import harness  # noqa: E402
import weights  # noqa: E402
from reference.segmentor_r50 import seg_loss  # noqa: E402

CONFIG = harness.load_json(PORTBENCH, "configs", "segmentor-r50-psp-ade.json")
N, H, W = 2, 64, 96
SEED = 2**31 + 13


def reference(dtype=torch.float32):
    net = harness.reference_model(CONFIG, "cpu")
    net.load_state_dict(weights.seeded_state_dict(net, SEED, "cpu"))
    return net.to(dtype)


def port(dtype=torch.float32):
    net = Segmentor(depth=50, use_psp=True)
    template = harness.reference_model(CONFIG)
    net.load_state_dict(weights.seeded_state_dict(template, SEED, "cpu"), strict=True)
    return net.to(dtype)


def batch(dtype):
    """An image, the ground mask and the labelled pixels, seeded."""
    g = torch.Generator().manual_seed(31)
    return {"image": torch.rand(N, H, W, 3, generator=g).to(dtype),
            "ground_mask": (torch.rand(N, H, W, generator=g) < 0.4).to(dtype),
            "labelled_pix": (torch.rand(N, H, W, generator=g) < 0.9).to(dtype)}


def step_on(compute, master):
    """One step of the seg ``build_train_step`` on the port with ``master``
    parameters, its forward in ``compute``: (loss, {leaf: gradient})."""
    net = port(master)
    optimizer = tstep.make_optimizer(net, tstep.TrainStepConfig())
    step_fn = trainer.build_train_step(net, optimizer, lambda step: 1e-4, compute)
    loss = float(step_fn(0, batch(master))["loss"])
    return loss, {n: p.grad.double() for n, p in net.named_parameters() if p.requires_grad}


@pytest.fixture(scope="module")
def reference_step():
    """The reference's f64 seg loss and its autograd gradients by leaf."""
    b = batch(torch.float64)
    net = reference(torch.float64).train()
    loss = seg_loss(net(b["image"].permute(0, 3, 1, 2).contiguous()), b["ground_mask"],
                    b["labelled_pix"])
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in net.named_parameters()
                                  if p.grad is not None}


# The bars of the f64 step.  The port's seg loss takes the maps in f32
# (preprocessing/segmentation/losses.py), so its value sits ~1e-9 from the
# f64 reference's (seen 1.1e-9) and the cotangent it sends back is rounded
# at 6e-8: the loss within 1e-8 of the reference's, each leaf's gradient
# within 1e-6 of its largest entry (seen 3.7e-7).  A bf16 forward misses
# both by far (seen: loss 4.8e-4, a leaf 1.8; test_a_bf16_forward_fails).
LOSS_BAR, GRAD_BAR = 1e-8, 1e-6


def step_gaps(loss, grads, reference_step):
    want, ref_grads = reference_step
    assert set(grads) == set(ref_grads) and len(grads) == 207
    return abs(loss - want) / abs(want), max(
        float((grads[n] - g).abs().max() / g.abs().max()) for n, g in ref_grads.items())


def test_state_dict_and_parameters_equal_the_reference():
    ours = Segmentor(50, True, device="meta").state_dict()
    theirs = harness.reference_model(CONFIG).state_dict()
    assert set(ours) == set(theirs)
    assert all(ours[k].shape == theirs[k].shape for k in ours)
    assert tuple(ours["decoder.PSP.block4.reduce.weight"].shape) == (512, 2048, 1, 1)
    assert tuple(ours["decoder.block1.pre_concat_conv.conv1.weight"].shape) == (256, 4096, 3, 3)
    count = sum(p.numel() for p in Segmentor(50, True, device="meta").parameters())
    assert count == CONFIG["parameters"] == 43_148_068


def test_reference_refuses_another_depth():
    with pytest.raises(ValueError, match="ResNet-50, not ResNet-34"):
        harness.reference_model(dict(CONFIG, encoder_depth=34))


def test_reference_loads_neither_jax_nor_the_port():
    code = ("import sys, harness\n"
            "cfg = harness.load_json(harness.HERE, 'configs', 'segmentor-r50-psp-ade.json')\n"
            "harness.reference_model(cfg)\n"
            "import reference.segmentor_r50\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'footprints_tpu', 'footprints_tpu_torch'}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=PORTBENCH), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


# f32: the two sides sum their convs in another order (the port's decoder
# sites through the kernel's plain version, its BN its own); the widest gap
# seen is 5.5e-6 of the largest map value.  f64: the same arithmetic,
# rounded at 1e-16; seen 7.4e-15 of it.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-12)])
def test_every_logit_map_matches_the_reference(dtype, tol):
    x = batch(dtype)["image"]
    with torch.no_grad():
        got = port(dtype).eval()(x)
        want = reference(dtype).eval()(x.permute(0, 3, 1, 2).contiguous())
    assert len(got) == len(want) == 4
    for k, (g, ref) in enumerate(zip(got, want)):
        assert g.shape == (N, H // 2 ** (3 - k), W // 2 ** (3 - k), 1)
        torch.testing.assert_close(g.permute(0, 3, 1, 2), ref,
                                   atol=tol * ref.abs().max().item(), rtol=0, msg=str(k))


def test_seg_loss_is_the_ports():
    """The reference's plain seg loss equals the port's
    ``compute_seg_losses`` on the same logits, in f64 up to the port's f32
    maps (1e-7)."""
    b = batch(torch.float64)
    g = torch.Generator().manual_seed(5)
    maps = [3 * torch.randn(N, H // s, W // s, 1, generator=g, dtype=torch.float64)
            for s in (8, 4, 2, 1)]
    want = seg_loss([m.permute(0, 3, 1, 2) for m in maps], b["ground_mask"], b["labelled_pix"])
    got = seg_losses.compute_seg_losses(maps, b["ground_mask"], b["labelled_pix"])["loss"]
    assert abs(float(got) - float(want)) <= 1e-7 * abs(float(want))


def test_train_step_matches_the_reference_loss_and_gradients(reference_step):
    """One step of the seg ``build_train_step`` (train-mode BN, the PSP,
    the 4-scale seg loss, backward through the kernel's plain dgrad and
    wgrad) in f64 against the reference's seg loss and autograd gradients,
    leaf by leaf.  f64, because at batch 2 train-mode BN's backward
    cancels: an f32 step sits 0.24 of a leaf's largest entry from f64."""
    loss_gap, grad_gap = step_gaps(*step_on(torch.float64, torch.float64), reference_step)
    assert loss_gap <= LOSS_BAR
    assert grad_gap <= GRAD_BAR


def test_a_bf16_forward_fails_the_step_bars(reference_step):
    """The bars are tight enough to see the precision: the same step with
    its forward on bf16 copies of f32 masters misses both."""
    loss_gap, grad_gap = step_gaps(*step_on(torch.bfloat16, torch.float32), reference_step)
    assert loss_gap > 100 * LOSS_BAR and grad_gap > 100 * GRAD_BAR


def test_kernel_sites_of_segmentor50():
    """The fused kernel's 10 sites in one decoder, block2's skip half at
    the 1/8 feature's 512 channels (128 under ResNet-34)."""
    sites = {s[0]: s[1:] for s in kernel_sites(Segmentor(50, True, device="meta"), 12, 192, 640)}
    assert len(sites) == 10
    assert all(name.startswith("decoder.") for name in sites)
    assert sites["decoder.block2.post.conv1.skip_half"] == (
        "reflect", (12, 24, 80, 512), 128, True, True, "elu")
    assert sites["decoder.block2.post.conv1.up_half"] == (
        "up2_reflect", (12, 12, 40, 128), 128, False, False, "none")
    assert sites["decoder.block3.pre.conv1"] == ("reflect", (12, 24, 80, 128), 64, False,
                                                 True, "elu")
