"""FootprintNetwork-50 (the ResNet-50 Bottleneck encoder) held against the
benchmark's plain reference of it, ``portbench/reference/footprint_r50.py``,
loaded by path as the benchmark's harness loads it.  No JAX: the reference
is plain PyTorch, and so is the port on the CPU (the fused kernel's plain
version).

Both sides load one seeded state dict (``portbench/weights.py``, the
benchmark's weights) at a small size: batch 2, 64x128.
"""

import os
import subprocess
import sys

import pytest
import torch

from footprints_tpu_torch.model_manager import ModelManager
from footprints_tpu_torch.models import FootprintNetwork
from footprints_tpu_torch.train import step as tstep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTBENCH = os.path.join(ROOT, "portbench")
if PORTBENCH not in sys.path:
    sys.path.append(PORTBENCH)  # the reference imports its decoders as the harness does

import harness  # noqa: E402
import weights  # noqa: E402
from reference.losses import total_loss  # noqa: E402

CONFIG = harness.load_json(PORTBENCH, "configs", "footprints-r50-kitti.json")
N, H, W = 2, 64, 128
SEED = 2**31 + 11


def reference(dtype=torch.float32):
    net = harness.reference_model(CONFIG, "cpu")
    net.load_state_dict(weights.seeded_state_dict(net, SEED, "cpu"))
    return net.to(dtype)


def port(dtype=torch.float32):
    manager = ModelManager(depth=50, device="cpu")
    template = harness.reference_model(CONFIG)
    manager.net.load_state_dict(weights.seeded_state_dict(template, SEED, "cpu"), strict=True)
    manager.net.to(dtype)
    return manager


def batch(dtype):
    """An image and the six target maps of the loss, seeded."""
    g = torch.Generator().manual_seed(29)

    def mask(p):
        return (torch.rand(N, H, W, generator=g) < p).to(dtype)

    def depth(p):
        return (0.1 + 79.9 * torch.rand(N, H, W, generator=g)).to(dtype) * mask(p)

    return {"image": torch.rand(N, H, W, 3, generator=g).to(dtype),
            "visible_ground": mask(0.4), "all_ground": mask(0.5), "depth": depth(0.7),
            "ground_depth": depth(0.3), "depth_mask": mask(0.2),
            "moving_object_mask": mask(0.05)}


def test_state_dict_and_parameters_equal_the_reference():
    ours = FootprintNetwork(50).state_dict()
    theirs = harness.reference_model(CONFIG).state_dict()
    assert list(ours) == list(theirs)
    assert all(ours[k].shape == theirs[k].shape for k in ours)
    assert "encoder.layer1.1.0.downsample.0.weight" in ours
    assert tuple(ours["encoder.layer4.2.conv3.weight"].shape) == (2048, 512, 1, 1)
    count = sum(p.numel() for p in FootprintNetwork(50).parameters())
    assert count == CONFIG["parameters"] == 44_967_504


def test_reference_refuses_another_depth():
    with pytest.raises(ValueError, match="ResNet-50, not ResNet-34"):
        harness.reference_model(dict(CONFIG, encoder_depth=34))


def test_reference_loads_neither_jax_nor_the_port():
    code = ("import sys, harness\n"
            "cfg = harness.load_json(harness.HERE, 'configs', 'footprints-r50-kitti.json')\n"
            "harness.reference_model(cfg)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'footprints_tpu', 'footprints_tpu_torch'}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=PORTBENCH), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


# f32: the two sides sum their convs in another order (the port's decoder
# sites through the kernel's plain version, its BN its own); the widest gap
# seen is 6e-6 of the largest map value.  f64: the same arithmetic, rounded
# at 1e-16; seen 6e-15 of it.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-12)])
def test_forward_matches_the_reference_at_every_scale(dtype, tol):
    x = batch(dtype)["image"]
    with torch.no_grad():
        got = port(dtype).net.eval()(x)
        want = reference(dtype).eval()(x.permute(0, 3, 1, 2).contiguous())
    assert set(got) == set(want) == {"1/8", "1/4", "1/2", "1/1"}
    for scale, ref in want.items():
        assert got[scale].shape == (N, H, W, 4)
        torch.testing.assert_close(got[scale].permute(0, 3, 1, 2), ref,
                                   atol=tol * ref.abs().max().item(), rtol=0, msg=scale)


def test_train_step_matches_the_reference_loss_and_gradients():
    """One step of ``build_train_step`` (train-mode BN, the 4-scale loss,
    backward through the kernel's plain dgrad and wgrad) in f64 against
    the reference's loss and autograd gradients, leaf by leaf.  f64,
    because at batch 2 train-mode BN's backward cancels, and f32 steps sit
    up to 0.3 of a deep leaf's largest entry apart.  Bars: the port's loss
    takes the maps in f32 (train/losses.py), so its value sits ~1e-10 from
    the f64 reference's and the cotangent it sends back is rounded at
    6e-8: the loss within 1e-8, each leaf's gradient within 1e-6 of its
    largest entry (seen: 4.3e-8)."""
    b = batch(torch.float64)
    manager = port(torch.float64)
    step_fn = tstep.build_train_step(manager.net, manager.optimizer, manager.config)
    loss = float(step_fn(0, b)["loss"])
    ref = reference(torch.float64).train()
    want = total_loss(ref(b["image"].permute(0, 3, 1, 2).contiguous()), b)
    want.backward()
    want = float(want.detach())
    assert abs(loss - want) <= 1e-8 * abs(want)
    got = {n: p.grad for n, p in manager.net.named_parameters() if p.requires_grad}
    ref_grads = {n: p.grad for n, p in ref.named_parameters() if p.grad is not None}
    assert set(got) == set(ref_grads) and len(got) == 247
    for name, g in ref_grads.items():
        torch.testing.assert_close(got[name], g, atol=1e-6 * g.abs().max().item(), rtol=0,
                                   msg=name)
