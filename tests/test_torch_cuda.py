"""Tests of the port that need the card: the CUDA kernel against its plain
PyTorch version, the fused wrappers' gradients on the card against CPU
autograd through the plain version, the device prefetcher's copy, and the
model's GPU forward and train step against the CPU's.

They skip on a host without CUDA.  This file imports neither JAX nor the JAX
package, so it also runs on a GPU host that has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from footprints_tpu_torch.data import DevicePrefetcher
from footprints_tpu_torch.data.compact import BatchCompactor, decompact_on_device
from footprints_tpu_torch.models import SCALES, FootprintNetwork
from footprints_tpu_torch.ops import fused_conv as fc
from footprints_tpu_torch.train import step as tstep

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(device, pad_mode, hw, ci, co, dtype, seed=12):
    g = torch.Generator().manual_seed(seed)
    ho, wo = hw if pad_mode == "reflect" else (2 * hw[0], 2 * hw[1])
    x = torch.randn(2, *hw, ci, generator=g)
    w = torch.randn(co, ci, 3, 3, generator=g) * 0.1
    b = torch.randn(co, generator=g)
    r = torch.randn(2, ho, wo, co, generator=g)
    return [t.to(device=device, dtype=dtype) for t in (x, w, b, r)]


@pytest.mark.parametrize("pad_mode,hw", [("reflect", (13, 37)), ("reflect", (2, 2)),
                                         ("up2_reflect", (7, 19)), ("up2_reflect", (1, 1))])
@pytest.mark.parametrize("ci,co", [(20, 6), (64, 32), (3, 64), (64, 70), (5, 8)])
@pytest.mark.parametrize("with_res", [False, True])
def test_kernel_matches_plain_f32(cuda_device, pad_mode, hw, ci, co, with_res):
    x, w, b, r = _case(cuda_device, pad_mode, hw, ci, co, torch.float32)
    r = r if with_res else None
    before = fc.fused_conv3x3.launches
    with torch.no_grad():
        got = fc.fused_conv3x3(x, w, b, r, pad_mode=pad_mode, act="elu")
        ref = fc.fused_conv3x3_plain(x, w, b, r, pad_mode=pad_mode, act="elu")
    torch.cuda.synchronize()
    assert fc.fused_conv3x3.launches == before + 1
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("pad_mode,hw", [("reflect", (13, 37)), ("up2_reflect", (7, 19)),
                                         ("up2_reflect", (1, 1))])
@pytest.mark.parametrize("act", ["none", "elu"])
@pytest.mark.parametrize("ci", [64, 20])
def test_kernel_bf16_matches_f32_plain(cuda_device, pad_mode, hw, act, ci):
    """The bf16 tensor-core path; Ci = 20 stages the halo with plain loads."""
    x, w, b, r = _case(cuda_device, pad_mode, hw, ci, 32, torch.bfloat16)
    with torch.no_grad():
        got = fc.fused_conv3x3(x, w, b, r, pad_mode=pad_mode, act=act)
        ref = fc.fused_conv3x3_plain(x.float(), w.float(), b.float(), r.float(),
                                     pad_mode=pad_mode, act=act)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref, atol=2e-2, rtol=2e-2)


def _tf32(t):
    """Round f32 to TF32 (10 mantissa bits, to nearest, ties away), as
    cvt.rna.tf32.f32 does."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("pad_mode", ["reflect", "up2_reflect"])
def test_kernel_f32_is_not_single_pass_tf32(cuda_device, pad_mode):
    """Inputs 1 + k 2^-15 (k in 12..15) and weights 2^-8 (1 + k 2^-15) lose
    their small parts when rounded to TF32; the bias cancels the large
    part, so single-pass TF32 misses the f32 bar by more than 10x.  The
    3xTF32 kernel must hold it."""
    g = torch.Generator().manual_seed(5)
    ci, co = 64, 32
    x = 1 + torch.randint(12, 16, (2, 9, 21, ci), generator=g) * 2.0 ** -15
    w = 2.0 ** -8 * (1 + torch.randint(12, 16, (co, ci, 3, 3), generator=g) * 2.0 ** -15)
    b = -w.double().sum((1, 2, 3)).float()
    x, w, b = (t.float().to(cuda_device) for t in (x, w, b))
    with torch.no_grad():
        got = fc.fused_conv3x3(x, w, b, pad_mode=pad_mode, act="none")
        ref = fc.fused_conv3x3_plain(x, w, b, pad_mode=pad_mode, act="none")
        one_pass = fc.fused_conv3x3_plain(_tf32(x), _tf32(w), b, pad_mode=pad_mode,
                                          act="none")
    bar = 1e-4 + 1e-4 * ref.abs()
    assert ((one_pass - ref).abs() / bar).max() > 10
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode", ["reflect", "up2_reflect"])
@pytest.mark.parametrize("ci_lo,ci_hi", [(3, 20), (64, 128), (0, 5)])
def test_kernel_weight_slice_view_and_unaligned_x(cuda_device, dtype, pad_mode, ci_lo,
                                                  ci_hi):
    """w an input-channel slice view (odd offsets included, as block4 passes
    its halves) and x at an address that is not 16-byte aligned."""
    ci = ci_hi - ci_lo
    g = torch.Generator().manual_seed(ci_lo)
    full = (torch.randn(24, 128, 3, 3, generator=g) * 0.1).to(cuda_device, dtype)
    w = full[:, ci_lo:ci_hi]
    x = torch.randn(2 * 11 * 13 * ci + 1, generator=g).to(cuda_device, dtype)
    x = x[1:].view(2, 11, 13, ci)  # 4 (f32) or 2 (bf16) bytes past alignment
    b = torch.randn(24, generator=g).to(cuda_device, dtype)
    with torch.no_grad():
        got = fc.fused_conv3x3(x, w, b, pad_mode=pad_mode, act="elu")
        ref = fc.fused_conv3x3_plain(x.float(), w.float(), b.float(), pad_mode=pad_mode,
                                     act="elu")
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (7, 19), (5, 1)])
@pytest.mark.parametrize("ci,co", [(64, 64), (3, 6)])
def test_kernel_up2_matches_phase_plain(cuda_device, hw, ci, co):
    """The kernel's 4-tap phase convs against their plain spec."""
    x, w, b, _ = _case(cuda_device, "up2_reflect", hw, ci, co, torch.float32)
    with torch.no_grad():
        got = fc.fused_conv3x3(x, w, b, pad_mode="up2_reflect", act="none")
        ref = fc.up2_phase_conv_plain(x, w, b)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def test_kernel_without_bias_or_residual(cuda_device):
    x, w, _, _ = _case(cuda_device, "up2_reflect", (6, 10), 16, 8, torch.float32)
    with torch.no_grad():
        got = fc.fused_conv3x3(x, w, pad_mode="up2_reflect", act="none")
        ref = fc.fused_conv3x3_plain(x, w, pad_mode="up2_reflect", act="none")
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def test_model_gpu_forward_matches_cpu(cuda_device):
    g = torch.Generator().manual_seed(3)
    net_gpu = FootprintNetwork(34, device=cuda_device, generator=g).eval()
    net_cpu = FootprintNetwork(34, device="cpu").eval()
    net_cpu.load_state_dict(net_gpu.state_dict())
    x = torch.rand(2, 64, 128, 3, generator=torch.Generator().manual_seed(4))
    before = fc.fused_conv3x3.launches
    with torch.no_grad():
        got = net_gpu(x.to(cuda_device))
        ref = net_cpu(x)
    assert fc.fused_conv3x3.launches == before + 10
    for k in SCALES:
        assert (got[k].cpu() - ref[k]).abs().mean() < 1e-4, k


@pytest.mark.parametrize("kind,hw", [("up", (7, 19)), ("up", (1, 1)),
                                     ("reflect", (13, 37)), ("res", (13, 37)),
                                     ("res", (2, 2))])
@pytest.mark.parametrize("act", ["elu", "none"])
def test_fused_grads_match_cpu_autograd_of_plain(cuda_device, kind, hw, act):
    """The autograd wrappers on the card (kernel forward, cuDNN backward)
    against CPU autograd through the plain version; w is an input-channel
    slice view, as block4 passes it.  TF32 off.  Bars: 1e-4 + 1e-4|ref| for
    x, b and the residual; the weight gradient sums N H W (about 1000)
    products of O(1) terms, which cuDNN's wgrad algorithms add in other
    orders with errors that scale with the sums, so its bar is elementwise
    1e-4 max|ref| + 1e-4|ref|, and ||d|| / ||ref|| < 1e-5 over the tensor."""
    pad_mode = "up2_reflect" if kind == "up" else "reflect"
    g = torch.Generator().manual_seed(21)
    x, w, b, r = _case("cpu", pad_mode, hw, 64, 32, torch.float32, seed=21)
    full = torch.randn(32, 128, 3, 3, generator=g) * 0.1
    full[:, 32:96] = w
    gy = torch.randn(r.shape, generator=g)

    def grads(device, plain):
        leaves = [t.to(device).requires_grad_(True) for t in (x, full, b, r)]
        tx, tfull, tb, tr = leaves
        tw = tfull[:, 32:96]
        res = tr if kind == "res" else None
        if plain:
            y = fc.fused_conv3x3_plain(tx, tw, tb, res, pad_mode=pad_mode, act=act)
        elif kind == "up":
            y = fc.up_conv_fused(tx, tw, tb, act=act)
        elif kind == "reflect":
            y = fc.conv_reflect_fused(tx, tw, tb, act=act)
        else:
            y = fc.conv_reflect_res_fused(tx, tw, tb, tr, act=act)
        (y * gy.to(device)).sum().backward()
        return [None if t.grad is None else t.grad.cpu() for t in leaves]

    before = fc.fused_conv3x3.launches
    got = grads(cuda_device, plain=False)
    torch.cuda.synchronize()
    assert fc.fused_conv3x3.launches == before + 1  # forward only
    ref = grads("cpu", plain=True)
    for i, (a, e) in enumerate(zip(got, ref)):
        if e is None:
            assert a is None
        else:
            atol = 1e-4 * e.abs().max().item() if i == 1 else 1e-4
            torch.testing.assert_close(a, e, atol=atol, rtol=1e-4)
            assert (a - e).norm() <= 1e-5 * e.norm()


def test_prefetcher_copy_matches_synchronous_to(cuda_device):
    """Pinned non_blocking copies on the side stream, consumed on the
    current stream (with a busy current stream so a missing wait would
    show), equal a synchronous .to() of the same arrays."""
    rng = np.random.RandomState(22)
    host = [{"image": rng.rand(4, 64, 96, 3).astype(np.float32),
             "depth": (rng.rand(4, 64, 96) * 30).astype(np.float32),
             "visible_ground": (rng.rand(4, 64, 96) > 0.5).astype(np.float32)}
            for _ in range(6)]
    compactor = BatchCompactor("exact")
    busy = torch.randn(4096, 4096, device=cuda_device)
    got = []
    prefetcher = DevicePrefetcher(map(compactor, host), cuda_device, depth=2,
                                  decode=lambda b: decompact_on_device(b, compactor.scheme))
    for batch in prefetcher:
        busy = busy @ busy / 64  # keep the consumer stream behind
        got.append({k: v.clone() for k, v in batch.items()})
    torch.cuda.synchronize()
    for h, d in zip(host, got):
        for k, v in h.items():
            assert torch.equal(d[k].cpu(), torch.from_numpy(v)), k
            assert torch.equal(d[k], torch.from_numpy(v).to(cuda_device)), k


def test_train_step_gpu_matches_cpu(cuda_device):
    """One train step of FootprintNetwork-18 at 64x128 on the card against
    the same step on the CPU in f64 (an f32 step, on either side, sits
    several 1e-3 from the exact one at the deep encoder's leaves, where
    train-mode BN's backward nearly cancels at batch 2, so two f32 steps can
    differ by the whole bar): losses 1e-5 + 1e-5|ref|, each gradient
    ||d||/||ref|| < 2e-2, BN running stats 1e-5; 10 kernel launches."""
    g = torch.Generator().manual_seed(23)
    nets = {d: FootprintNetwork(18, device=d, generator=torch.Generator().manual_seed(23))
            for d in (cuda_device, "cpu")}
    nets["cpu"].to(torch.float64)
    batch = {"image": torch.rand(2, 64, 128, 3, generator=g),
             "depth": torch.rand(2, 64, 128, generator=g) * 20,
             "ground_depth": torch.rand(2, 64, 128, generator=g) * 15,
             **{k: (torch.rand(2, 64, 128, generator=g) > 0.5).float()
                for k in ("visible_ground", "all_ground", "depth_mask",
                          "moving_object_mask")}}
    config = tstep.TrainStepConfig()
    out = {}
    for device, net in nets.items():
        dtype = next(net.parameters()).dtype
        step = tstep.build_train_step(net, tstep.make_optimizer(net, config), config)
        before = fc.fused_conv3x3.launches
        metrics = step(0, {k: v.to(device, dtype) for k, v in batch.items()})
        out[str(device)] = (metrics, fc.fused_conv3x3.launches - before,
                            {n: p.grad.cpu().double() for n, p in net.named_parameters()
                             if p.grad is not None},
                            {k: v.cpu().double() for k, v in net.state_dict().items()})
    (m_gpu, n_gpu, g_gpu, sd_gpu), (m_cpu, n_cpu, g_cpu, sd_cpu) = \
        out[str(cuda_device)], out["cpu"]
    assert (n_gpu, n_cpu) == (10, 0)
    for k, v in m_cpu.items():
        if k != "lr":
            assert abs(m_gpu[k].item() - v.item()) <= 1e-5 + 1e-5 * abs(v.item()), k
    assert g_gpu.keys() == g_cpu.keys()
    for k, v in g_cpu.items():
        assert (g_gpu[k] - v).norm() / v.norm().clamp_min(1e-12) < 2e-2, k
    for k, v in sd_cpu.items():
        if "running" in k:
            torch.testing.assert_close(sd_gpu[k], v, atol=1e-5, rtol=0)
