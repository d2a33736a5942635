"""Tests of the port that need the card: the CUDA kernel against its plain
PyTorch version, and the model's GPU forward against its CPU forward.

They skip on a host without CUDA.  This file imports neither JAX nor the JAX
package, so it also runs on a GPU host that has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from footprints_tpu_torch.models import SCALES, FootprintNetwork
from footprints_tpu_torch.ops import fused_conv as fc

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
