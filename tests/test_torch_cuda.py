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
@pytest.mark.parametrize("ci,co", [(20, 6), (64, 32), (3, 64), (64, 70)])
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


@pytest.mark.parametrize("pad_mode,hw", [("reflect", (13, 37)), ("up2_reflect", (7, 19))])
@pytest.mark.parametrize("act", ["none", "elu"])
def test_kernel_bf16_matches_f32_plain(cuda_device, pad_mode, hw, act):
    x, w, b, r = _case(cuda_device, pad_mode, hw, 64, 32, torch.bfloat16)
    with torch.no_grad():
        got = fc.fused_conv3x3(x, w, b, r, pad_mode=pad_mode, act=act)
        ref = fc.fused_conv3x3_plain(x.float(), w.float(), b.float(), r.float(),
                                     pad_mode=pad_mode, act=act)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref, atol=2e-2, rtol=2e-2)


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
