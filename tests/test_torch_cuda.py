"""Tests of the port that need the card: the CUDA kernel against its plain
PyTorch version, opcheck on its custom op, a bf16 serving artifact on the
card against the CPU, the fused wrappers' gradients on the card (f32 and the
bf16 route) against autograd through the plain version, the device
prefetcher's copy, the models' GPU forward and train steps (the
FootprintNetwork's in f32 and in bf16 with the packed heads, the
Segmentor's in f32 and bf16) against the CPU's,
the batch dump's overlapped loop against its serial order, GT
generation's splat, median and KITTI aggregate on the GPU against the CPU
(with TF32 off), the data-parallel layer at world 1 over NCCL (the
global-batch BN against F.batch_norm; a DP step through the kernel), and
row sharding: the kernel's seam sites on extended row shards, forward
and backward, and both models' spatial eval and train steps in two ranks
on the card over gloo.

They skip on a host without CUDA.  This file imports neither JAX nor the JAX
package, so it also runs on a GPU host that has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from footprints_tpu_torch.data import DevicePrefetcher
from footprints_tpu_torch.data.compact import BatchCompactor, decompact_on_device
from footprints_tpu_torch.eval.inference import dump_predictions, pad_batch
from footprints_tpu_torch.models import SCALES, FootprintNetwork, Segmentor
from footprints_tpu_torch.nn import layers
from footprints_tpu_torch.ops import fused_conv as fc
from footprints_tpu_torch.parallel import make_mesh, sync_batch_norm
from footprints_tpu_torch.preprocessing.ground_truth_generation import generator as gt_generator
from footprints_tpu_torch.preprocessing.ground_truth_generation import geometry as gt_geometry
from footprints_tpu_torch.preprocessing.segmentation import trainer as seg_trainer
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


# the forward's border cases: H and W of 2 and 3, H past a multiple of the
# tile's rows (16 at reflect; 4 low-res rows at up2_reflect, 8 in bf16 at
# Co <= 32) by 1 or 2, W past a multiple of 16 by 1 or 2, where the reflect
# and edge pads are built in shared memory from the halo box
BORDER_HW = {"reflect": [(2, 2), (3, 3), (2, 3), (17, 18), (18, 17), (33, 34)],
             "up2_reflect": [(2, 2), (3, 3), (1, 2), (5, 17), (6, 18), (9, 34), (10, 33)]}
# (Ci, Co, x misaligned by one element): the TMA halo at N = 64 and N = 32;
# Ci = 6 (24 bytes in f32, 12 in bf16: not a multiple of 16) the plain-load
# halo with Co = 70 (two output-channel tiles, a ragged one); a misaligned x
BORDER_CASES = [(64, 64, False), (32, 32, False), (6, 70, False), (16, 40, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BORDER_CASES, ids=[f"ci{c[0]}-co{c[1]}-mis{int(c[2])}"
                                                    for c in BORDER_CASES])
@pytest.mark.parametrize("pad_mode,hw", [(m, hw) for m in BORDER_HW for hw in BORDER_HW[m]])
def test_kernel_border_cases_match_plain(cuda_device, dtype, case, pad_mode, hw):
    """The forward's pads built in shared memory, at every border case,
    against the f32 plain version (f32 1e-4, bf16 2e-2 on f32 plain with the
    same bf16-rounded inputs), with bias, residual and ELU."""
    ci, co, misaligned = case
    x, w, b, r = _case(cuda_device, pad_mode, hw, ci, co, dtype, seed=sum(hw) + ci)
    if misaligned:
        flat = torch.empty(x.numel() + 1, device=cuda_device, dtype=dtype)
        flat[1:] = x.reshape(-1)
        x = flat[1:].view(x.shape)
        assert x.data_ptr() % 16 != 0
    before = fc.fused_conv3x3.launches
    with torch.no_grad():
        got = fc.fused_conv3x3(x, w, b, r, pad_mode=pad_mode, act="elu")
        ref = fc.fused_conv3x3_plain(x.float(), w.float(), b.float(), r.float(),
                                     pad_mode=pad_mode, act="elu")
    torch.cuda.synchronize()
    assert fc.fused_conv3x3.launches == before + 1
    assert got.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode,hw,ci,co", [("up2_reflect", (96, 320), 64, 32),
                                               ("reflect", (96, 320), 64, 64)])
def test_kernel_is_deterministic_at_batch_12(cuda_device, dtype, pad_mode, hw, ci, co):
    """The forward gives the same bits twice at batch-12 decoder shapes
    (tail.conv1, block4.post.conv2): each output is written once, in a fixed
    order."""
    g = torch.Generator().manual_seed(41)
    ho, wo = hw if pad_mode == "reflect" else (2 * hw[0], 2 * hw[1])
    x = torch.randn(12, *hw, ci, generator=g).to(cuda_device, dtype)
    w = (torch.randn(co, ci, 3, 3, generator=g) / (3 * ci ** 0.5)).to(cuda_device, dtype)
    b = torch.randn(co, generator=g).to(cuda_device, dtype)
    r = torch.randn(12, ho, wo, co, generator=g).to(cuda_device, dtype)
    with torch.no_grad():
        first = fc.fused_conv3x3(x, w, b, r, pad_mode=pad_mode, act="elu")
        second = fc.fused_conv3x3(x, w, b, r, pad_mode=pad_mode, act="elu")
    assert torch.equal(first, second)


def _elu_sweep(n):
    """n f32 pre-activations across the ELU's cases: NaN, +-0, +-inf, the
    negative decades from -1e-30 to -100, both sides of expm1f's reduction
    threshold (-0.41) and of the point where it returns -1 (2^j below 2^-25:
    -17.3 to -17.7), then seeded normals."""
    f = np.float32
    edges = [np.nan, 0.0, -0.0, -np.inf, np.inf, 1e-30, 1.0, 3.5]
    decades = -np.logspace(-30, 2, 1024)
    around = []
    for c in (-0.41, -17.3, -17.328679, -17.67531):
        ulp = int(np.asarray(c, f).view(np.int32))
        around.append(np.arange(ulp - 64, ulp + 65, dtype=np.int32).view(f))  # +-64 ulps
        around.append(np.linspace(c - 0.05, c + 0.05, 512))
    vals = np.concatenate([np.asarray(edges), decades, *around]).astype(f)
    rest = np.random.default_rng(77).normal(0.0, 5.0, n - vals.size).astype(f)
    return np.concatenate([vals, rest])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode", ["reflect", "up2_reflect"])
def test_kernel_elu_bits_equal_expm1(cuda_device, dtype, pad_mode):
    """With w = 0 and b = 0 the kernel's pre-activation is 0 + r, so its
    output is the epilogue's ELU of the residual: the same bits as
    torch.where(v > 0, v, torch.expm1(v)) on the card (libdevice's expm1f),
    rounded to bf16 on the bf16 route, NaN where v is NaN."""
    h, w_ = (8, 32) if pad_mode == "reflect" else (4, 16)
    ho, wo = (h, w_) if pad_mode == "reflect" else (2 * h, 2 * w_)
    co = 64
    x = torch.randn(1, h, w_, 16, generator=torch.Generator().manual_seed(5))
    x = x.to(cuda_device, dtype)
    w = torch.zeros(co, 16, 3, 3, device=cuda_device, dtype=dtype)
    b = torch.zeros(co, device=cuda_device, dtype=dtype)
    r = torch.from_numpy(_elu_sweep(ho * wo * co).reshape(1, ho, wo, co))
    r = r.to(cuda_device, dtype)
    with torch.no_grad():
        got = fc.fused_conv3x3(x, w, b, r, pad_mode=pad_mode, act="elu")
        v = r.float() + 0.0  # -0 + 0 is +0, as in the kernel's sum
        ref = torch.where(v > 0, v, torch.expm1(v)).to(dtype)
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    differ = (got.view(bits) != ref.view(bits)) & ~nan
    assert not differ.any(), (f"{int(differ.sum())} outputs differ, at v = "
                              f"{v[differ][:8].tolist()}: {got[differ][:8].tolist()} "
                              f"against {ref[differ][:8].tolist()}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode", ["reflect", "up2_reflect"])
@pytest.mark.parametrize("ci_lo,ci_hi,co",[(0, 3, 5), (5, 38, 17), (64, 128, 64), (0, 64, 70)])
def test_pack_kernel_matches_plain_bitwise(cuda_device, dtype, pad_mode, ci_lo, ci_hi, co):
    """The forward kernel's weight pre-pack (phase fold, TF32 hi/lo split,
    wgmma's shared-memory image) equals fused_conv3x3_pack_plain byte for
    byte, from an input-channel slice view too; it counts no launch."""
    g = torch.Generator().manual_seed(ci_hi + co + 1)
    w = (torch.randn(co, 128, 3, 3, generator=g) * 0.1).to(cuda_device, dtype)[:, ci_lo:ci_hi]
    before = fc.fused_conv3x3.launches
    got = fc.fused_conv3x3_pack(w, pad_mode=pad_mode)
    assert fc.fused_conv3x3.launches == before
    assert torch.equal(got.cpu(), fc.fused_conv3x3_pack_plain(w.cpu(), pad_mode=pad_mode))


def test_kernel_without_bias_or_residual(cuda_device):
    x, w, _, _ = _case(cuda_device, "up2_reflect", (6, 10), 16, 8, torch.float32)
    with torch.no_grad():
        got = fc.fused_conv3x3(x, w, pad_mode="up2_reflect", act="none")
        ref = fc.fused_conv3x3_plain(x, w, pad_mode="up2_reflect", act="none")
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode", ["reflect", "up2_reflect"])
@pytest.mark.parametrize("with_res", [False, True])
def test_opcheck_cuda(cuda_device, dtype, pad_mode, with_res):
    """torch.library.opcheck on the op's CUDA implementation: schema, fake
    implementation, registered autograd and its use under tracing.  The
    check compares the backward it runs eagerly (the dgrad and wgrad
    kernels) with the one it traces; bf16 is compared at the bf16 bar of
    the fused sites (2e-2), since each gradient is rounded to 8 bits, f32
    at opcheck's defaults."""
    x, w, b, r = (t.requires_grad_() for t in _case(cuda_device, pad_mode, (6, 10),
                                                    16, 8, dtype))
    tol = {"rtol": 2e-2, "atol": 2e-2} if dtype == torch.bfloat16 else {}
    torch.library.opcheck(fc.fused_conv3x3_op,
                          (x, w, b, r if with_res else None, pad_mode, "elu"), **tol)


def _live_forward(net, x):
    with torch.no_grad():
        out = net(x, scales=("1/1",))["1/1"]
    return out.permute(0, 3, 1, 2).float().cpu().numpy()


def test_bf16_artifact_on_the_card(cuda_device, tmp_path):
    """A bf16 artifact exported on the card runs the kernel's bf16 route 10
    times a batch there, and also loads on the CPU; its per-channel MAE
    against the live f32 forward on the card is at most twice the CPU's
    + 1e-3."""
    from footprints_tpu_torch import export

    net = FootprintNetwork(34, generator=torch.Generator().manual_seed(5)).eval()
    torch.save(net.state_dict(), str(tmp_path / "model.pth"))
    out = str(tmp_path / "model.pt2")
    meta = export.export_serving(str(tmp_path), out, height=64, width=128, batch=2)
    assert meta["platforms"] == ["cuda", "cpu"] and meta["dtype"] == "bfloat16"
    x = np.random.RandomState(0).rand(3, 64, 128, 3).astype(np.float32)
    card = export.load_serving(out)
    before = (fc.fused_conv3x3.launches, fc.fused_conv3x3.bf16_launches)
    got = card.call(x)
    torch.cuda.synchronize()
    assert (fc.fused_conv3x3.launches - before[0],
            fc.fused_conv3x3.bf16_launches - before[1]) == (20, 20)  # 2 batches
    cpu = export.load_serving(out, device="cpu").call(x)
    ref_card = _live_forward(net.to(cuda_device), torch.from_numpy(x).to(cuda_device))
    ref_cpu = _live_forward(net.cpu(), torch.from_numpy(x))
    gap_card = np.abs(got - ref_card).mean(axis=(0, 2, 3))
    gap_cpu = np.abs(cpu - ref_cpu).mean(axis=(0, 2, 3))
    assert np.isfinite(got).all() and (gap_cpu > 0).all()
    assert (gap_card <= 2 * gap_cpu + 1e-3).all(), (gap_card, gap_cpu)


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
    """The autograd wrappers on the card (the kernel forward, the dgrad and
    wgrad kernels backward) against CPU autograd through the plain version;
    w is an input-channel slice view, as block4 passes it.  TF32 off.  Bars:
    1e-4 + 1e-4|ref| for x, b and the residual; the weight gradient sums
    N H W (about 1000) products of O(1) terms, added in another order with
    errors that scale with the sums, so its bar is elementwise
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


@pytest.mark.parametrize("use_psp", [True, False])
def test_segmentor_gpu_forward_matches_cpu(cuda_device, use_psp):
    """All 4 logit maps within MAE 1e-4 of the CPU forward (the plain
    versions), and 5 kernel launches per forward (block4 and the tail of
    the one decoder)."""
    net_gpu = Segmentor(34, use_psp, device=cuda_device,
                        generator=torch.Generator().manual_seed(5)).eval()
    net_cpu = Segmentor(34, use_psp).eval()
    net_cpu.load_state_dict(net_gpu.state_dict())
    x = torch.rand(2, 64, 128, 3, generator=torch.Generator().manual_seed(6))
    before = fc.fused_conv3x3.launches
    with torch.no_grad():
        got = net_gpu(x.to(cuda_device))
        ref = net_cpu(x)
    assert fc.fused_conv3x3.launches == before + 5
    assert len(got) == 4
    for k, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape
        assert (g.cpu() - r).abs().mean() < 1e-4, k


@pytest.mark.parametrize("model", ["footprint", "segmentor"])
def test_overlapped_dump_is_byte_identical_to_serial(cuda_device, model):
    """dump_predictions on the card: pinned non_blocking copies both ways,
    batch n+1 queued before batch n is saved; the saved bytes equal the
    serial order's and a plain synchronous forward's, padded tail included."""
    g = torch.Generator().manual_seed(7)
    if model == "footprint":
        net = FootprintNetwork(18, device=cuda_device, generator=g).eval()

        def forward(x):
            return net(x, scales=("1/1",))["1/1"].to(torch.float16)
    else:
        net = Segmentor(18, True, device=cuda_device, generator=g).eval()

        def forward(x):
            return torch.sigmoid(net(x, scales=("1/1",))[0][..., 0]).to(torch.float16)
    rng = np.random.RandomState(8)
    batches = [{"image": rng.rand(n, 64, 128, 3).astype(np.float32),
                "idx": np.arange(3 * i, 3 * i + n)} for i, n in enumerate((3, 3, 2))]
    with torch.inference_mode():
        want = {}
        for b in batches:
            x = torch.from_numpy(pad_batch(b["image"], 3)).to(cuda_device)
            for i, p in zip(b["idx"], forward(x).cpu().numpy()):
                want[int(i)] = p.tobytes()
    outs = {}
    for overlap in (False, True):
        saved = {}

        def save_batch(writer, inputs, preds):
            for i, p in zip(inputs["idx"], preds):
                writer.submit(lambda i=int(i), p=p: saved.__setitem__(i, p.tobytes()))

        assert dump_predictions(batches, forward, save_batch, batch_size=3,
                                device=cuda_device, overlap=overlap) == 8
        outs[overlap] = saved
    assert len(want) == 8 and outs[False] == want and outs[True] == want


@pytest.mark.parametrize("kind,hw", [("up", (7, 19)), ("up", (1, 1)), ("reflect", (13, 37)),
                                     ("res", (13, 37)), ("res", (2, 2))])
@pytest.mark.parametrize("act", ["elu", "none"])
def test_bf16_fused_grads_match_f32_plain_autograd(cuda_device, kind, hw, act):
    """The bf16 route under autograd (the kernel's bf16 forward, the bf16
    dgrad and wgrad kernels) against autograd through the f32 plain version on the
    same bf16-rounded inputs and cotangent; w a slice view as block4 passes
    it.  Bars: the output 2e-2 + 2e-2|ref|; every gradient ||d||/||ref|| <
    2e-2 and elementwise within 2e-2 max|ref| + 2e-2|ref| (each result
    rounded to 8 bits)."""
    pad_mode = "up2_reflect" if kind == "up" else "reflect"
    g = torch.Generator().manual_seed(24)
    x, w, b, r = _case("cpu", pad_mode, hw, 64, 32, torch.float32, seed=24)
    full = torch.randn(32, 128, 3, 3, generator=g) * 0.1
    full[:, 32:96] = w
    gy = torch.randn(r.shape, generator=g)
    x, full, b, r, gy = (t.to(torch.bfloat16) for t in (x, full, b, r, gy))

    def run(dtype, plain):
        leaves = [t.to(cuda_device, dtype).requires_grad_(True) for t in (x, full, b, r)]
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
        (y * gy.to(cuda_device, dtype)).sum().backward()
        return [y.detach()] + [None if t.grad is None else t.grad for t in leaves]

    before = fc.fused_conv3x3.bf16_launches
    got = run(torch.bfloat16, plain=False)
    torch.cuda.synchronize()
    assert fc.fused_conv3x3.bf16_launches == before + 1
    ref = run(torch.float32, plain=True)
    for i, (a, e) in enumerate(zip(got, ref)):
        if e is None:
            assert a is None
            continue
        assert a.dtype == torch.bfloat16
        a = a.float()
        if i == 0:
            torch.testing.assert_close(a, e, atol=2e-2, rtol=2e-2)
        else:
            torch.testing.assert_close(a, e, atol=2e-2 * e.abs().max().item(), rtol=2e-2)
            assert (a - e).norm() < 2e-2 * e.norm()


def _bwd_case(device, pad_mode, hw, ci, co, dtype, seed, n=2):
    """Seeded x [n,H,W,Ci], w [Co,Ci,3,3] and a pre-activation cotangent gz
    of the site's output shape, on `device` in `dtype`."""
    g = torch.Generator().manual_seed(seed)
    ho, wo = hw if pad_mode == "reflect" else (2 * hw[0], 2 * hw[1])
    x = torch.randn(n, *hw, ci, generator=g)
    w = torch.randn(co, ci, 3, 3, generator=g) * 0.1
    gz = torch.randn(n, ho, wo, co, generator=g)
    return [t.to(device=device, dtype=dtype) for t in (x, w, gz)]


def _bwd_launches():
    return (fc.fused_conv3x3_dgrad.launches, fc.fused_conv3x3_wgrad.launches,
            fc.fused_conv3x3_dgrad.bf16_launches, fc.fused_conv3x3_wgrad.bf16_launches)


def _bwd_close(got, ref, leaf, dtype):
    """The f32 bars of test_fused_grads_match_cpu_autograd_of_plain: gx within
    1e-4 + 1e-4|ref|; gw, sums of N H W products, within 1e-4 max|ref| +
    1e-4|ref| and ||d||/||ref|| < 1e-5.  bf16, those of
    test_bf16_fused_grads_match_f32_plain_autograd: 2e-2 max|ref| +
    2e-2|ref| and ||d||/||ref|| < 2e-2 for both (each result rounded to 8
    bits)."""
    got, ref = got.double(), ref.double()
    if dtype == torch.float32:
        atol = 1e-4 * ref.abs().max().item() if leaf == "w" else 1e-4
        torch.testing.assert_close(got, ref, atol=atol, rtol=1e-4, msg=leaf)
        if leaf == "w":
            assert (got - ref).norm() <= 1e-5 * ref.norm(), leaf
    else:
        torch.testing.assert_close(got, ref, atol=2e-2 * ref.abs().max().item(), rtol=2e-2,
                                   msg=leaf)
        assert (got - ref).norm() < 2e-2 * ref.norm(), leaf


@pytest.mark.parametrize("pad_mode,hw", [("reflect", (13, 37)), ("reflect", (2, 2)),
                                         ("reflect", (3, 2)), ("reflect", (2, 19)),
                                         ("up2_reflect", (7, 19)), ("up2_reflect", (1, 1)),
                                         ("up2_reflect", (2, 1)), ("reflect", (33, 65)),
                                         ("up2_reflect", (17, 33))])
@pytest.mark.parametrize("ci,co", [(64, 32), (32, 32), (64, 64), (20, 6), (3, 64), (64, 70),
                                   (5, 8), (40, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_match_plain(cuda_device, pad_mode, hw, ci, co, dtype):
    """fused_conv3x3_dgrad and fused_conv3x3_wgrad on the card against their
    plain versions in f64 on the same (bf16-rounded) tensors, at ragged and
    tiny shapes (both reflect folds on one row at H = 2 or 3, all 16 phase
    taps clamped onto one pixel at 1x1), shapes one past the dgrad's 16 x 16
    tiles and wgrad's 32-column tiles (and its static schedule's last,
    partial run of tiles), Ci = 32 (tail conv2), channel counts that are not
    multiples of the tiles or of 4 (plain staging), Co = 24 (whole 16-byte
    rows, so the cotangent comes in by TMA, with the last chunk's channels
    past Co zero-filled by the box), and each kernel launched once per call,
    on its dtype's route."""
    x, w, gz = _bwd_case(cuda_device, pad_mode, hw, ci, co, dtype, seed=ci + co + hw[0])
    before = _bwd_launches()
    gx = fc.fused_conv3x3_dgrad(gz, w, pad_mode=pad_mode)
    gw = fc.fused_conv3x3_wgrad(gz, x, pad_mode=pad_mode)
    torch.cuda.synchronize()
    bf16 = int(dtype == torch.bfloat16)
    assert tuple(a - b for a, b in zip(_bwd_launches(), before)) == (1, 1, bf16, bf16)
    assert gx.dtype == gw.dtype == dtype and gx.shape == x.shape and gw.shape == w.shape
    assert gw.is_contiguous()
    ref_x = fc.fused_conv3x3_dgrad_plain(gz.double(), w.double(), pad_mode=pad_mode)
    ref_w = fc.fused_conv3x3_wgrad_plain(gz.double(), x.double(), pad_mode=pad_mode)
    _bwd_close(gx, ref_x, "x", dtype)
    _bwd_close(gw, ref_w, "w", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode", ["reflect", "up2_reflect"])
@pytest.mark.parametrize("ci_lo,ci_hi", [(3, 20), (64, 128), (0, 32)])
def test_backward_kernels_slice_view_weight_and_unaligned_inputs(cuda_device, dtype, pad_mode,
                                                                 ci_lo, ci_hi):
    """dgrad reads w as an input-channel slice view (odd offsets included,
    as block4 passes its halves); gz and x at addresses that are not 16-byte
    aligned (the cotangent's halo staged with plain loads)."""
    ci = ci_hi - ci_lo
    g = torch.Generator().manual_seed(ci_lo + 7)
    full = (torch.randn(24, 128, 3, 3, generator=g) * 0.1).to(cuda_device, dtype)
    w = full[:, ci_lo:ci_hi]
    hw = (11, 13)
    ho, wo = hw if pad_mode == "reflect" else (22, 26)
    x = torch.randn(2 * 11 * 13 * ci + 1, generator=g).to(cuda_device, dtype)[1:].view(
        2, 11, 13, ci)
    gz = torch.randn(2 * ho * wo * 24 + 1, generator=g).to(cuda_device, dtype)[1:].view(
        2, ho, wo, 24)
    gx = fc.fused_conv3x3_dgrad(gz, w, pad_mode=pad_mode)
    gw = fc.fused_conv3x3_wgrad(gz, x, pad_mode=pad_mode)
    _bwd_close(gx, fc.fused_conv3x3_dgrad_plain(gz.double(), w.double(), pad_mode=pad_mode),
               "x", dtype)
    _bwd_close(gw, fc.fused_conv3x3_wgrad_plain(gz.double(), x.double(), pad_mode=pad_mode),
               "w", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode,hw,ci,co", [("reflect", (96, 320), 32, 32),
                                               ("up2_reflect", (48, 160), 64, 64)])
def test_backward_kernels_are_deterministic(cuda_device, dtype, pad_mode, hw, ci, co):
    """Two calls give the same bits: no atomics; wgrad's partial sums over
    many blocks are added in a fixed order."""
    x, w, gz = _bwd_case(cuda_device, pad_mode, hw, ci, co, dtype, seed=31)
    first = (fc.fused_conv3x3_dgrad(gz, w, pad_mode=pad_mode),
             fc.fused_conv3x3_wgrad(gz, x, pad_mode=pad_mode))
    second = (fc.fused_conv3x3_dgrad(gz, w, pad_mode=pad_mode),
              fc.fused_conv3x3_wgrad(gz, x, pad_mode=pad_mode))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode,hw,ci,co", [("up2_reflect", (96, 320), 64, 32),
                                               ("reflect", (192, 640), 32, 32)])
def test_backward_kernels_are_deterministic_at_batch_12(cuda_device, dtype, pad_mode, hw, ci,
                                                        co):
    """The same bits twice at the decoder tail's batch-12 shapes (tail.conv1,
    tail.conv2), where wgrad's fixed schedule sums runs of 70-180 tiles a
    block."""
    x, w, gz = _bwd_case(cuda_device, pad_mode, hw, ci, co, dtype, seed=32, n=12)
    first = (fc.fused_conv3x3_dgrad(gz, w, pad_mode=pad_mode),
             fc.fused_conv3x3_wgrad(gz, x, pad_mode=pad_mode))
    second = (fc.fused_conv3x3_dgrad(gz, w, pad_mode=pad_mode),
              fc.fused_conv3x3_wgrad(gz, x, pad_mode=pad_mode))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# the Matterport dump's 512x640 decoder sites (chip_smoke.py:sites at
# (512, 640)): (name, pad_mode, x NHWC at batch 4, Co)
MATTERPORT_SITES = [("block4.post.conv1.up_half", "up2_reflect", (4, 128, 160, 64), 64),
                    ("block4.post.conv1.skip_half", "reflect", (4, 256, 320, 64), 64),
                    ("block4.post.conv2", "reflect", (4, 256, 320, 64), 64),
                    ("tail.conv1", "up2_reflect", (4, 256, 320, 64), 32),
                    ("tail.conv2", "reflect", (4, 512, 640, 32), 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", MATTERPORT_SITES, ids=[s[0] for s in MATTERPORT_SITES])
def test_backward_kernels_at_the_512x640_sites(cuda_device, dtype, site):
    """Both kernels at the Matterport sites, batch 4, against their plain
    versions in f64.  gw's entries sum 327680 to 1310720 products: the f32
    bars are chip_smoke.py's site_backward's for such sums (1e-3 max|ref| +
    1e-3|ref|, ||d||/||ref|| < 1e-4), gx's and the bf16 bars as
    _bwd_close's."""
    _, pad_mode, shape, co = site
    g = torch.Generator().manual_seed(sum(shape) + co)
    n, h, w_, ci = shape
    ho, wo = (h, w_) if pad_mode == "reflect" else (2 * h, 2 * w_)
    x = torch.randn(shape, generator=g).to(cuda_device, dtype)
    w = (torch.randn(co, ci, 3, 3, generator=g) / (3 * ci ** 0.5)).to(cuda_device, dtype)
    gz = torch.randn(n, ho, wo, co, generator=g).to(cuda_device, dtype)
    gx = fc.fused_conv3x3_dgrad(gz, w, pad_mode=pad_mode)
    gw = fc.fused_conv3x3_wgrad(gz, x, pad_mode=pad_mode)
    _bwd_close(gx, fc.fused_conv3x3_dgrad_plain(gz.double(), w.double(), pad_mode=pad_mode),
               "x", dtype)
    ref = fc.fused_conv3x3_wgrad_plain(gz.double(), x.double(), pad_mode=pad_mode)
    if dtype == torch.bfloat16:
        _bwd_close(gw, ref, "w", dtype)
    else:
        d = gw.double() - ref
        assert bool((d.abs() <= 1e-3 * ref.abs().max() + 1e-3 * ref.abs()).all())
        assert d.norm() < 1e-4 * ref.norm()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode", ["reflect", "up2_reflect"])
@pytest.mark.parametrize("ci_lo,ci_hi,co", [(0, 3, 5), (5, 38, 17), (64, 128, 64), (0, 64, 70)])
def test_dgrad_pack_kernel_matches_plain_bitwise(cuda_device, dtype, pad_mode, ci_lo, ci_hi,
                                                 co):
    """The dgrad kernel's weight pre-pack (transpose, phase fold, TF32 hi/lo
    split, wgmma's shared-memory image) equals fused_conv3x3_dgrad_pack_plain
    byte for byte, from an input-channel slice view too; it counts no
    launch."""
    g = torch.Generator().manual_seed(ci_hi + co)
    w = (torch.randn(co, 128, 3, 3, generator=g) * 0.1).to(cuda_device, dtype)[:, ci_lo:ci_hi]
    before = _bwd_launches()
    got = fc.fused_conv3x3_dgrad_pack(w, pad_mode=pad_mode)
    assert _bwd_launches() == before
    assert torch.equal(got.cpu(), fc.fused_conv3x3_dgrad_pack_plain(w.cpu(), pad_mode=pad_mode))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode", ["reflect", "up2_reflect"])
def test_opcheck_backward_ops_cuda(cuda_device, dtype, pad_mode):
    """torch.library.opcheck on the backward ops' CUDA implementations:
    schema, fake implementation, and their use under tracing.  Neither op is
    differentiable, so no input requires grad."""
    x, w, gz = _bwd_case(cuda_device, pad_mode, (6, 10), 16, 8, dtype, seed=9)
    torch.library.opcheck(fc.fused_conv3x3_dgrad_op, (gz, w, pad_mode))
    torch.library.opcheck(fc.fused_conv3x3_wgrad_op, (gz, x, pad_mode))


def _seg_batch(n, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    labelled = (torch.rand(n, h, w, generator=g) > 0.2).float()
    return {"image": torch.rand(n, h, w, 3, generator=g),
            "ground_mask": (torch.rand(n, h, w, generator=g) > 0.5).float() * labelled,
            "labelled_pix": labelled}


def _seg_step(device, batch, dtype=torch.float32, compute=torch.float32, use_psp=True):
    net = Segmentor(18, use_psp, device=device, generator=torch.Generator().manual_seed(25))
    net.to(dtype)
    step = seg_trainer.build_train_step(
        net, tstep.make_optimizer(net, tstep.TrainStepConfig()), lambda s: 1e-4, compute)
    launches = fc.fused_conv3x3.launches, fc.fused_conv3x3.bf16_launches
    metrics = step(0, {k: v.to(device, dtype) for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = (fc.fused_conv3x3.launches - launches[0],
                fc.fused_conv3x3.bf16_launches - launches[1])
    grads = {n: p.grad.cpu().double() for n, p in net.named_parameters() if p.grad is not None}
    return metrics, launches, grads, net


@pytest.mark.parametrize("use_psp", [True, False])
def test_seg_train_step_gpu_matches_cpu(cuda_device, use_psp):
    """One seg train step of Segmentor-18 at 64x128 on the card against the
    same step on the CPU in f64 (see test_train_step_gpu_matches_cpu):
    losses 1e-5 + 1e-5|ref|, each gradient ||d||/||ref|| < 2e-2, BN running
    stats 1e-5; 5 kernel launches."""
    batch = _seg_batch(2, 64, 128, 26)
    m_gpu, n_gpu, g_gpu, net_gpu = _seg_step(cuda_device, batch, use_psp=use_psp)
    m_cpu, n_cpu, g_cpu, net_cpu = _seg_step("cpu", batch, torch.float64, use_psp=use_psp)
    assert (n_gpu, n_cpu) == ((5, 0), (0, 0))
    for k, v in m_cpu.items():
        if k != "lr":
            assert abs(m_gpu[k].item() - v.item()) <= 1e-5 + 1e-5 * abs(v.item()), k
    assert g_gpu.keys() == g_cpu.keys()
    for k, v in g_cpu.items():
        assert (g_gpu[k] - v).norm() / v.norm().clamp_min(1e-12) < 2e-2, k
    sd_cpu = net_cpu.state_dict()
    for k, v in net_gpu.state_dict().items():
        if "running" in k:
            torch.testing.assert_close(v.cpu().double(), sd_cpu[k], atol=1e-5, rtol=0)


def test_seg_bf16_step_runs_the_bf16_route(cuda_device):
    """The mixed step on the card: 5 launches, all of the bf16 route; f32
    master params and gradients; losses within 1e-2 of the f32 step's from
    the same weights, and not equal to them; its gradient (cuDNN's bf16
    convs, the kernels' bf16 routes, the mixed BN's backward on CUDA) no
    farther from an f64 CPU step than twice the CPU bf16 step's distance
    (the CPU path is held against the JAX package in
    tests/test_torch_seg_step.py): the whole gradient, and each leaf plus
    1e-3."""
    batch = _seg_batch(2, 64, 128, 27)
    m32, n32, g32, _ = _seg_step(cuda_device, batch)
    m16, n16, g16, net = _seg_step(cuda_device, batch, compute=torch.bfloat16)
    assert n32 == (5, 0) and n16 == (5, 5)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert g16.keys() == g32.keys()
    assert all(p.grad.dtype == torch.float32 for p in net.parameters() if p.grad is not None)
    gap = max(abs(m16[k].item() - v.item()) for k, v in m32.items() if k != "lr")
    assert 0 < gap < 1e-2 and all(torch.isfinite(v) for k, v in m16.items() if k != "lr")
    g16_cpu = _seg_step("cpu", batch, compute=torch.bfloat16)[2]
    g64 = _seg_step("cpu", batch, torch.float64)[2]

    def whole(g):
        return (torch.cat([(g[k] - v).flatten() for k, v in g64.items()]).norm()
                / torch.cat([v.flatten() for v in g64.values()]).norm()).item()

    assert whole(g16) <= 2 * whole(g16_cpu), (whole(g16), whole(g16_cpu))
    for k, v in g64.items():
        gpu, cpu = ((g[k] - v).norm().item() / max(v.norm().item(), 1e-30)
                    for g in (g16, g16_cpu))
        assert gpu <= 2 * cpu + 1e-3, (k, gpu, cpu)


def _footprint_step(device, batch, dtype=torch.float32, compute="float32", heads=True):
    net = FootprintNetwork(18, device=device, generator=torch.Generator().manual_seed(26))
    net.to(dtype)
    config = tstep.TrainStepConfig(compute_dtype=compute, s2d_head=heads, p4_head=heads)
    step = tstep.build_train_step(net, tstep.make_optimizer(net, config), config)
    launches = fc.fused_conv3x3.launches, fc.fused_conv3x3.bf16_launches
    metrics = step(0, {k: v.to(device, dtype) for k, v in batch.items()})
    if device != "cpu":
        torch.cuda.synchronize()
    launches = (fc.fused_conv3x3.launches - launches[0],
                fc.fused_conv3x3.bf16_launches - launches[1])
    grads = {n: p.grad.cpu().double() for n, p in net.named_parameters() if p.grad is not None}
    return metrics, launches, grads, net


def test_footprint_bf16_step_with_packed_heads_runs_the_bf16_route(cuda_device):
    """The FootprintNetwork's mixed step with both packed heads on the card:
    10 launches, all of the bf16 route; f32 masters and gradients; losses
    within 1e-2 of the f32 step's and not equal to them; its gradient no
    farther from an f64 CPU step than twice the CPU bf16 step's distance
    (the CPU path is held against the JAX package in
    tests/test_torch_bf16_train.py): the whole gradient, and each leaf plus
    1e-3.  The f32 step with the heads equals the one without: loss terms
    1e-6 relative, the whole gradient ||d||/||ref|| < 1e-5."""
    g = torch.Generator().manual_seed(28)
    batch = {"image": torch.rand(2, 64, 128, 3, generator=g),
             "depth": torch.rand(2, 64, 128, generator=g) * 20,
             "ground_depth": torch.rand(2, 64, 128, generator=g) * 15,
             **{k: (torch.rand(2, 64, 128, generator=g) > 0.5).float()
                for k in ("visible_ground", "all_ground", "depth_mask",
                          "moving_object_mask")}}
    m32, n32, g32, _ = _footprint_step(cuda_device, batch)
    m_off, _, g_off, _ = _footprint_step(cuda_device, batch, heads=False)
    m16, n16, g16, net = _footprint_step(cuda_device, batch, compute="bfloat16")
    assert n32 == (10, 0) and n16 == (10, 10)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(p.grad.dtype == torch.float32 for p in net.parameters() if p.grad is not None)
    assert g16.keys() == g32.keys() == g_off.keys()
    gap = max(abs(m16[k].item() - v.item()) for k, v in m32.items() if k != "lr")
    assert 0 < gap < 1e-2 and all(torch.isfinite(v) for k, v in m16.items() if k != "lr")
    for k, v in m_off.items():
        if k != "lr":
            assert abs(m32[k].item() - v.item()) <= 1e-6 * abs(v.item()), k
    g16_cpu = _footprint_step("cpu", batch, compute="bfloat16")[2]
    g64 = _footprint_step("cpu", batch, torch.float64)[2]

    def whole(g, ref):
        return (torch.cat([(g[k] - v).flatten() for k, v in ref.items()]).norm()
                / torch.cat([v.flatten() for v in ref.values()]).norm()).item()

    assert whole(g32, g_off) < 1e-5
    assert whole(g16, g64) <= 2 * whole(g16_cpu, g64), (whole(g16, g64), whole(g16_cpu, g64))
    for k, v in g64.items():
        gpu, cpu = ((g[k] - v).norm().item() / max(v.norm().item(), 1e-30)
                    for g in (g16, g16_cpu))
        assert gpu <= 2 * cpu + 1e-3, (k, gpu, cpu)


@pytest.mark.parametrize("model", ["footprint", "segmentor"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_train_steps_launch_the_backward_kernels(cuda_device, model, compute):
    """A train step's backward runs the dgrad and wgrad kernels once per
    site: 10 each for the FootprintNetwork (5 sites x 2 decoders), 5 each
    for the Segmentor, all on the bf16 route in the mixed step; the forward
    kernel's 10 (5) launches are all in the forward."""
    before = _bwd_launches()
    if model == "footprint":
        g = torch.Generator().manual_seed(29)
        batch = {"image": torch.rand(2, 64, 128, 3, generator=g),
                 "depth": torch.rand(2, 64, 128, generator=g) * 20,
                 "ground_depth": torch.rand(2, 64, 128, generator=g) * 15,
                 **{k: (torch.rand(2, 64, 128, generator=g) > 0.5).float()
                    for k in ("visible_ground", "all_ground", "depth_mask",
                              "moving_object_mask")}}
        _, forward, _, _ = _footprint_step(cuda_device, batch, compute=compute,
                                           heads=compute == "bfloat16")
        per = 10
    else:
        _, forward, _, _ = _seg_step(cuda_device, _seg_batch(2, 64, 128, 29),
                                     compute=getattr(torch, compute))
        per = 5
    bf16 = per if compute == "bfloat16" else 0
    assert forward == (per, bf16)
    assert tuple(a - b for a, b in zip(_bwd_launches(), before)) == (per, per, bf16, bf16)


def _gt_window(n=76, h=192, w=640):
    """A KITTI window at the real size: flat ground 1.5 m below a camera
    moving 0.5 m per frame (both sides), box-shaped holes, poses relative to
    the middle frame."""
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 0.58 * w, 1.92 * h, 0.5 * w, 0.5 * h
    ys = np.arange(h, dtype=np.float64)
    z = np.where(ys > K[1, 2], K[1, 1] * 1.5 / np.maximum(ys - K[1, 2], 1e-3), 0)
    z[z > 60] = 0
    depths = np.tile(z[None, :, None], (n, 1, w)).astype(np.float32)
    rng = np.random.RandomState(0)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        poses[i, 2, 3] = 0.5 * (i // 2 - n // 4)
        poses[i, 0, 3] = 0.54 * (i % 2)
        y0, x0 = rng.randint(h // 2, h - 20), rng.randint(0, w - 60)
        depths[i, y0:y0 + 20, x0:x0 + 60] = 0
    invK = np.linalg.pinv(K).astype(np.float32)
    return [torch.from_numpy(a) for a in (depths, poses, np.tile(K, (n, 1, 1)),
                                          np.tile(invK, (n, 1, 1)))]


def test_gt_splat_and_median_on_the_gpu_equal_the_cpu(cuda_device):
    """The scatter-min splat and the masked median, bit for bit, on the same
    tensors (min and the sort do not depend on order)."""
    depths, poses, K, invK = _gt_window()
    cam = gt_geometry.project_to_camera(gt_geometry.project_to_world(depths, invK),
                                        poses, K)
    cpu = gt_geometry.extract_depth_from_projections(cam, 192, 640)
    gpu = gt_geometry.extract_depth_from_projections(cam.to(cuda_device), 192, 640)
    assert torch.equal(gpu.cpu(), cpu) and (cpu > 0).float().mean() > 0.1
    for min_hits in (0, 2):
        ref = gt_geometry.masked_median(cpu, min_hits=min_hits)
        got = gt_geometry.masked_median(cpu.to(cuda_device), min_hits=min_hits)
        assert torch.equal(got.cpu(), ref)


def test_gt_kitti_aggregate_gpu_matches_cpu(cuda_device):
    """At most 1e-3 of the pixels differ by more than 1e-4|ref| or in being
    zero: the projections' dot products sum in another order on the card,
    which flips a few floor()s."""
    args = _gt_window()
    ref = gt_geometry.aggregate_hidden_depth(*args, height=192, width=640)
    got = gt_geometry.aggregate_hidden_depth(*(a.to(cuda_device) for a in args),
                                             height=192, width=640).cpu()
    differ = ((got - ref).abs() > 1e-4 * ref.abs()) | ((got > 0) != (ref > 0))
    assert differ.float().mean().item() <= 1e-3 and (ref > 0).float().mean() > 0.2


def test_gt_generator_runs_on_the_card_with_tf32_off(cuda_device, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    split = tmp_path / "split.txt"
    split.write_text("seq0 1 l")
    generator = gt_generator.GroundTruthGenerator(
        gt_generator.get_options(["--textfile", str(split)]))
    assert generator.device.type == "cuda"
    assert generator.generator.device.type == "cuda"
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.fixture
def nccl_world_1(cuda_device, tmp_path):
    """A process group of one rank over NCCL (a FileStore in tmp_path), and
    the mesh on it; destroyed after the test."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("nccl", store=store, world_size=1, rank=0)
    try:
        yield make_mesh("cuda:0")
    finally:
        dist.destroy_process_group()


def test_global_batch_norm_at_world_1_equals_f_batch_norm(nccl_world_1):
    """The global-batch BN's two NCCL all-reduces over a world of one: the
    same values, running stats and input gradient as F.batch_norm on the
    card within 1e-6 + 1e-6|ref|; the weight and bias gradients, sums of
    3840 products summed in another order, within 1e-6 max|ref|."""
    g = torch.Generator().manual_seed(30)
    x = (torch.randn(4, 64, 24, 40, generator=g) * 2 + 0.5).cuda()
    x = x.to(memory_format=torch.channels_last)
    w, b = (torch.rand(64, generator=g) + 0.5).cuda(), torch.randn(64, generator=g).cuda()
    cot = torch.randn(x.shape, generator=g).cuda()
    out = {}
    for name, group in (("global", nccl_world_1.group), ("plain", None)):
        xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
        rm, rv = torch.zeros(64, device="cuda"), torch.ones(64, device="cuda")
        y = layers.batch_norm(xs, ws, bs, rm, rv, training=True, group=group)
        (y * cot).sum().backward()
        out[name] = (y, rm, rv, xs.grad, ws.grad, bs.grad)
    ref = F.batch_norm(x, torch.zeros(64, device="cuda"), torch.ones(64, device="cuda"), w,
                       b, training=True)
    torch.testing.assert_close(out["plain"][0], ref, atol=0, rtol=0)
    for got, want in zip(out["global"][:4], out["plain"][:4]):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    for got, want in zip(out["global"][4:], out["plain"][4:]):
        torch.testing.assert_close(got, want, atol=1e-6 * want.abs().max().item(), rtol=0)


def test_dp_step_at_world_1_runs_the_kernel(nccl_world_1):
    """A data-parallel FootprintNetwork-18 step (global BN, NCCL gradient
    all-reduce) at world 1: 10 launches per forward, and the losses of the
    plain step within 1e-5."""
    mesh = nccl_world_1
    g = torch.Generator().manual_seed(31)
    batch = {"image": torch.rand(2, 64, 128, 3, generator=g),
             "depth": torch.rand(2, 64, 128, generator=g) * 20,
             "ground_depth": torch.rand(2, 64, 128, generator=g) * 15,
             **{k: (torch.rand(2, 64, 128, generator=g) > 0.5).float()
                for k in ("visible_ground", "all_ground", "depth_mask",
                          "moving_object_mask")}}
    batch = {k: v.cuda() for k, v in batch.items()}
    config = tstep.TrainStepConfig()
    metrics = {}
    for name in ("dp", "plain"):
        net = FootprintNetwork(18, device="cuda", generator=torch.Generator().manual_seed(31))
        if name == "dp":
            sync_batch_norm(net, mesh)
        step = tstep.build_train_step(net, tstep.make_optimizer(net, config), config,
                                      mesh if name == "dp" else None)
        before = fc.fused_conv3x3.launches
        metrics[name] = step(0, batch)
        assert fc.fused_conv3x3.launches - before == 10
    for k, v in metrics["plain"].items():
        if k != "lr":
            assert torch.isfinite(metrics["dp"][k])
            assert abs(metrics["dp"][k].item() - v.item()) <= 1e-5 + 1e-5 * abs(v.item()), k


# --- row (spatial) sharding on the card ----------------------------------------

def _row_shards(t, spatial):
    """Each row shard (dim 1) of the NHWC ``t`` with one neighbour row on
    each seam side, and that halo (above, below)."""
    per = t.shape[1] // spatial
    return [(t[:, j * per - (j > 0):(j + 1) * per + (j < spatial - 1)].contiguous(),
             (int(j > 0), int(j < spatial - 1))) for j in range(spatial)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spatial", [2, 3])
@pytest.mark.parametrize("site", ["up", "reflect", "residual"])
def test_seam_sites_give_the_unsharded_rows(cuda_device, dtype, spatial, site):
    """The kernel on row shards extended by their seam rows, those rows'
    outputs dropped (ops/fused_conv.py's ``halo``; the residual cropped to
    the skip's extended rows), gives the unsharded kernel's rows; both at
    the plain version's bars (f32 1e-4, bf16 2e-2 against the f32 plain
    version of the bf16-rounded inputs)."""
    g = torch.Generator().manual_seed(40 + spatial)
    low = torch.randn(2, 8 * spatial, 40, 64, generator=g)
    skip = torch.randn(2, 16 * spatial, 80, 64, generator=g)
    w_up = torch.randn(32, 64, 3, 3, generator=g) / 24
    w = torch.randn(32, 64, 3, 3, generator=g) / 24
    b = torch.randn(32, generator=g)
    params = [t.to(cuda_device, dtype) for t in (w_up, w, b)]
    low, skip = low.to(cuda_device, dtype), skip.to(cuda_device, dtype)

    def run(lo, lo_halo, sk, sk_halo, plain=False):
        f = fc.fused_conv3x3_plain if plain else fc.fused_conv3x3
        w_up, w, b = [t.float() for t in params] if plain else params
        if site == "up":
            return fc.crop_rows(f(lo, w_up, b, pad_mode="up2_reflect", act="elu"),
                                2 * lo_halo[0], 2 * lo_halo[1])
        if site == "reflect":
            return fc.crop_rows(f(sk, w, b, pad_mode="reflect", act="elu"), *sk_halo)
        r = fc.crop_rows(f(lo, w_up, pad_mode="up2_reflect", act="none"), *lo_halo)
        return fc.crop_rows(f(sk, w, b, r.contiguous(), pad_mode="reflect", act="elu"),
                            *sk_halo)

    tol = 1e-4 if dtype == torch.float32 else 2e-2
    with torch.no_grad():
        before = fc.fused_conv3x3.launches
        got = torch.cat([run(*lo, *sk) for lo, sk in zip(_row_shards(low, spatial),
                                                          _row_shards(skip, spatial))], 1)
        assert fc.fused_conv3x3.launches - before == spatial * (2 if site == "residual" else 1)
        whole = run(low, (0, 0), skip, (0, 0))
        ref = run(low.float(), (0, 0), skip.float(), (0, 0), plain=True)
    torch.cuda.synchronize()
    assert got.shape == whole.shape == ref.shape
    torch.testing.assert_close(got, whole, atol=tol, rtol=tol)
    torch.testing.assert_close(got.float(), ref, atol=tol, rtol=tol)


def _grad_close(got, ref, leaf, dtype):
    """The fused wrappers' gradient bars in f32: a weight or bias gradient
    (a sum of some 10^4 products, which cuDNN adds in other orders on the
    two tensor sizes) within 1e-3 max|ref| + 1e-3|ref|, an input or
    residual gradient within 1e-4 + 1e-4|ref|; bf16 2e-2 in place of
    both."""
    tol = (1e-3 if leaf in ("w", "b") else 1e-4) if dtype == torch.float32 else 2e-2
    atol = tol * ref.abs().max().item() if leaf in ("w", "b") else tol
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=tol, msg=leaf)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spatial", [2, 3])
@pytest.mark.parametrize("site", ["up", "reflect", "residual"])
def test_seam_site_gradients_give_the_unsharded_gradients(cuda_device, dtype, spatial, site):
    """The fused wrappers' gradients through the kernel on row shards
    extended by their seam rows, the seam rows' outputs dropped: the x, w,
    b and residual gradients, the shards' halo rows' gradients added back
    to the rows they were copied from (here by autograd through the slices
    that made the shards) and w's and b's summed, are the unsharded
    kernel's; the backward launches no forward kernel."""
    g = torch.Generator().manual_seed(50 + spatial)
    low = torch.randn(2, 8 * spatial, 40, 64, generator=g)
    skip = torch.randn(2, 16 * spatial, 80, 64, generator=g)
    res = torch.randn(2, 16 * spatial, 80, 32, generator=g)
    w = torch.randn(32, 64, 3, 3, generator=g) / 24
    b = torch.randn(32, generator=g)
    cot = torch.randn(2, 16 * spatial, 80, 32, generator=g)
    leaves = {"x": low if site == "up" else skip, "w": w, "b": b}
    if site == "residual":
        leaves["residual"] = res
    leaves = {k: v.to(cuda_device, dtype).requires_grad_() for k, v in leaves.items()}
    cot = cot.to(cuda_device, dtype)

    def run(x, r, halo):
        if site == "up":
            return fc.up_conv_fused(x, leaves["w"], leaves["b"], halo=halo)
        if site == "reflect":
            return fc.conv_reflect_fused(x, leaves["w"], leaves["b"], halo=halo)
        return fc.conv_reflect_res_fused(x, leaves["w"], leaves["b"], r, halo=halo)

    def grads(y):
        for t in leaves.values():
            t.grad = None
        before = fc.fused_conv3x3.launches
        (y.float() * cot.float()).sum().backward()
        assert fc.fused_conv3x3.launches == before
        return {k: t.grad.clone() for k, t in leaves.items()}

    before = fc.fused_conv3x3.launches
    shards = _row_shards(leaves["x"], spatial)
    rs = (_row_shards(leaves["residual"], spatial) if site == "residual"
          else [(None, None)] * spatial)
    got = grads(torch.cat([run(x, r, halo) for (x, halo), (r, _) in zip(shards, rs)], 1))
    assert fc.fused_conv3x3.launches - before == spatial
    ref = grads(run(leaves["x"], leaves.get("residual"), (0, 0)))
    torch.cuda.synchronize()
    for leaf, want in ref.items():
        assert got[leaf].shape == want.shape, leaf
        _grad_close(got[leaf], want, leaf, dtype)


def test_spatial_train_on_the_card_matches_one_process(cuda_device, tmp_path):
    """FootprintNetwork-18's and Segmentor-18's f32 train steps at 64x96,
    batch 4, in two ranks on the card over gloo, each on its 32 rows,
    against the same step in one process on the card: the loss terms
    within 1e-5 + 1e-5|ref|, each gradient leaf ||d||/||ref|| < 2e-2, BN
    running stats within 1e-5, the replicas bitwise equal after Adam, 10
    (5) launches a rank a step."""
    from footprints_tpu_torch.parallel.dryrun import spawn

    from . import _torch_dp_worker as worker

    g = torch.Generator().manual_seed(34)
    torch.save(FootprintNetwork(18, generator=g).state_dict(), tmp_path / "fp.pt")
    torch.save(Segmentor(18, True, generator=g).state_dict(), tmp_path / "seg.pt")
    rng = np.random.RandomState(34)
    image = rng.rand(4, 64, 96, 3).astype(np.float32)
    masks = {k: (rng.rand(4, 64, 96) > 0.5).astype(np.float32)
             for k in ("visible_ground", "all_ground", "depth_mask", "moving_object_mask",
                       "labelled_pix")}
    cases = {"footprint": (str(tmp_path / "fp.pt"), 10, {
                 "image": image, "depth": (rng.rand(4, 64, 96) * 20).astype(np.float32),
                 "ground_depth": (rng.rand(4, 64, 96) * 15).astype(np.float32),
                 **{k: v for k, v in masks.items() if k != "labelled_pix"}}),
             "segmentor": (str(tmp_path / "seg.pt"), 5, {
                 "image": image, "ground_mask": masks["all_ground"],
                 "labelled_pix": masks["labelled_pix"]})}
    for model, (path, launches, batch) in cases.items():
        ranks = spawn(2, worker.spatial_step_rank, model, path, batch, device="cuda",
                      backend="gloo", spatial=2, timeout=300)
        ref = worker.spatial_step_rank(make_mesh("cuda"), model, path, batch)
        got = ranks[0]
        assert [r["launches"] for r in ranks] == [launches] * 2, model
        assert len({r["digest"] for r in ranks}) == 1, model
        for k, v in ref["losses"].items():
            assert abs(got["losses"][k] - v) <= 1e-5 + 1e-5 * abs(v), (model, k)
        assert got["grads"].keys() == ref["grads"].keys()
        for k, v in ref["grads"].items():
            rel = np.linalg.norm(got["grads"][k] - v) / max(np.linalg.norm(v), 1e-12)
            assert rel < 2e-2, (model, k, rel)
        for k, v in ref["state_dict"].items():
            if "running" in k:
                np.testing.assert_allclose(got["state_dict"][k], v, atol=1e-5, err_msg=k)


def test_spatial_eval_on_the_card_matches_one_process(cuda_device, tmp_path):
    """FootprintNetwork-18's and Segmentor-18's eval steps at 64x96, batch
    2, in two ranks on the card over gloo, each on its 32 rows: the losses
    of the one-process eval within 1e-5 + 1e-5|ref|, 10 launches per rank
    per eval forward, the '1/1' rows within MAE 1e-4."""
    from footprints_tpu_torch.parallel.dryrun import spawn
    from footprints_tpu_torch.preprocessing.segmentation import trainer as seg_trainer

    from . import _torch_dp_worker as worker

    g = torch.Generator().manual_seed(33)
    fp = FootprintNetwork(18, generator=g)
    seg = Segmentor(18, True, generator=g)
    torch.save(fp.state_dict(), tmp_path / "fp.pt")
    torch.save(seg.state_dict(), tmp_path / "seg.pt")
    rng = np.random.RandomState(33)
    fp_batch = {"image": rng.rand(2, 64, 96, 3).astype(np.float32),
                "depth": (rng.rand(2, 64, 96) * 20).astype(np.float32),
                "ground_depth": (rng.rand(2, 64, 96) * 15).astype(np.float32),
                **{k: (rng.rand(2, 64, 96) > 0.5).astype(np.float32)
                   for k in ("visible_ground", "all_ground", "depth_mask",
                             "moving_object_mask")}}
    seg_batch = {"image": fp_batch["image"], "ground_mask": fp_batch["all_ground"],
                 "labelled_pix": fp_batch["depth_mask"]}
    ranks = spawn(2, worker.spatial_rank, str(tmp_path / "fp.pt"), str(tmp_path / "seg.pt"),
                  fp_batch, seg_batch, False, None, device="cuda", backend="gloo", spatial=2,
                  timeout=300)
    fp, seg = fp.to(cuda_device), seg.to(cuda_device)
    on_card = {k: torch.from_numpy(v).cuda() for k, v in fp_batch.items()}
    ref = tstep.build_eval_step(fp, tstep.TrainStepConfig())(on_card)
    seg_ref = seg_trainer.build_eval_step(seg)({k: torch.from_numpy(v).cuda()
                                               for k, v in seg_batch.items()})
    with torch.no_grad():
        out = fp.eval()(on_card["image"], scales=("1/1",))["1/1"].cpu().numpy()
    for r in ranks:
        assert r["footprint"]["f32_launches"] == 10
        for got, want in ((r["footprint"]["f32"], ref), (r["segmentor"], seg_ref)):
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                assert abs(got[k] - v.item()) <= 1e-5 + 1e-5 * abs(v.item()), k
    rows = np.concatenate([r["footprint"]["1/1"] for r in ranks], 1)
    assert float(np.abs(rows - out).mean()) < 1e-4


def _spans_on_the_card(fn, names):
    """fn() under a CUDA profiler session, then a synchronise: the recorded
    spans named ``names`` and the host clock once the card had finished."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from footprints_tpu_torch import telemetry

    telemetry.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
        done_ns = time.time_ns()
    return [s for s in telemetry.spans() if s.name in names], done_ns


@pytest.mark.parametrize("work", ["matmuls", "footprint_forward", "train_step"])
def test_span_device_ms_on_the_card(cuda_device, work):
    from footprints_tpu_torch import telemetry

    if work == "matmuls":
        a = torch.randn(2048, 2048, device=cuda_device)

        def fn():
            with telemetry.span("matmuls", device=cuda_device, unit=0):
                for _ in range(8):
                    a @ a
        names = ("matmuls",)
    elif work == "footprint_forward":
        net = FootprintNetwork(18, device=cuda_device).eval()
        x = torch.rand(2, 64, 96, 3, device=cuda_device)

        def fn():
            with torch.no_grad():
                net(x)
        names = ("encoder", "decoder")
    else:
        from footprints_tpu_torch.model_manager import ModelManager

        mm = ModelManager(depth=18, device=cuda_device)
        step_fn = tstep.build_train_step(mm.net, mm.optimizer, mm.config)
        g = torch.Generator(device=cuda_device).manual_seed(4)
        batch = {k: (torch.rand(2, 64, 96, generator=g, device=cuda_device) > 0.5).float()
                 for k in ("visible_ground", "all_ground", "depth_mask",
                           "moving_object_mask")}
        batch["image"] = torch.rand(2, 64, 96, 3, generator=g, device=cuda_device)
        batch["depth"] = 1 + 20 * torch.rand(2, 64, 96, generator=g, device=cuda_device)
        batch["ground_depth"] = batch["depth"] * batch["all_ground"]

        def fn():
            step_fn(0, batch)
        names = ("step.forward", "step.loss", "step.backward", "step.optimizer")
    fn()  # warm: the first calls pick cuDNN's algorithms
    spans, done_ns = _spans_on_the_card(fn, names)
    assert sorted({s.name for s in spans}) == sorted(names)
    for s in spans:
        assert s.device_ms is not None and np.isfinite(s.device_ms) and s.device_ms > 0, s
        # the events lie inside the span's host start and the card's completion
        assert s.device_ms <= (done_ns - s.start_ns) / 1e6, s
