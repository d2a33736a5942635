"""Tests of the port that need the card: the CUDA kernel against its plain
PyTorch version, the fused wrappers' gradients on the card (f32 and the
bf16 route) against autograd through the plain version, the device
prefetcher's copy, the models' GPU forward and train steps (the
FootprintNetwork's in f32 and in bf16 with the packed heads, the
Segmentor's in f32 and bf16) against the CPU's, and
the batch dump's overlapped loop against its serial order.

They skip on a host without CUDA.  This file imports neither JAX nor the JAX
package, so it also runs on a GPU host that has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from footprints_tpu_torch.data import DevicePrefetcher
from footprints_tpu_torch.data.compact import BatchCompactor, decompact_on_device
from footprints_tpu_torch.eval.inference import dump_predictions, pad_batch
from footprints_tpu_torch.models import SCALES, FootprintNetwork, Segmentor
from footprints_tpu_torch.ops import fused_conv as fc
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
    """The bf16 route under autograd (the kernel's bf16 forward, cuDNN's bf16
    dgrad and wgrad) against autograd through the f32 plain version on the
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
    convs, the kernel's bf16 route, the mixed BN's backward on CUDA) no
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
