#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (footprints_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero without the
final result line:

  1. device   torch and CUDA versions, the card's name and power limit;
  2. build    nvcc-builds the CUDA kernels from footprints_tpu_torch/csrc/;
  3. sites    holds fused_conv3x3 against its plain PyTorch version at the
              5 decoder sites of the kitti 192x640 forward, batch 4, in f32
              (atol = rtol = 1e-4, TF32 off on both sides: 576-term dot
              products summed in another order) and bf16 (2e-2 against the
              f32 plain version on the same bf16-rounded inputs: the output
              is rounded to bf16);
  4. main     writes a seeded FootprintNetwork-34 as model.pth and serves
              it through footprints_tpu_torch.predict_simple on the GPU: one
              image, then folder mode over test_data/, each run again with
              --device cpu.  Checks each .npy is a finite [4,192,640] map
              within MAE 1e-4 of its CPU twin, that the kernel ran 10 times
              per GPU batch, and that the GPU forward matches the CPU forward
              (MAE < 1e-4 at every scale);
  5. times    at each site, the mean time per call over 20 eager calls
              (CUDA events, the method of the port's first kernel) of the
              kernel (f32 on the 3xTF32 tensor-core route, bf16 on the bf16
              one), its plain version and the cuDNN conv, and the kernel's
              device time alone (graph_ms: the mean over 3 replays of 20
              calls captured in a CUDA graph), beside the least time the
              card could take (an up site
              counted at the 4 taps per output its function needs):
              bound_ffma_ms at the f32 FMA peak, bound_tc_ms with 3 TF32
              products per MAC (bf16: 1 bf16 product) at the tensor-core
              peak, each at least the site's bytes at the HBM rate; then the
              serving forward's imgs/s at batch 16 and the single-image p50;
  6. profile  torch.profiler device time by kernel over the batch-16
              forward, the idle share, and the full table in
              smoke_out/profile_b16.json;
  7. train    trains FootprintNetwork-34 at 192x640, batch 12, through
              footprints_tpu_torch.main on a synthetic KITTI tree of
              375x1242 frames (where PIL, OpenCV and PyYAML all import;
              otherwise TrainManager with in-memory samples of the same
              shapes through the same loader, compactor, prefetcher and
              step, and the route says so): 4 steps, one validation batch
              at step 0, 'exact' compact transport.  Checks every logged
              loss is finite, weights_0/checkpoint.npz holds step 4, a
              second TrainManager resumes step 4 and the Adam moments, and
              the kernel ran 10 times per training forward and per
              validation forward.  Then one GPU step against one CPU step
              in f64 from the same weights and batch (batch 2, 192x640, the
              first validation samples): each loss term within
              1e-5 + 1e-5|ref|, each gradient leaf ||d||/||ref|| < 2e-2
              (worst printed), BN running stats within 1e-5;
  8. train_times  the train step alone on a batch-12 batch already on the
              card (mean of 10 steps after 3 warm-up, CUDA events): ms,
              imgs/s and peak memory; its forward / backward / Adam split;
              the trainer's own rate over phase 7's epoch, loader
              included; at each fused site at batch 12, the kernel's output
              and the autograd Function's gradients (x, the full weight, b,
              the residual) against autograd through the plain version in
              f64 on the same card tensors (output, x, residual 1e-4 +
              1e-4|ref|; weight and b, sums of 368640 or more products,
              1e-3 max|ref| + 1e-3|ref| and ||d||/||ref|| < 1e-4), beside
              the f32 plain version's own distance to it, then the kernel's
              forward and the Function's cuDNN backward timed; a torch.profiler table of one
              step by category with the idle share (1 - kernel time / the
              profiled step's CUDA-event span, unclamped) and the top
              operators by input shape, in full in
              smoke_out/profile_train_b12.json; and
              cuDNN's time for the decoder's block2 post-concat conv at
              batch 4, 8, 12 and 16.

Exits non-zero when CUDA is absent or the package is not beside this file.
"""

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from footprints_tpu_torch import main as train_main
from footprints_tpu_torch import predict_simple
from footprints_tpu_torch.checkpoint import load_checkpoint
from footprints_tpu_torch.data import DataLoader, collate
from footprints_tpu_torch.model_manager import ModelManager
from footprints_tpu_torch.models import SCALES, FootprintNetwork
from footprints_tpu_torch.ops import build
from footprints_tpu_torch.ops import fused_conv as fc
from footprints_tpu_torch.ops.fused_conv import (fused_conv3x3,
                                                 fused_conv3x3_plain)
from footprints_tpu_torch.options import Options
from footprints_tpu_torch.train.losses import compute_losses
from footprints_tpu_torch.train.step import build_train_step
from footprints_tpu_torch.train.trainer import SEED as TRAIN_SEED
from footprints_tpu_torch.train.trainer import TrainManager

REPO = os.path.dirname(os.path.abspath(__file__))
HEIGHT, WIDTH = 192, 640
SEED = 10
KERNEL = {
    "name": "fused_conv3x3",
    "route": "cuda",
    "source": "footprints_tpu_torch/csrc/fused_conv3x3.cu",
    "replaces": "footprints_tpu/ops/pallas_conv.py:110",
}
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): f32 outside
# the tensor cores, TF32 and bf16 on them, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
TF32_PRODUCTS_PER_MAC = 3  # the f32 route's 3xTF32 split
ROUTES = {torch.float32: "mma_tf32x3", torch.bfloat16: "mma_bf16"}
LAUNCHES_PER_FORWARD = 10  # 5 sites x 2 decoders
TRAIN_BATCH, TRAIN_STEPS, VAL_BATCHES = 12, 4, 1
CHECK_BATCH = 2  # the GPU-vs-CPU train step
KITTI_RAW_HW = (375, 1242)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


class Failures(list):
    def check(self, ok, what):
        if not ok:
            self.append(what)
            print(f"FAIL: {what}", flush=True)
        return ok


def sites(batch):
    """The kernel's 5 call sites per decoder in the 192x640 forward:
    (name, pad_mode, input NHWC shape, Co, residual?, bias?, act)."""
    h2, w2, h4, w4 = HEIGHT // 2, WIDTH // 2, HEIGHT // 4, WIDTH // 4
    return [
        ("block4.post.conv1.up_half", "up2_reflect", (batch, h4, w4, 64), 64, False, False, "none"),
        ("block4.post.conv1.skip_half", "reflect", (batch, h2, w2, 64), 64, True, True, "elu"),
        ("block4.post.conv2", "reflect", (batch, h2, w2, 64), 64, False, True, "elu"),
        ("tail.conv1", "up2_reflect", (batch, h2, w2, 64), 32, False, True, "elu"),
        ("tail.conv2", "reflect", (batch, HEIGHT, WIDTH, 32), 32, False, True, "elu"),
    ]


def site_inputs(site, dtype, seed):
    """Seeded (x, w, b, residual) on the card.  block4's two conv1 halves get
    w as an input-channel slice view of one contiguous [Co, 2Ci, 3, 3]
    weight (up half first), as nn/blocks.py passes them."""
    name, pad_mode, shape, co, with_res, with_bias, _ = site
    g = torch.Generator().manual_seed(seed)
    n, h, w_, ci = shape
    ho, wo = (h, w_) if pad_mode == "reflect" else (2 * h, 2 * w_)
    halves = name.startswith("block4.post.conv1.")
    x = torch.randn(shape, generator=g)
    w = torch.randn(co, 2 * ci if halves else ci, 3, 3, generator=g) / (3 * ci ** 0.5)
    b = torch.randn(co, generator=g) if with_bias else None
    r = torch.randn(n, ho, wo, co, generator=g) if with_res else None
    x, w, b, r = [None if t is None else t.to("cuda", dtype) for t in (x, w, b, r)]
    if halves:
        w = w[:, :ci] if name.endswith("up_half") else w[:, ci:]
    return x, w, b, r


def time_ms(fn, iters=20, warmup=3):
    """Mean time of fn() over `iters` back-to-back eager calls (CUDA events),
    the method of the port's first kernel's times.  Where one call's device
    work is shorter than its host work, this is the host's time per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20, reps=3):
    """Device time of one fn() call: `iters` calls captured in a CUDA graph,
    each replay timed with CUDA events (host launch work excluded), the mean
    over `reps` replays."""
    fn()  # warm up outside the capture (builds, allocator)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.mean(times)


def site_taps(pad_mode):
    """Taps per output pixel the function needs, which the kernel does:
    conv3x3(reflect_pad(nearest_up2(x))) is, for each of the 4 output
    phases, an exact 2x2 conv on the low-res input (the edge-pad identity),
    so an up site needs 4 taps."""
    return 9 if pad_mode == "reflect" else 4


def site_flops(site):
    _, pad_mode, (n, h, w_, ci), co, _, _, _ = site
    outputs = n * h * w_ * (1 if pad_mode == "reflect" else 4)
    return 2 * site_taps(pad_mode) * ci * co * outputs


def bounds(site, x, w, b, r):
    """Least times (ms) of the work the site's function needs in x's dtype,
    each input read once and the output written once: {"ops_ffma_ms",
    "ops_tc_ms", "bytes_ms"}.  f32 counts 3 TF32 products per MAC on the
    tensor cores (the f32-accurate route); bf16 one bf16 product."""
    _, pad_mode, (n, h, w_, _), co, _, _, _ = site
    ho, wo = (h, w_) if pad_mode == "reflect" else (2 * h, 2 * w_)
    flops = site_flops(site)
    nbytes = sum(t.numel() * t.element_size() for t in (x, w, b, r) if t is not None)
    nbytes += n * ho * wo * co * x.element_size()
    tc = (TF32_PRODUCTS_PER_MAC * flops / PEAK_TF32_FLOPS if x.dtype == torch.float32
          else flops / PEAK_BF16_FLOPS)
    return {"ops_ffma_ms": flops / PEAK_F32_FLOPS * 1e3, "ops_tc_ms": tc * 1e3,
            "bytes_ms": nbytes / PEAK_BYTES * 1e3}


def library_call(site, x, w, b):
    """cuDNN F.conv2d(F.pad(...)) of the site (TF32 off) in x's dtype: a
    yardstick only."""
    xc = x.permute(0, 3, 1, 2)
    if site[1] == "up2_reflect":
        xc = F.interpolate(xc, scale_factor=2, mode="nearest")
    return F.conv2d(F.pad(xc, (1, 1, 1, 1), mode="reflect"), w, b)


def phase_sites(fail):
    """Kernel vs plain at every site, f32 and bf16.  Returns the f32 max
    abs error."""
    worst = 0.0
    for si, site in enumerate(sites(batch=4)):
        name, pad_mode, _, _, _, _, act = site
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            x, w, b, r = site_inputs(site, dtype, seed=100 + si)
            f32 = [None if t is None else t.float() for t in (x, w, b, r)]
            with torch.no_grad():
                got = fused_conv3x3(x, w, b, r, pad_mode=pad_mode, act=act).float()
                ref = fused_conv3x3_plain(*f32, pad_mode=pad_mode, act=act)
            torch.cuda.synchronize()
            diff = (got - ref).abs()
            max_abs = diff.max().item()
            max_rel = (diff / ref.abs().clamp_min(1e-3)).max().item()
            ok = bool(torch.isfinite(got).all()) and bool(
                (diff <= tol + tol * ref.abs()).all())
            fail.check(ok, f"{name} {dtype}: kernel disagrees with plain "
                           f"(max abs {max_abs}, max rel {max_rel})")
            if dtype == torch.float32:
                worst = max(worst, max_abs)
            emit("sites", site=name, dtype=str(dtype).replace("torch.", ""),
                 route=ROUTES[dtype],
                 shape=list(x.shape), co=w.shape[0], max_abs_err=max_abs,
                 max_rel_err=max_rel, atol=tol, rtol=tol, ok=ok)
    return worst


def phase_main(fail, workdir):
    """Serve a seeded model through predict_simple on the default device."""
    weights = os.path.join(workdir, "weights")
    os.makedirs(weights)
    net = FootprintNetwork(34, generator=torch.Generator().manual_seed(SEED))
    torch.save(net.state_dict(), os.path.join(weights, "model.pth"))

    have_pil = importlib.util.find_spec("PIL") is not None
    if have_pil:
        route = "predict_simple.main"
        targets = {"single": os.path.join(REPO, "test_data", "cyclist.jpg"),
                   "folder": os.path.join(REPO, "test_data")}
    else:
        # no image decoder on this host: drive the CLI's InferenceManager on
        # a seeded array through the method the CLI calls after decoding
        route = "InferenceManager.predict_arrays (no PIL)"
        targets = {"arrays": np.random.RandomState(SEED).rand(
            HEIGHT, WIDTH, 3).astype(np.float32)}

    def serve(tag, device):
        """One CLI run on `device`: (its output dir, its kernel launches)."""
        out = os.path.join(workdir, f"{tag}_{device}")
        before = fused_conv3x3.launches
        if have_pil:
            predict_simple.main(["--image", targets[tag], "--model_path", weights,
                                 "--no_save_vis", "--save_dir", out,
                                 "--device", device])
        else:
            predict_simple.InferenceManager(
                None, out, save_visualisations=False, model_load_folder=weights,
                device=device).predict_arrays([tag], [targets[tag]])
        return os.path.join(out, "outputs"), fused_conv3x3.launches - before

    # each GPU run has a CPU twin (the plain versions) on the same input and
    # weights; the CPU runs launch no kernel
    fused_conv3x3.launches = 0
    runs = [(tag, serve(tag, "cuda"), serve(tag, "cpu")) for tag in targets]
    torch.cuda.synchronize()
    launches = fused_conv3x3.launches

    n_files, worst_mae = 0, 0.0
    for tag, (out, n_launch), (cpu_out, n_cpu) in runs:
        fail.check(n_launch == LAUNCHES_PER_FORWARD and n_cpu == 0,
                   f"{tag}: {n_launch} kernel launches for one batch on the GPU "
                   f"(expected {LAUNCHES_PER_FORWARD}), {n_cpu} on the CPU")
        files = sorted(os.listdir(out))
        fail.check(len(files) > 0 and files == sorted(os.listdir(cpu_out)),
                   f"{tag}: outputs {files} vs CPU {sorted(os.listdir(cpu_out))}")
        for f in files:
            pred = np.load(os.path.join(out, f))
            n_files += 1
            ok = (pred.shape == (4, HEIGHT, WIDTH) and pred.dtype == np.float32
                  and np.isfinite(pred).all())
            fail.check(ok, f"{tag}/{f}: shape {pred.shape} {pred.dtype}, finite="
                           f"{np.isfinite(pred).all()}")
            if ok and os.path.exists(os.path.join(cpu_out, f)):
                mae = float(np.abs(pred - np.load(os.path.join(cpu_out, f))).mean())
                worst_mae = max(worst_mae, mae)
                fail.check(mae < 1e-4, f"{tag}/{f}: GPU vs CPU npy MAE {mae}")
    emit("main", route=route, runs=[r[0] for r in runs], outputs=n_files,
         launches=launches, launches_per_batch=[r[1][1] for r in runs],
         npy_gpu_vs_cpu_max_mae=worst_mae, bar=1e-4)

    # the GPU forward against the CPU forward (plain versions) at every scale
    gpu = ModelManager(is_inference=True, device="cuda")
    gpu.load_model(weights)
    cpu = ModelManager(is_inference=True, device="cpu")
    cpu.load_model(weights)
    x = torch.from_numpy(np.random.RandomState(SEED + 1).rand(
        2, HEIGHT, WIDTH, 3).astype(np.float32))
    with torch.inference_mode():
        got = gpu.net(x.cuda())
        ref = cpu.net(x)
    maes = {}
    for k in SCALES:
        maes[k] = (got[k].float().cpu() - ref[k]).abs().mean().item()
        fail.check(maes[k] < 1e-4, f"GPU vs CPU forward at scale {k}: MAE {maes[k]}")
    emit("main", gpu_vs_cpu_mae=maes, bar=1e-4)
    return launches, gpu.net


def phase_times(net):
    """Per-site times at the main path's batch of 4, then the forward.
    Returns the kernel's totals over one forward's 10 launches."""
    totals = {k: 0.0 for k in ("ms", "ms_bf16", "graph_ms", "graph_ms_bf16", "plain_ms",
                               "library_ms", "library_ms_bf16", "bound_ms", "ops_ms",
                               "bytes_ms", "bound_ffma_ms", "bound_tc_ms",
                               "bound_tc_bf16_ms")}
    for si, site in enumerate(sites(batch=4)):
        name, pad_mode, _, _, _, _, act = site
        x, w, b, r = site_inputs(site, torch.float32, seed=200 + si)
        xb, wb, bb, rb = site_inputs(site, torch.bfloat16, seed=200 + si)
        # the library call gets contiguous weights, made outside its timing
        wc, wbc = w.contiguous(), wb.contiguous()

        def kernel():
            return fused_conv3x3(x, w, b, r, pad_mode=pad_mode, act=act)

        def kernel_bf16():
            return fused_conv3x3(xb, wb, bb, rb, pad_mode=pad_mode, act=act)

        with torch.no_grad():
            t_kernel = time_ms(kernel)
            t_kernel_bf16 = time_ms(kernel_bf16)
            t_graph = graph_ms(kernel)
            t_graph_bf16 = graph_ms(kernel_bf16)
            t_plain = time_ms(lambda: fused_conv3x3_plain(x, w, b, r, pad_mode=pad_mode, act=act))
            t_lib = time_ms(lambda: library_call(site, x, wc, b))
            t_lib_bf16 = time_ms(lambda: library_call(site, xb, wbc, bb))
        f32, bf16 = bounds(site, x, w, b, r), bounds(site, xb, wb, bb, rb)
        bound_ffma = max(f32["ops_ffma_ms"], f32["bytes_ms"])
        bound_tc = max(f32["ops_tc_ms"], f32["bytes_ms"])
        bound_tc_bf16 = max(bf16["ops_tc_ms"], bf16["bytes_ms"])
        # the least time this card could take for the f32-accurate work
        t_ops = min(f32["ops_ffma_ms"], f32["ops_tc_ms"])
        t_bound = max(t_ops, f32["bytes_ms"])
        bound_by = "operations" if t_ops >= f32["bytes_ms"] else "bytes"
        for key, v in (("ms", t_kernel), ("ms_bf16", t_kernel_bf16),
                       ("graph_ms", t_graph), ("graph_ms_bf16", t_graph_bf16),
                       ("plain_ms", t_plain), ("library_ms", t_lib),
                       ("library_ms_bf16", t_lib_bf16), ("bound_ms", t_bound),
                       ("ops_ms", t_ops), ("bytes_ms", f32["bytes_ms"]),
                       ("bound_ffma_ms", bound_ffma), ("bound_tc_ms", bound_tc),
                       ("bound_tc_bf16_ms", bound_tc_bf16)):
            totals[key] += 2 * v  # the site runs once in each decoder
        emit("times", kernel=KERNEL["name"], site=name, shape=list(x.shape),
             co=w.shape[0], launches_per_forward=2, route=ROUTES[torch.float32],
             ms=t_kernel, graph_ms=t_graph, plain_ms=t_plain, library_ms=t_lib,
             bound_ffma_ms=bound_ffma, bound_tc_ms=bound_tc, bound_ms=t_bound,
             bound_by=bound_by, share_of_bound=t_bound / t_kernel,
             tflops_done=site_flops(site) / (t_kernel * 1e-3) / 1e12,
             route_bf16=ROUTES[torch.bfloat16], ms_bf16=t_kernel_bf16,
             graph_ms_bf16=t_graph_bf16,
             library_ms_bf16=t_lib_bf16, bound_tc_bf16_ms=bound_tc_bf16,
             share_of_bound_bf16=bound_tc_bf16 / t_kernel_bf16)

    stats = {}
    for batch in (16, 1):
        x = torch.rand(batch, HEIGHT, WIDTH, 3, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(batch))
        with torch.inference_mode():
            def forward():
                return net(x, scales=("1/1",))
            if batch == 16:
                ms = time_ms(forward, iters=10)
                stats["forward_b16_ms"] = ms
                stats["imgs_per_s_b16"] = 16 / (ms * 1e-3)
            else:
                for _ in range(3):
                    forward()
                lat = []
                for _ in range(30):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    forward()
                    torch.cuda.synchronize()
                    lat.append((time.perf_counter() - t0) * 1e3)
                stats["single_image_p50_ms"] = statistics.median(lat)
    emit("times", kernel=KERNEL["name"], per_forward_at_batch=4,
         share_of_bound=totals["bound_ms"] / totals["ms"],
         share_of_bound_bf16=totals["bound_tc_bf16_ms"] / totals["ms_bf16"],
         **totals)
    emit("times", forward="FootprintNetwork-34 serving forward ('1/1' head), f32",
         **stats)
    return totals


def kernel_category(name):
    """Coarse bucket of a device kernel's name for the time breakdown."""
    if "fused_conv3x3" in name:
        return "fused_conv3x3"
    if "nhwcToNchw" in name or "nchwToNhwc" in name:
        return "cudnn layout transform"
    if "bn_fw" in name:
        return "batch norm"
    if any(s in name for s in ("xmma", "fft", "convolve", "pointwise_mult_and_sum")):
        return "cudnn conv"
    if "reflection_pad" in name:
        return "reflect pad"
    if "copy" in name or "Cat" in name:
        return "copy / cat"
    return "other"


def phase_profile(net):
    """Device time by kernel over 5 serving forwards at batch 16, and the
    share of the wall time in which no kernel ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.rand(16, HEIGHT, WIDTH, 3, device="cuda")
    with torch.inference_mode():
        for _ in range(2):
            net(x, scales=("1/1",))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                net(x, scales=("1/1",))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 5
    rows = [{"name": evt.key[:120], "count": evt.count // 5,
             "device_ms_per_forward": evt.self_device_time_total / 1e3 / 5}
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0]
    rows.sort(key=lambda r: -r["device_ms_per_forward"])
    busy = sum(r["device_ms_per_forward"] for r in rows)
    by_category = {}
    for r in rows:
        cat = kernel_category(r["name"])
        by_category[cat] = by_category.get(cat, 0.0) + r["device_ms_per_forward"]
    summary = {"wall_ms_per_forward": wall_ms, "kernel_ms_per_forward": busy,
               "idle_share": 1 - busy / wall_ms,
               "ms_by_category": by_category}
    os.makedirs(os.path.join(REPO, "smoke_out"), exist_ok=True)
    with open(os.path.join(REPO, "smoke_out", "profile_b16.json"), "w") as f:
        json.dump({**summary, "kernels": rows}, f, indent=1)
    emit("profile", **summary, top=rows[:10])


# --- training -----------------------------------------------------------------

def make_kitti_tree(root, n_frames, n_val, seed):
    """A synthetic KITTI tree laid out as the trainer reads it (the layout of
    tests/test_trainer_e2e.py), at KITTI's raw frame size: jpg frames and
    the ground_seg, hidden_depths, depth_masks, moving_objects and
    stereo_matching_disps npys.  Returns (paths.yaml, split root)."""
    import yaml
    from PIL import Image

    rng = np.random.RandomState(seed)
    raw, td = os.path.join(root, "raw"), os.path.join(root, "training_data")
    h, w = KITTI_RAW_HW
    lines = []
    for i in range(n_frames):
        side = "l" if i % 2 == 0 else "r"
        cam = "image_02" if side == "l" else "image_03"
        frame = str(i).zfill(10)
        lines.append(f"seq0 {i} {side}")
        folder = os.path.join(raw, "seq0", cam, "data")
        os.makedirs(folder, exist_ok=True)
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(folder, frame + ".jpg"))
        maps = {"ground_seg": rng.rand(h, w).astype(np.float32),
                "hidden_depths": (rng.rand(h, w) * 20).astype(np.float32),
                "depth_masks": (rng.rand(h, w) > 0.97).astype(np.uint8),
                "moving_objects": (rng.rand(h, w) > 0.95).astype(np.uint8)}
        for sub, val in maps.items():
            folder = os.path.join(td, sub, "seq0", cam, "data")
            os.makedirs(folder, exist_ok=True)
            np.save(os.path.join(folder, frame + ".npy"), val)
        folder = os.path.join(td, "stereo_matching_disps", "seq0", cam)
        os.makedirs(folder, exist_ok=True)
        np.save(os.path.join(folder, frame + ".npy"),
                (rng.rand(h, w) * 50 + 5).astype(np.float32))
    splits = os.path.join(root, "splits")
    os.makedirs(os.path.join(splits, "kitti"))
    with open(os.path.join(splits, "kitti", "train.txt"), "w") as f:
        f.write("\n".join(lines))
    with open(os.path.join(splits, "kitti", "val.txt"), "w") as f:
        f.write("\n".join(lines[:n_val]))
    config = os.path.join(root, "paths.yaml")
    with open(config, "w") as f:
        yaml.safe_dump({"kitti": {"dataset": raw, "training_data": td}}, f)
    return config, splits


class InMemorySamples:
    """Seeded samples with the shapes, dtypes and value sets of
    KITTIDataset's output at 192x640 (the route without PIL/OpenCV/PyYAML)."""

    def __init__(self, n, seed):
        self.n, self.seed = n, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed + i)
        hw = (HEIGHT, WIDTH)
        out = {"image": rng.randint(0, 256, (*hw, 3)).astype(np.float32) / 255.0,
               "visible_ground": (rng.rand(*hw) > 0.5).astype(np.float32),
               "depth": (rng.rand(*hw) * 40).astype(np.float32),
               "ground_depth": (rng.rand(*hw) * 20).astype(np.float32),
               "moving_object_mask": (rng.rand(*hw) > 0.95).astype(np.float32),
               "depth_mask": (rng.rand(*hw) > 0.97).astype(np.float32)}
        out["all_ground"] = ((out["ground_depth"] + out["visible_ground"]) > 0
                             ).astype(np.float32)
        return out


class InMemoryTrainManager(TrainManager):
    def create_dataloaders(self):
        bs = self.opt.batch_size
        return (DataLoader(InMemorySamples(bs * TRAIN_STEPS, 0), bs, shuffle=True,
                           num_workers=self.opt.num_workers, seed=TRAIN_SEED),
                DataLoader(InMemorySamples(bs, 10_000), bs, shuffle=True,
                           num_workers=2, drop_last=True, seed=TRAIN_SEED))


def finite_losses(losses):
    return all(np.isfinite(v) for v in losses.values())


def train_step_on(device, host, dtype=torch.float32):
    """One train step of the seeded FootprintNetwork-34 on `device` in
    `dtype` (f64 only on the CPU, the plain versions): (loss metrics as
    floats, f64 grads by name on the CPU, BN running stats)."""
    mm = ModelManager(device=device, seed=SEED, steps_per_epoch=TRAIN_STEPS)
    mm.net.to(dtype)  # in place: the optimizer keeps the same parameters
    step = build_train_step(mm.net, mm.optimizer, mm.config)
    metrics = step(0, {k: torch.from_numpy(v).to(device, dtype)
                       for k, v in host.items()})
    grads = {n: p.grad.detach().cpu().double() for n, p in mm.net.named_parameters()
             if p.grad is not None}
    stats = {k: v.detach().cpu().double() for k, v in mm.net.state_dict().items()
             if "running" in k}
    return {k: float(v) for k, v in metrics.items() if k != "lr"}, grads, stats


def worst_grad_leaf(got, ref):
    """(leaf, ||got - ref|| / ||ref||) of the worst gradient leaf."""
    rel = {k: float((got[k] - v).norm() / v.norm().clamp_min(1e-30))
           for k, v in ref.items()}
    leaf = max(rel, key=rel.get)
    return leaf, rel[leaf]


def phase_train(fail, workdir):
    """Train through the entry point; resume; hold a GPU step against a
    CPU step.  Returns (launches, a batch-12 host batch, the epoch stats)."""
    have_data_libs = all(importlib.util.find_spec(m) is not None
                         for m in ("PIL", "cv2", "yaml"))
    log_path = os.path.join(workdir, "train_logs")
    argv = ["--mode", "train", "--training_dataset", "kitti",
            "--height", str(HEIGHT), "--width", str(WIDTH),
            "--batch_size", str(TRAIN_BATCH), "--epochs", "1",
            "--val_batches", str(VAL_BATCHES), "--host_batch_compact", "exact",
            "--encoder_depth", "34", "--num_workers", "8", "--device", "cuda",
            "--log_path", log_path, "--model_name", "smoke"]
    t0 = time.perf_counter()
    if have_data_libs:
        route = (f"footprints_tpu_torch.main.main (synthetic KITTI tree, "
                 f"{KITTI_RAW_HW[0]}x{KITTI_RAW_HW[1]} frames)")
        config, splits = make_kitti_tree(os.path.join(workdir, "kitti"),
                                         TRAIN_BATCH * TRAIN_STEPS, TRAIN_BATCH, SEED)
        argv += ["--config_path", config, "--split_root", splits]
        manager_class = TrainManager
    else:
        route = "TrainManager with in-memory samples (no PIL/OpenCV/PyYAML)"
        argv += ["--config_path", "unused"]
        manager_class = InMemoryTrainManager
    tree_s = time.perf_counter() - t0

    # the main path: counts set to 0 just before, read just after
    fused_conv3x3.launches = 0
    torch.cuda.reset_peak_memory_stats()
    if have_data_libs:
        tm = train_main.main(argv)
    else:
        tm = InMemoryTrainManager(Options().parse(argv))
        tm.train()
    torch.cuda.synchronize()
    launches = fused_conv3x3.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    n_val_events = sum(1 for mode, _, _ in tm.logged if mode == "val")
    expected = LAUNCHES_PER_FORWARD * (TRAIN_STEPS + VAL_BATCHES * n_val_events)
    fail.check(n_val_events == 1 and launches == expected,
               f"train: {launches} kernel launches, expected {expected} "
               f"(10 per training forward, 10 per validation forward; "
               f"{n_val_events} validation events)")
    fail.check(tm.step == TRAIN_STEPS, f"train: step {tm.step}, expected {TRAIN_STEPS}")
    rest = tm.evaluator.get_averaged_losses("train")
    fail.check(all(finite_losses(losses) for _, _, losses in tm.logged)
               and finite_losses(rest) and len(tm.logged) == 2,
               f"train: logged losses {tm.logged}, later steps {rest}")
    weights = os.path.join(log_path, "smoke", "models", "weights_0")
    ckpt = os.path.join(weights, "checkpoint.npz")
    ok = os.path.exists(ckpt)
    if ok:
        loaded = load_checkpoint(ckpt)
        ok = (int(loaded["step"]) == TRAIN_STEPS
              and int(loaded["opt_state"][0][0]) == TRAIN_STEPS
              and all(np.isfinite(a).all() for a in (loaded["opt_state"][0][1],
                                                     loaded["opt_state"][0][2])))
    fail.check(ok, f"train: {ckpt} missing or not at step {TRAIN_STEPS}")

    # resume: a second manager restores the step and the Adam moments
    tm2 = manager_class(Options().parse(argv + ["--load_path", weights]))
    (count, mu, nu), _ = tm.model_manager.train_state()["opt_state"]
    (count2, mu2, nu2), _ = tm2.model_manager.train_state()["opt_state"]
    fail.check(tm2.step == TRAIN_STEPS and int(count2) == int(count) == TRAIN_STEPS
               and np.array_equal(mu, mu2) and np.array_equal(nu, nu2),
               f"train: resume gave step {tm2.step}, Adam count {int(count2)}")

    host = next(iter(tm.train_loader))
    # the check's batch: the first validation samples (no augmentation, so
    # the same batch in every run)
    small = collate([tm.val_loader.dataset[i] for i in range(CHECK_BATCH)])
    for m in (tm, tm2):
        m.val_iter.close()
    emit("train", route=route, steps=tm.step, batch=TRAIN_BATCH,
         shape=[HEIGHT, WIDTH], depth=34, launches=launches,
         launches_expected=expected, logged=[[m, s, l["loss"]] for m, s, l in tm.logged],
         checkpoint=os.path.relpath(ckpt, workdir), resumed_step=tm2.step,
         peak_memory_gib_b12=peak_gib, tree_seconds=tree_s,
         epoch_seconds=tm.train_seconds)

    # one GPU step against one CPU step from the same weights and batch.
    # The CPU reference step runs in f64: at batch 2 the deep encoder's
    # gradients pass through train-mode BN's near-cancelling backward, where
    # an f32 step (CPU or GPU) sits several 1e-3 from the exact one, so two
    # f32 steps can differ by the whole bar.
    m_gpu, g_gpu, s_gpu = train_step_on("cuda", small)
    m_ref, g_ref, s_ref = train_step_on("cpu", small, torch.float64)
    loss_ok = all(abs(m_gpu[k] - v) <= 1e-5 + 1e-5 * abs(v) for k, v in m_ref.items())
    worst_loss = max(abs(m_gpu[k] - v) for k, v in m_ref.items())
    leaf, rel = worst_grad_leaf(g_gpu, g_ref)
    bn_err = max(float((s_gpu[k] - v).abs().max()) for k, v in s_ref.items())
    fail.check(loss_ok, f"train: GPU vs CPU loss terms differ by up to {worst_loss}")
    fail.check(g_gpu.keys() == g_ref.keys() and rel < 2e-2,
               f"train: GPU vs CPU gradient of {leaf}: {rel}")
    fail.check(bn_err <= 1e-5, f"train: GPU vs CPU BN running stats differ by {bn_err}")
    emit("train", gpu_vs_cpu_step=dict(
        batch=CHECK_BATCH, shape=[HEIGHT, WIDTH], reference="CPU, f64",
        loss_max_abs_err=worst_loss, loss_bar="1e-5 + 1e-5|ref|",
        worst_grad_leaf=leaf, worst_grad_rel=rel, grad_bar=2e-2,
        bn_max_abs_err=bn_err, bn_bar=1e-5, loss=m_gpu["loss"], loss_ref=m_ref["loss"]))
    epoch = {"epoch_seconds": tm.train_seconds,
             "trainer_imgs_per_s": TRAIN_STEPS * TRAIN_BATCH / tm.train_seconds}
    return launches, host, epoch


def train_kernel_category(name):
    """Coarse bucket of a device kernel's name for the train-step breakdown."""
    n = name.lower()
    if "fused_conv3x3" in n:
        return "fused_conv3x3"
    if "dgrad" in n:
        return "cudnn dgrad"
    if "wgrad" in n:
        return "cudnn wgrad"
    if "fft" in n:
        return "cudnn fft conv (fwd or bwd)"
    if any(k in n for k in ("fprop", "convolve", "implicit_gemm", "xmma",
                            "pointwise_mult_and_sum")):
        return "cudnn forward conv"
    if any(k in n for k in ("bn_", "batch_norm", "batchnorm", "welford")):
        return "batch norm"
    if "multi_tensor_apply" in n or "adam" in n:
        return "adam (foreach)"
    if any(k in n for k in ("copy", "cat", "nhwctonchw", "nchwtonhwc", "transpose")):
        return "copies / layout"
    if any(k in n for k in ("reflection_pad", "upsample")):
        return "pads / upsample"
    if any(k in n for k in ("elementwise", "reduce", "elu", "sigmoid", "softplus")):
        return "elementwise / reductions"
    return "other"


def site_backward(fail, batch):
    """At each fused site at `batch`, on the card: the kernel's output and
    the autograd Function's gradients for x, the full weight, b and the
    residual, held against autograd through fused_conv3x3_plain in f64 on
    the same tensors, beside the f32 plain version's own distance to that
    reference (TF32 off); then the kernel's forward (no graph) and the
    Function's backward (cuDNN dgrad + wgrad and the pad / upsample
    adjoints) timed, ms per call.  Bars: the output, x and the residual
    within 1e-4 + 1e-4|ref| (those of tests/test_torch_cuda.py).  Each entry
    of the weight and bias gradients sums N H W products (368640 to 1474560
    here; about 1000 in the card tests, whose weight bars are 10x tighter).
    On an H100, cuDNN's f32 wgrad of the plain version itself sits about
    3e-5 (norm) from f64 at block4 (printed as plain_f32_rel), so the bars
    are 1e-3 max|ref| + 1e-3|ref| elementwise and ||d||/||ref|| < 1e-4:
    about 3x above that floor, and far below a wrong adjoint or slice."""
    rows = []
    for si, site in enumerate(sites(batch)):
        name, pad_mode, _, _, _, _, act = site
        x, w, b, r = site_inputs(site, torch.float32, seed=300 + si)
        halves = w._base is not None  # block4's halves: slices of one weight
        ci = x.shape[-1]
        inputs = {k: t for k, t in (("x", x), ("w", w._base if halves else w),
                                    ("b", b), ("residual", r)) if t is not None}

        def weight(full):
            if not halves:
                return full
            return full[:, :ci] if name.endswith("up_half") else full[:, ci:]

        def leaves(dtype):
            return {k: t.detach().to(dtype).requires_grad_(True)
                    for k, t in inputs.items()}

        def plain(ls):
            return fused_conv3x3_plain(ls["x"], weight(ls["w"]), ls.get("b"),
                                       ls.get("residual"), pad_mode=pad_mode, act=act)

        ls = leaves(torch.float32)
        if pad_mode == "up2_reflect":
            y = fc.up_conv_fused(ls["x"], weight(ls["w"]), ls.get("b"), act=act)
        elif r is not None:
            y = fc.conv_reflect_res_fused(ls["x"], weight(ls["w"]), ls["b"],
                                          ls["residual"], act=act)
        else:
            y = fc.conv_reflect_fused(ls["x"], weight(ls["w"]), ls["b"], act=act)
        gy = torch.randn(y.shape, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(400 + si))
        got = torch.autograd.grad(y, list(ls.values()), gy, retain_graph=True)
        y32 = plain(ls)
        got32 = torch.autograd.grad(y32, list(ls.values()), gy)
        ls64 = leaves(torch.float64)
        y64 = plain(ls64)
        ref = torch.autograd.grad(y64, list(ls64.values()), gy.double())
        errs = {}
        for k, a, a32, e in [("y", y, y32, y64), *zip(ls, got, got32, ref)]:
            a, a32, e = a.detach().double(), a32.detach().double(), e.detach()
            d = (a - e).abs()
            rel = float((a - e).norm() / e.norm())
            if k in ("w", "b"):
                ok = bool((d <= 1e-3 * e.abs().max() + 1e-3 * e.abs()).all()) and rel < 1e-4
            else:
                ok = bool((d <= 1e-4 + 1e-4 * e.abs()).all())
            errs[k] = {"max_abs": d.max().item(), "rel": rel,
                       "plain_f32_rel": float((a32 - e).norm() / e.norm())}
            fail.check(ok and bool(torch.isfinite(a).all()),
                       f"train_times: {name} at batch {batch}: {k} of the fused "
                       f"path vs the f64 plain version, {errs[k]}")
        del y32, y64, got, got32, ref, ls64
        fixed = [None if t is None else t.detach()
                 for t in (ls["x"], weight(ls["w"]), ls.get("b"), ls.get("residual"))]

        def forward():
            with torch.no_grad():
                return fused_conv3x3(*fixed, pad_mode=pad_mode, act=act)

        def backward():
            return torch.autograd.grad(y, list(ls.values()), gy, retain_graph=True)

        rows.append({"site": name, "err_vs_f64": errs, "forward_ms": time_ms(forward),
                     "backward_ms": time_ms(backward)})
    return rows


def cudnn_batch_probe():
    """cuDNN's f32 time (TF32 off, default heuristics) for the decoder's
    block2 post-concat conv1, reflect-padded [N,256,26,82] * [128,256,3,3]
    as the model calls it, at several batch sizes: ms per call, mean of 5."""
    out = {}
    w = torch.randn(128, 256, 3, 3, device="cuda") * 0.02
    for n in (4, 8, 12, 16):
        x = torch.randn(n, 256, 26, 82, device="cuda")
        out[f"batch_{n}_ms"] = time_ms(lambda: F.conv2d(x, w), iters=5, warmup=2)
    return out


def phase_train_times(fail, host, epoch):
    """The train step's time, memory and breakdown at batch 12."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mm = ModelManager(device="cuda", seed=SEED, steps_per_epoch=TRAIN_STEPS)
    step = build_train_step(mm.net, mm.optimizer, mm.config)
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: step(0, batch), iters=10, warmup=3)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # forward+loss / backward / Adam, split by CUDA events, mean of 5 steps
    split = {"forward_loss_ms": 0.0, "backward_ms": 0.0, "adam_ms": 0.0}
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        losses = compute_losses(mm.net(batch["image"]), batch, mm.config.loss)
        ev[1].record()
        mm.optimizer.zero_grad(set_to_none=True)
        losses["loss"].backward()
        ev[2].record()
        mm.optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        for i, key in enumerate(split):
            split[key] += ev[i].elapsed_time(ev[i + 1]) / 5

    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        start.record()
        step(0, batch)
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    # the operators that launched the device time, by input shape
    ops = [{"op": evt.key, "shapes": str(evt.input_shapes)[:160], "count": evt.count,
            "device_ms": evt.self_device_time_total / 1e3}
           for evt in prof.key_averages(group_by_input_shape=True)
           if evt.device_type == DeviceType.CPU and evt.key.startswith("aten::")
           and evt.self_device_time_total > 0]
    ops.sort(key=lambda r: -r["device_ms"])
    rows = [{"name": evt.key[:160], "count": evt.count,
             "device_ms": evt.self_device_time_total / 1e3}
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0]
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    by_category = {}
    for r in rows:
        cat = train_kernel_category(r["name"])
        by_category[cat] = by_category.get(cat, 0.0) + r["device_ms"]
    fail.check(busy > 0, "train_times: the profiler saw no device time")
    # the profiled step's own span (CUDA events), which the tracing slows
    # too; unclamped, so a kernel total above the span would show
    summary = {"wall_ms_per_step": wall_ms, "kernel_ms_per_step": busy,
               "idle_share": 1 - busy / wall_ms, "step_ms_unprofiled": ms,
               "ms_by_category": dict(sorted(by_category.items(), key=lambda kv: -kv[1]))}
    os.makedirs(os.path.join(REPO, "smoke_out"), exist_ok=True)
    with open(os.path.join(REPO, "smoke_out", "profile_train_b12.json"), "w") as f:
        json.dump({**summary, "kernels": rows, "ops": ops}, f, indent=1)

    site_rows = site_backward(fail, TRAIN_BATCH)
    emit("train_times", train_step_ms_b12=ms,
         train_imgs_per_s_b12=TRAIN_BATCH / (ms * 1e-3),
         peak_memory_gib_b12=peak_gib, **split, **epoch)
    emit("train_times", kernel=KERNEL["name"], batch=TRAIN_BATCH,
         launches_per_step_forward=LAUNCHES_PER_FORWARD, launches_per_step_backward=0,
         sites=site_rows, reference="autograd of the plain version, f64, same tensors",
         bars={"y, x, residual": "1e-4 + 1e-4|ref|",
               "w, b": "1e-3 max|ref| + 1e-3|ref|, ||d||/||ref|| < 1e-4"},
         forward_ms_per_step=2 * sum(r["forward_ms"] for r in site_rows),
         backward_ms_per_step=2 * sum(r["backward_ms"] for r in site_rows))
    emit("train_times", profile=summary, top=rows[:12], top_ops=ops[:8])
    emit("train_times", cudnn_probe=cudnn_batch_probe())



def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    fail = Failures()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    build.build(verbose=True)
    build.load_library()
    emit("build", seconds=time.perf_counter() - t0, library=str(build.library_path()))

    max_abs = phase_sites(fail)
    with tempfile.TemporaryDirectory() as workdir:
        launches, net = phase_main(fail, workdir)
    totals = phase_times(net)
    phase_profile(net)
    del net
    with tempfile.TemporaryDirectory() as workdir:
        train_launches, host, epoch = phase_train(fail, workdir)
    phase_train_times(fail, host, epoch)
    launches += train_launches

    if fail:
        print(f"chip_smoke: {len(fail)} check(s) failed", file=sys.stderr)
        return 1
    kernels = [{**KERNEL, "launches": launches, "max_abs_err": max_abs,
                "ms": totals["ms"], "plain_ms": totals["plain_ms"],
                "bound_ms": totals["bound_ms"],
                "bound_by": ("operations" if totals["ops_ms"] >= totals["bytes_ms"]
                             else "bytes"),
                "library_ms": totals["library_ms"]}]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
