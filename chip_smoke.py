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
              smoke_out/profile_b16.json.

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

from footprints_tpu_torch import predict_simple
from footprints_tpu_torch.model_manager import ModelManager
from footprints_tpu_torch.models import SCALES, FootprintNetwork
from footprints_tpu_torch.ops import build
from footprints_tpu_torch.ops.fused_conv import (fused_conv3x3,
                                                 fused_conv3x3_plain)

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
    gpu = ModelManager(device="cuda")
    gpu.load_model(weights)
    cpu = ModelManager(device="cpu")
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
               "idle_share": max(0.0, 1 - busy / wall_ms),
               "ms_by_category": by_category}
    os.makedirs(os.path.join(REPO, "smoke_out"), exist_ok=True)
    with open(os.path.join(REPO, "smoke_out", "profile_b16.json"), "w") as f:
        json.dump({**summary, "kernels": rows}, f, indent=1)
    emit("profile", **summary, top=rows[:10])


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
