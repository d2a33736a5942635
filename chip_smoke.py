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
              is rounded to bf16), and at the 5 sites of the Matterport
              dump's 512x640 forward, batch 4, in f32;
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
              batch 4, 8, 12 and 16, then for every conv of both models'
              decoders that cuDNN runs (recorded from a forward), at each
              batch, with the default heuristics and with
              torch.backends.cudnn.benchmark on (restored after), and the
              shapes and batches on a cliff (smoke_out/cudnn_probe.json);
  8b. train_bf16  on phase 7's data, main --mode train --compute_dtype
              bfloat16 (the packed heads on by 'auto'): 4 steps and the
              step-0 validation, 50 launches all on the bf16 route, f32
              masters and checkpoint, the packed '@s2d'/'@s2d2' targets on
              the card batch, and a resume; at batch 2 on a seeded noise
              batch, the GPU bf16 step's gradient no farther from an f64
              CPU step than twice a CPU bf16 step's (whole, and each leaf
              plus 1e-3; exact-zero mask logits counted), and the f32 step
              with the packed heads against the one without (loss terms
              1e-6 relative, the whole gradient ||d||/||ref|| < 1e-5,
              beside the same step run twice); then one bf16 step from a
              synthetic torchvision-layout ResNet-34 --pretrained_encoder
              file, its step-0 encoder equal to the file's tensors;
  8c. train_bf16_times  the step alone on a batch on the card, bf16 at
              batch 12 and 16 with and without the packed heads (in turns:
              on, off, off, on) and f32 at 12: ms, imgs/s, peak memory,
              split, and one profiled step's
              busy time (union of device intervals); the trainer with its
              loader (bf16) over 16 batches of 12 after an untimed first,
              and the loader alone;
  9. dump     writes a seeded FootprintNetwork-34 checkpoint.npz and dumps a
              synthetic KITTI test split of 26 frames (375x1242) through
              footprints_tpu_torch.main --mode inference on the GPU at
              192x640, batch 12 (a padded tail of 2): where Pillow and
              PyYAML import, the real dataset; otherwise InferenceManager
              over in-memory images with the same {'image', 'idx'} contract
              and save_result, and the route says so.  Checks the 26 files
              (float16 [4,192,640], finite, sigmoid channels in [0,1]), 10
              launches per batch, the first batch against a --device cpu
              run (2e-3 + 2e-3|cpu|), and the overlapped dump byte-identical
              to the serial one.  Then a Matterport dump at 512x640 (6
              frames, batch 4) on the GPU and its --device cpu twin: every
              file within 2e-3 + 2e-3|cpu| of its twin, and each dump
              scored by footprints_tpu_torch.eval.evaluate (iou and depth,
              download=False) on synthetic npy ground truth: finite, GPU
              and CPU within 1e-2.  Times the dump (loader and writer
              included, host clock ending in a synchronise) over 192 frames
              (the 26, cycled) at batch 12 and 16, serial and overlapped,
              and the block2 post-concat conv's time alone; and profiles
              one overlapped dump at each: the device's busy share and the
              conv's share of the busy and the wall time, each from the
              union of the device events' intervals, beside their summed
              durations and how many of them overlap on one stream;
 10. seg_dump the same for a seeded Segmentor-34 with PSP through
              footprints_tpu_torch.preprocessing.segmentation.main --mode
              inference over the sorted train+val split of the same 26
              frames: the ground_seg tree (float16 [1,192,640] in [0,1]), 5
              launches per batch, overlap byte-identical to serial, the GPU
              forward against the CPU forward at every scale (MAE < 1e-4),
              times and profile at batch 12 and 16;
 11. seg_train  trains a Segmentor-34 with PSP at 192x640, batch 12,
              through footprints_tpu_torch.preprocessing.segmentation.main
              --mode train with its default datasets (ADE20K, cityscapes) on
              synthetic trees: 512x683 ADE20K JPEGs with _seg.png labels and
              2048x1024 Cityscapes PNGs with gtFine labelIds (where Pillow
              and PyYAML import; otherwise the Trainer on in-memory samples,
              and the route says so): 4 steps and the step-0 validation, in
              f32 and then with --compute_dtype bfloat16.  Checks every
              logged loss is finite, 5 launches per training forward and per
              validation forward (in the bf16 run the training forwards' are
              the kernel's bf16 route), f32 master params, epoch_0/
              checkpoint.npz written in f32 and loaded by a second Trainer
              through --load_path; then, at batch 2 on a seeded noise batch,
              one GPU step against an f64 CPU step (the bars of phase 7,
              worst printed beside a CPU f32 step's), and the GPU bf16 step:
              losses within 1e-2 of the f32 step's, its gradient no farther
              from the f64 step than twice a CPU bf16 step's (whole, and
              each leaf plus 1e-3);
 12. seg_train_times  the trainer with its loader (its own epoch loop, no
              log event or validation) in f32 and bf16, and the loader
              alone, each over 16 batches of 12 after an untimed first
              batch; the seg step alone on a batch already on the card, f32
              and bf16, at batch 12 and 16: ms, imgs/s, peak memory, the
              forward / backward / Adam split, and one profiled step's busy
              time with the block2 post-concat conv's share (its forward,
              and its backward, each from the union of the device
              intervals); at each fused site at batch 12, the kernel's bf16
              route and the autograd Function's bf16 gradients against
              autograd through the f32 plain version on the same
              bf16-rounded tensors (output 2e-2 + 2e-2|ref|; gradients
              ||d||/||ref|| < 2e-2 and 2e-2 max|ref| + 2e-2|ref|), then
              timed.

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

from footprints_tpu_torch import main as port_main
from footprints_tpu_torch import predict_simple
from footprints_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from footprints_tpu_torch.convert import segmentor_jax_params_from_state_dict
from footprints_tpu_torch.core.config import readlines
from footprints_tpu_torch.data import DataLoader, collate, get_inference_dataset_class
from footprints_tpu_torch.data.compact import decompact_on_device
from footprints_tpu_torch.eval import evaluate
from footprints_tpu_torch.eval.inference import InferenceManager
from footprints_tpu_torch.model_manager import ModelManager
from footprints_tpu_torch.models import SCALES, FootprintNetwork, Segmentor
from footprints_tpu_torch.nn import resnet
from footprints_tpu_torch.preprocessing.segmentation import datasets as seg_datasets
from footprints_tpu_torch.preprocessing.segmentation import main as seg_main
from footprints_tpu_torch.preprocessing.segmentation import trainer as seg_trainer
from footprints_tpu_torch.preprocessing.segmentation.inference import Tester
from footprints_tpu_torch.preprocessing.segmentation.losses import compute_seg_losses
from footprints_tpu_torch.preprocessing.segmentation.options import Options as SegOptions
from footprints_tpu_torch.ops import build
from footprints_tpu_torch.ops import fused_conv as fc
from footprints_tpu_torch.ops.fused_conv import (fused_conv3x3,
                                                 fused_conv3x3_plain)
from footprints_tpu_torch.options import Options
from footprints_tpu_torch.train.losses import TARGET_KEYS, compute_losses
from footprints_tpu_torch.train.step import (TrainStepConfig, build_train_step, forward_in,
                                             make_optimizer)
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
# the FootprintNetwork trainer's rate with its loader: 16 batches of 12 after
# one untimed batch, as the seg trainer's
TRAIN_TIMED_BATCHES = 16
CHECK_BATCH = 2  # the GPU-vs-CPU train step
KITTI_RAW_HW = (375, 1242)
DUMP_BATCH, DUMP_FRAMES = 12, 26  # options.py's default batch; a padded tail of 2
TIMED_BATCHES = (12, 16)  # the default batch, on cuDNN's f32 cliff, and past it
# the timed dumps cycle through the 26 frames for 16 batches of 12 (12 of 16):
# the loader builds each batch on one thread, so a dump of a few batches
# times mostly the first batch's loading
TIMED_FRAMES = 192
SEG_LAUNCHES_PER_FORWARD = 5  # 5 sites x 1 decoder
MATTERPORT_HW, MATTERPORT_RAW_HW = (512, 640), (1024, 1280)
MATTERPORT_FRAMES, MATTERPORT_BATCH = 6, 4
F16_BAR = 2e-3  # a float16 dump against its CPU twin: 2e-3 + 2e-3|cpu|
# the decoders' block2 post-concat conv1 input, reflect-padded, per image
CLIFF_INPUT = [256, HEIGHT // 8 + 2, WIDTH // 8 + 2]
# segmentation training: segmentation/options.py's default batch and datasets
SEG_TRAIN_BATCH, SEG_TRAIN_STEPS, SEG_VAL_BATCHES = 12, 4, 1
ADE20K_HW, CITYSCAPES_HW = (512, 683), (1024, 2048)
SEG_FILES = 6  # distinct frames per dataset; the split files cycle through them
SEG_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the trainer's rate with its loader: 16 batches of 12 (192 frames, as the
# timed dumps) after one untimed batch
SEG_TIMED_BATCHES = 16
CHECK_SEED = 20_000  # the seg check steps' noise batch (InMemorySegSamples)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


class Failures(list):
    def check(self, ok, what):
        if not ok:
            self.append(what)
            print(f"FAIL: {what}", flush=True)
        return ok


def sites(batch, hw=(HEIGHT, WIDTH)):
    """The kernel's 5 call sites per decoder in the forward at `hw` (192x640
    unless given): (name, pad_mode, input NHWC shape, Co, residual?, bias?,
    act)."""
    height, width = hw
    h2, w2, h4, w4 = height // 2, width // 2, height // 4, width // 4
    return [
        ("block4.post.conv1.up_half", "up2_reflect", (batch, h4, w4, 64), 64, False, False, "none"),
        ("block4.post.conv1.skip_half", "reflect", (batch, h2, w2, 64), 64, True, True, "elu"),
        ("block4.post.conv2", "reflect", (batch, h2, w2, 64), 64, False, True, "elu"),
        ("tail.conv1", "up2_reflect", (batch, h2, w2, 64), 32, False, True, "elu"),
        ("tail.conv2", "reflect", (batch, height, width, 32), 32, False, True, "elu"),
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
    """Kernel vs plain at every site of the 192x640 forward, f32 and bf16,
    and at the Matterport dump's 512x640 sites (batch 4, f32: the dump's
    dtype).  Returns the f32 max abs error."""
    worst = 0.0
    f32, bf16 = (torch.float32, 1e-4), (torch.bfloat16, 2e-2)
    cases = [(site, (f32, bf16)) for site in sites(batch=4)]
    cases += [(site, (f32,)) for site in sites(MATTERPORT_BATCH, MATTERPORT_HW)]
    for si, (site, dtypes) in enumerate(cases):
        name, pad_mode, _, _, _, _, act = site
        for dtype, tol in dtypes:
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

def make_kitti_tree(root, n_frames, n_val, seed, batches=(TRAIN_STEPS,)):
    """A synthetic KITTI tree laid out as the trainer reads it (the layout of
    tests/test_trainer_e2e.py), at KITTI's raw frame size: jpg frames and
    the ground_seg, hidden_depths, depth_masks, moving_objects and
    stereo_matching_disps npys.  Returns (paths.yaml, {b: the split root
    whose train split is b batches of TRAIN_BATCH, cycling the frames})."""
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
    roots = {}
    for b in batches:
        roots[b] = os.path.join(root, "splits" if b == TRAIN_STEPS else f"splits_{b}")
        n = TRAIN_BATCH * b
        write_splits(roots[b], "kitti", {"train.txt": (lines * n)[:n],
                                         "val.txt": lines[:n_val]})
    config = os.path.join(root, "paths.yaml")
    with open(config, "w") as f:
        yaml.safe_dump({"kitti": {"dataset": raw, "training_data": td}}, f)
    return config, roots


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
    train_batches = TRAIN_STEPS

    def create_dataloaders(self):
        bs = self.opt.batch_size
        return (DataLoader(InMemorySamples(bs * self.train_batches, 0), bs, shuffle=True,
                           num_workers=self.opt.num_workers, seed=TRAIN_SEED),
                DataLoader(InMemorySamples(bs, 10_000), bs, shuffle=True,
                           num_workers=2, drop_last=True, seed=TRAIN_SEED))


def finite_losses(losses):
    return all(np.isfinite(v) for v in losses.values())


def train_step_on(device, host, dtype=torch.float32, compute="float32", heads=False):
    """One train step of the seeded FootprintNetwork-34 on `device`, its
    params in `dtype` (f64 only on the CPU, the plain versions), the forward
    in `compute` ('float32' or 'bfloat16'), with or without the packed
    heads: (loss metrics as floats, f64 grads by name on the CPU, BN running
    stats, the params' and grads' dtypes, the count of mask logits that are
    exactly 0)."""
    mm = ModelManager(device=device, seed=SEED, steps_per_epoch=TRAIN_STEPS)
    mm.net.to(dtype)  # in place: the optimizer keeps the same parameters
    zeros = []
    mm.net.mask_decoder.register_forward_hook(
        lambda module, inputs, out: zeros.append(sum(int((v == 0).sum())
                                                     for v in out.values())))
    config = TrainStepConfig(steps_per_epoch=TRAIN_STEPS, compute_dtype=compute,
                             s2d_head=heads, p4_head=heads)
    step = build_train_step(mm.net, mm.optimizer, config)
    metrics = step(0, {k: torch.from_numpy(v).to(device, dtype)
                       for k, v in host.items()})
    grads = {n: p.grad.detach().cpu().double() for n, p in mm.net.named_parameters()
             if p.grad is not None}
    stats = {k: v.detach().cpu().double() for k, v in mm.net.state_dict().items()
             if "running" in k}
    dtypes = {p.dtype for p in mm.net.parameters()} | {g.dtype for g in (
        p.grad for p in mm.net.parameters()) if g is not None}
    return ({k: float(v) for k, v in metrics.items() if k != "lr"}, grads, stats, dtypes,
            zeros[0])


def worst_grad_leaf(got, ref):
    """(leaf, ||got - ref|| / ||ref||) of the worst gradient leaf."""
    rel = {k: float((got[k] - v).norm() / v.norm().clamp_min(1e-30))
           for k, v in ref.items()}
    leaf = max(rel, key=rel.get)
    return leaf, rel[leaf]


def phase_train(fail, workdir):
    """Train through the entry point; resume; hold a GPU step against a
    CPU step.  Returns (launches, a batch-12 host batch, the epoch stats,
    the run: its argv, route and split roots, for the later phases)."""
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
                                         TRAIN_BATCH * TRAIN_STEPS, TRAIN_BATCH, SEED,
                                         batches=(TRAIN_STEPS, 1, TRAIN_TIMED_BATCHES + 1))
        argv += ["--config_path", config, "--split_root", splits[TRAIN_STEPS]]
        manager_class = TrainManager
    else:
        route = "TrainManager with in-memory samples (no PIL/OpenCV/PyYAML)"
        argv += ["--config_path", "unused"]
        manager_class = InMemoryTrainManager
        splits = None
    tree_s = time.perf_counter() - t0
    run = {"argv": argv, "real": have_data_libs, "splits": splits, "route": route}

    # the main path: counts set to 0 just before, read just after
    fused_conv3x3.launches = 0
    torch.cuda.reset_peak_memory_stats()
    if have_data_libs:
        tm = port_main.main(argv)
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
    m_gpu, g_gpu, s_gpu, *_ = train_step_on("cuda", small)
    m_ref, g_ref, s_ref, *_ = train_step_on("cpu", small, torch.float64)
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
    return launches, host, epoch, run


def trainer_for(run, args, batches=TRAIN_STEPS):
    """A TrainManager over `batches` training batches of the run's data (the
    synthetic tree's split root of that size, or in-memory samples), as
    main.main builds it; its train() is main.main's training run."""
    if run["real"]:
        return TrainManager(Options().parse(run["argv"] + args
                                            + ["--split_root", run["splits"][batches]]))
    cls = type(f"InMemoryTrainManager{batches}", (InMemoryTrainManager,),
               {"train_batches": batches})
    return cls(Options().parse(run["argv"] + args))


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


def decoder_conv_calls():
    """Every conv of both models' decoders at 192x640 that cuDNN runs (all
    but the fused kernel's sites), recorded at aten.convolution in one
    batch-1 forward of each decoder on the card: {(input per image, as
    passed, padded: [C,H,W]; weight shape; bias?; stride; padding;
    channels_last?): the models that call it}."""
    from torch.utils._python_dispatch import TorchDispatchMode

    calls = {}

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.convolution.default:
                x, w, b, stride, padding = args[:5]
                cl = (x.is_contiguous(memory_format=torch.channels_last)
                      and not x.is_contiguous())
                key = (tuple(x.shape[1:]), tuple(w.shape), b is not None, tuple(stride),
                       tuple(padding), cl)
                calls.setdefault(key, []).append(model)
            return func(*args, **(kwargs or {}))

    g = torch.Generator().manual_seed(SEED)
    nets = {"FootprintNetwork-34": FootprintNetwork(34, device="cuda", generator=g),
            "Segmentor-34 PSP": Segmentor(34, True, device="cuda", generator=g)}
    x = torch.rand(1, 3, HEIGHT, WIDTH, device="cuda").contiguous(
        memory_format=torch.channels_last)
    for model, net in nets.items():
        with torch.no_grad():
            features = net.encoder(x)
            with Record():
                if model.startswith("Footprint"):
                    net.mask_decoder(features)
                    net.depth_decoder(features)
                else:
                    net.decoder(features)
    return calls


def cudnn_batch_probe(batches=(4, 8, 12, 16)):
    """cuDNN's f32 time (TF32 off) per call, mean of 5 after 2: the
    decoder's block2 post-concat conv1, reflect-padded [N,256,26,82] *
    [128,256,3,3] in NCHW (the first probe's form) at each batch N; then every conv
    of both decoders that cuDNN runs, in the memory format and with the
    bias the model passes, at each batch, with the default heuristics and
    with torch.backends.cudnn.benchmark on (restored after).  A shape is on
    a cliff at a batch where its time per image exceeds 4x its least time
    per image over the batches (and 1 ms per call)."""
    out = {}
    w = torch.randn(128, 256, 3, 3, device="cuda") * 0.02
    for n in batches:
        x = torch.randn(n, 256, 26, 82, device="cuda")
        out[f"batch_{n}_ms"] = time_ms(lambda: F.conv2d(x, w), iters=5, warmup=2)
    del x, w
    rows = []
    prior = torch.backends.cudnn.benchmark
    try:
        for (shape, wshape, bias, stride, padding, cl), models in decoder_conv_calls().items():
            row = {"input": list(shape), "weight": list(wshape), "stride": list(stride),
                   "padding": list(padding), "channels_last": cl,
                   "calls_per_forward": {m: models.count(m) for m in sorted(set(models))}}
            w = torch.randn(wshape, device="cuda") * 0.02
            b = torch.randn(wshape[0], device="cuda") if bias else None
            for mode in (False, True):
                torch.backends.cudnn.benchmark = mode
                times = {}
                for n in batches:
                    x = torch.randn(n, *shape, device="cuda")
                    if cl:
                        x = x.contiguous(memory_format=torch.channels_last)
                    times[n] = time_ms(lambda: F.conv2d(x, w, b, stride, padding),
                                       iters=5, warmup=2)
                    del x
                least = min(t / n for n, t in times.items())
                key = "benchmark" if mode else "default"
                row[f"{key}_ms"] = times
                row[f"{key}_cliff_batches"] = [n for n, t in times.items()
                                               if t / n > 4 * least and t > 1.0]
            rows.append(row)
    finally:
        torch.backends.cudnn.benchmark = prior
    out["decoder_convs"] = rows
    out["cliffs_default"] = [[r["input"], r["weight"], r["default_cliff_batches"]]
                             for r in rows if r["default_cliff_batches"]]
    out["cliffs_benchmark"] = [[r["input"], r["weight"], r["benchmark_cliff_batches"]]
                               for r in rows if r["benchmark_cliff_batches"]]
    out["benchmark_flag_restored"] = torch.backends.cudnn.benchmark == prior
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
    probe = cudnn_batch_probe()
    fail.check(probe["benchmark_flag_restored"] and len(probe["decoder_convs"]) > 0,
               "train_times: the cuDNN probe found no decoder conv or left the "
               "benchmark flag changed")
    os.makedirs(os.path.join(REPO, "smoke_out"), exist_ok=True)
    with open(os.path.join(REPO, "smoke_out", "cudnn_probe.json"), "w") as f:
        json.dump(probe, f, indent=1)
    emit("train_times", cudnn_probe={k: v for k, v in probe.items() if k != "decoder_convs"},
         cudnn_probe_table="smoke_out/cudnn_probe.json")
    for r in probe["decoder_convs"]:
        emit("train_times", cudnn_conv=r)


# --- bf16 training of the FootprintNetwork ----------------------------------------

def card_batch_packs(fail, tm):
    """The packed '@s2d'/'@s2d2' targets on a batch the trainer decodes onto
    the card (its _put: the prefetcher's decode): {key: shape}."""
    batch = tm._put(next(iter(tm.val_loader)))
    packs = {k: list(v.shape) for k, v in batch.items() if "@s2d" in k}
    want = {f"{k}{suffix}": [TRAIN_BATCH, HEIGHT // s, WIDTH // s, s * s]
            for k in TARGET_KEYS for suffix, s in (("@s2d", 2), ("@s2d2", 4))}
    fail.check(packs == want and all(v.is_cuda for v in batch.values()),
               f"train_bf16: packed targets on the card batch {packs}, expected {want}")
    return packs


def phase_train_bf16(fail, run, workdir):
    """main --mode train --compute_dtype bfloat16 (heads 'auto': both on) on
    phase 7's data: 4 steps, the step-0 validation, the checkpoint and a
    resume; then the check steps and --pretrained_encoder.  Returns the
    kernel's launches on the main paths driven here."""
    args = ["--compute_dtype", "bfloat16", "--model_name", "smoke_bf16"]
    # the main path: counts set to 0 just before, read just after
    fused_conv3x3.launches = fused_conv3x3.bf16_launches = 0
    torch.cuda.reset_peak_memory_stats()
    if run["real"]:
        tm = port_main.main(run["argv"] + args)
    else:
        tm = trainer_for(run, args)
        tm.train()
    torch.cuda.synchronize()
    launches, bf16 = fused_conv3x3.launches, fused_conv3x3.bf16_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_val = sum(1 for mode, _, _ in tm.logged if mode == "val")
    expected = LAUNCHES_PER_FORWARD * (TRAIN_STEPS + VAL_BATCHES * n_val)
    fail.check(n_val == 1 and launches == bf16 == expected,
               f"train_bf16: {launches} kernel launches ({bf16} bf16), expected {expected}, "
               f"all bf16 (10 per training forward, 10 per validation forward; "
               f"{n_val} validation events)")
    heads = (tm.step_config.s2d_head, tm.step_config.p4_head)
    fail.check(heads == (True, True), f"train_bf16: heads {heads} under 'auto', expected on")
    rest = tm.evaluator.get_averaged_losses("train")
    fail.check(tm.step == TRAIN_STEPS and len(tm.logged) == 2 and finite_losses(rest)
               and all(finite_losses(losses) and len(losses) == 21
                       for _, _, losses in tm.logged),
               f"train_bf16: step {tm.step}, logged {tm.logged}, later steps {rest}")
    masters = {p.dtype for p in tm.model_manager.net.parameters()}
    fail.check(masters == {torch.float32}, f"train_bf16: master params in {masters}")
    weights = os.path.join(workdir, "train_logs", "smoke_bf16", "models", "weights_0")
    ckpt = os.path.join(weights, "checkpoint.npz")
    ok = os.path.exists(ckpt)
    if ok:
        loaded = load_checkpoint(ckpt)
        ok = (int(loaded["step"]) == TRAIN_STEPS == int(loaded["opt_state"][0][0])
              and all(a.dtype in (np.float32, np.int32) and np.isfinite(a).all()
                      for a in tree_arrays(loaded)))
    fail.check(ok, f"train_bf16: {ckpt} missing, not at step {TRAIN_STEPS}, or not f32")
    packs = card_batch_packs(fail, tm)

    tm2 = trainer_for(run, args + ["--load_path", weights])
    (count, mu, nu), _ = tm.model_manager.train_state()["opt_state"]
    (count2, mu2, nu2), _ = tm2.model_manager.train_state()["opt_state"]
    fail.check(tm2.step == TRAIN_STEPS and int(count2) == int(count) == TRAIN_STEPS
               and np.array_equal(mu, mu2) and np.array_equal(nu, nu2),
               f"train_bf16: resume gave step {tm2.step}, Adam count {int(count2)}")
    for m in (tm, tm2):
        m.val_iter.close()
    emit("train_bf16", route=run["route"], steps=tm.step, batch=TRAIN_BATCH,
         shape=[HEIGHT, WIDTH], depth=34, compute_dtype="bfloat16", heads="auto (on)",
         launches=launches, bf16_launches=bf16, launches_expected=expected,
         logged=[[m, s_, losses["loss"]] for m, s_, losses in tm.logged],
         checkpoint=os.path.relpath(ckpt, workdir), resumed_step=tm2.step,
         packed_targets_on_card=packs, peak_memory_gib=peak_gib,
         epoch_seconds_with_first_batch_and_validation=tm.train_seconds)
    train_check_steps(fail)
    return launches + phase_pretrained(fail, run, workdir)


def train_check_steps(fail):
    """At batch 2 on a seeded noise batch, from the seeded weights: the GPU
    bf16 step (both heads) against an f64 CPU step, no farther from it than
    twice a CPU bf16 step's distance (the same code on the CPU, held
    against the JAX package by tests/test_torch_bf16_train.py), for the
    whole gradient and each leaf plus 1e-3; and the GPU f32 step with both
    heads against the one without: loss terms within 1e-6 relative, the
    whole gradient ||d||/||ref|| < 1e-5, beside the same heads-off step run
    twice (cuDNN's own run-to-run spread).  Printed beside them: the worst
    leaves and the count of mask logits that are exactly 0."""
    small = collate([InMemorySamples(CHECK_BATCH, CHECK_SEED)[i] for i in range(CHECK_BATCH)])
    runs = {"gpu_bf16": ("cuda", torch.float32, "bfloat16", True),
            "cpu_bf16": ("cpu", torch.float32, "bfloat16", True),
            "cpu_f64": ("cpu", torch.float64, "float32", True),
            "gpu_f32_heads": ("cuda", torch.float32, "float32", True),
            "gpu_f32": ("cuda", torch.float32, "float32", False),
            "gpu_f32_again": ("cuda", torch.float32, "float32", False)}
    steps, seconds = {}, {}
    for name, (device, dtype, compute, heads) in runs.items():
        t0 = time.perf_counter()
        steps[name] = train_step_on(device, small, dtype, compute, heads)
        seconds[name] = time.perf_counter() - t0
    m16, g16, _, dtypes16, _ = steps["gpu_bf16"]
    g_cpu16, g_ref = steps["cpu_bf16"][1], steps["cpu_f64"][1]
    fail.check(finite_losses(m16) and dtypes16 == {torch.float32}
               and g16.keys() == g_ref.keys() == g_cpu16.keys(),
               f"train_bf16: bf16 check step losses {m16}, masters and grads in {dtypes16}")
    whole = {"gpu_bf16": whole_rel(g16, g_ref), "cpu_bf16": whole_rel(g_cpu16, g_ref)}
    fail.check(whole["gpu_bf16"] <= 2 * whole["cpu_bf16"],
               f"train_bf16: the GPU bf16 gradient sits {whole['gpu_bf16']} from the f64 "
               f"step, the CPU bf16 one {whole['cpu_bf16']}")
    leaf_gap = {}  # leaf: (GPU bf16 to f64, CPU bf16 to f64)
    for k, v in g_ref.items():
        norm = float(v.norm().clamp_min(1e-30))
        leaf_gap[k] = (float((g16[k] - v).norm()) / norm, float((g_cpu16[k] - v).norm()) / norm)
    over = {k: d for k, d in leaf_gap.items() if d[0] > 2 * d[1] + 1e-3}
    fail.check(not over, f"train_bf16: GPU bf16 gradient leaves farther from the f64 step "
                         f"than twice the CPU bf16 step's, plus 1e-3: {over}")
    worst_ratio = max(leaf_gap, key=lambda k: leaf_gap[k][0] / max(leaf_gap[k][1], 1e-30))
    least_margin = min(leaf_gap, key=lambda k: 2 * leaf_gap[k][1] + 1e-3 - leaf_gap[k][0])

    (m_on, g_on, *_), (m_off, g_off, *_) = steps["gpu_f32_heads"], steps["gpu_f32"]
    loss_rel = max(abs(m_on[k] - v) / max(abs(v), 1e-30) for k, v in m_off.items())
    heads_rel = whole_rel(g_on, g_off)
    repeat_rel = whole_rel(steps["gpu_f32_again"][1], g_off)
    fail.check(m_on.keys() == m_off.keys() and loss_rel <= 1e-6 and heads_rel < 1e-5,
               f"train_bf16: the f32 step with the packed heads vs without: loss terms "
               f"{loss_rel} relative (bar 1e-6), gradient {heads_rel} (bar 1e-5)")
    emit("train_bf16", check_steps=dict(
        batch=CHECK_BATCH, shape=[HEIGHT, WIDTH], input=f"noise, seed {CHECK_SEED}",
        bf16_reference="CPU, f64, both heads", whole_grad_rel_to_f64=whole,
        whole_bar="2 x CPU bf16's", leaf_bar="2 x CPU bf16's + 1e-3",
        worst_leaf_ratio=[worst_ratio, *leaf_gap[worst_ratio]],
        least_leaf_margin=[least_margin, *leaf_gap[least_margin]],
        worst_gpu_bf16_leaf=worst_grad_leaf(g16, g_ref),
        loss_bf16_vs_f32_max_abs=max(abs(m16[k] - v) for k, v in m_off.items()),
        zero_mask_logits={k: v[4] for k, v in steps.items()},
        heads_on_vs_off_f32={"loss_max_rel": loss_rel, "loss_bar": 1e-6,
                             "whole_grad_rel": heads_rel, "grad_bar": 1e-5,
                             "worst_leaf": worst_grad_leaf(g_on, g_off),
                             "same_step_twice_whole_grad_rel": repeat_rel}),
        seconds=seconds)


def write_torchvision_resnet34(path, seed):
    """A seeded ResNet-34 state_dict in torchvision's layout (conv1, bn1,
    layer1..4, fc), saved to `path`.  Returns {the port's encoder key: the
    file's tensor} for its float tensors."""
    with torch.device("meta"):
        like = resnet.ResnetEncoder(34).state_dict()
    rng = np.random.RandomState(seed)
    sd, port = {}, {}
    for k, v in like.items():
        tv = (k.replace("layer0.0.", "conv1.", 1).replace("layer0.1.", "bn1.", 1)
              .replace("layer1.1.", "layer1.", 1))
        if k.endswith("num_batches_tracked"):
            sd[tv] = torch.tensor(0)
            continue
        a = rng.randn(*v.shape).astype(np.float32) * 0.05
        sd[tv] = port["encoder." + k] = torch.from_numpy(
            np.abs(a) + 0.5 if k.endswith("running_var") else a)
    sd["fc.weight"] = torch.from_numpy(rng.randn(1000, 512).astype(np.float32) * 0.01)
    sd["fc.bias"] = torch.zeros(1000)
    torch.save(sd, path)
    return port


def phase_pretrained(fail, run, workdir):
    """--pretrained_encoder: a synthetic torchvision-layout ResNet-34 .pth;
    one bf16 step from it through the trainer main.main builds.  Checks the
    step-0 encoder equals the file's weights exactly (and BN statistics),
    10 launches for the step and 10 for its validation.  Returns them."""
    path = os.path.join(workdir, "resnet34_torchvision.pth")
    want = write_torchvision_resnet34(path, SEED)
    tm = trainer_for(run, ["--compute_dtype", "bfloat16", "--model_name", "smoke_pretrained",
                           "--pretrained_encoder", path], batches=1)
    sd = tm.model_manager.net.state_dict()
    exact = all(torch.equal(sd[k].cpu(), v) for k, v in want.items())
    # the main path: counts set to 0 just before, read just after
    fused_conv3x3.launches = fused_conv3x3.bf16_launches = 0
    tm.train()
    torch.cuda.synchronize()
    launches = fused_conv3x3.launches
    expected = LAUNCHES_PER_FORWARD * (1 + VAL_BATCHES)
    fail.check(exact and len(want) > 0,
               f"train_bf16: the step-0 encoder differs from {path}'s weights")
    fail.check(tm.step == 1 and launches == fused_conv3x3.bf16_launches == expected
               and all(finite_losses(losses) for _, _, losses in tm.logged),
               f"train_bf16: pretrained run at step {tm.step}, {launches} launches "
               f"(expected {expected}), logged {tm.logged}")
    tm.val_iter.close()
    emit("train_bf16", pretrained_encoder=dict(
        file="synthetic torchvision-layout ResNet-34 state_dict (fc included)",
        tensors_checked=len(want), step0_encoder_equals_file=exact, steps=tm.step,
        launches=launches, launches_expected=expected,
        logged=[[m, s_, losses["loss"]] for m, s_, losses in tm.logged]))
    return launches


def footprint_step_times(fail, host, compute, heads):
    """The FootprintNetwork-34 train step alone on a batch on the card (the
    packed targets made as the trainer's decode makes them): ms (mean of 10
    after 3), imgs/s, peak memory, the forward+loss / backward / Adam split
    (CUDA events, mean of 5) and one profiled step's busy time (the union
    of its device intervals) over its wall time."""
    batch = len(host["image"])
    mm = ModelManager(device="cuda", seed=SEED, steps_per_epoch=TRAIN_STEPS)
    config = TrainStepConfig(steps_per_epoch=TRAIN_STEPS, compute_dtype=compute,
                             s2d_head=heads, p4_head=heads)
    step = build_train_step(mm.net, mm.optimizer, config)
    keys = TARGET_KEYS if heads else ()
    b = decompact_on_device({k: torch.from_numpy(v).cuda() for k, v in host.items()},
                            None, keys, keys)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: step(0, b), iters=10, warmup=3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    split = {"forward_loss_ms": 0.0, "backward_ms": 0.0, "adam_ms": 0.0}
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        losses = compute_losses(forward_in(mm.net, b["image"], config.dtype, config.heads),
                                b, config.loss)
        ev[1].record()
        mm.optimizer.zero_grad(set_to_none=True)
        losses["loss"].backward()
        ev[2].record()
        mm.optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        for i, key in enumerate(split):
            split[key] += ev[i].elapsed_time(ev[i + 1]) / 5
    wall_ms, raw = profiled(lambda: step(0, b))
    busy = span_summary(device_spans(raw))
    fail.check(busy["ms_union"] > 0, f"train_bf16_times {compute} b{batch}: no device time")
    return {"step_ms": ms, "imgs_per_s": batch / (ms * 1e-3), "peak_memory_gib": peak,
            **split, "profiled_wall_ms": wall_ms, "busy_ms_union": busy["ms_union"],
            "busy_share_of_profiled_wall": busy["ms_union"] / wall_ms,
            "device_kernels": len(device_spans(raw))}


def phase_train_bf16_times(fail, host, run):
    """The bf16 step alone at batch 12 and 16, heads on and off, and the f32
    step at batch 12 beside them; then the trainer with its loader (its own
    epoch loop; bf16, heads 'auto') over 16 batches of 12 after an untimed
    first batch."""
    rows = {}
    host16 = {k: np.concatenate([v, v[:4]]) for k, v in host.items()}
    # heads on and off in turns (on, off, off, on): the step is host-bound,
    # and its time drifts between measurements
    for compute, heads, batch in (("bfloat16", True, 12), ("bfloat16", False, 12),
                                  ("bfloat16", False, 12), ("bfloat16", True, 12),
                                  ("bfloat16", True, 16), ("bfloat16", False, 16),
                                  ("bfloat16", False, 16), ("bfloat16", True, 16),
                                  ("float32", False, 12)):
        name = f"{compute}_{'heads' if heads else 'no_heads'}_b{batch}"
        rows.setdefault(name, []).append(
            footprint_step_times(fail, host if batch == 12 else host16, compute, heads))
        torch.cuda.empty_cache()
    trainer = trainer_for(run, ["--compute_dtype", "bfloat16", "--model_name", "smoke_timed"],
                          batches=TRAIN_TIMED_BATCHES + 1)
    rate = steady_epoch_rate(fail, trainer, trainer.model_manager, LAUNCHES_PER_FORWARD)
    loader_alone = loader_rate(trainer.train_loader)
    emit("train_bf16_times", model="FootprintNetwork-34, 192x640", steps=rows,
         trainer_imgs_per_s_with_loader_bf16=rate, loader_alone_imgs_per_s=loader_alone,
         timed_batches=TRAIN_TIMED_BATCHES, timed_frames=TRAIN_TIMED_BATCHES * TRAIN_BATCH)


# --- the batch dumps ------------------------------------------------------------

def have_dump_libs():
    """The dumps' real datasets read images with Pillow and paths with PyYAML."""
    return all(importlib.util.find_spec(m) is not None for m in ("PIL", "yaml"))


def smooth_frame(rng, hw):
    """A photo-like uint8 frame: a bicubic-upsampled coarse random field plus
    mild noise (white noise would make JPEG decoding, and so the loader,
    slower than on real frames)."""
    from PIL import Image

    h, w = hw
    coarse = Image.fromarray(rng.randint(0, 256, (h // 32 + 1, w // 32 + 1, 3),
                                         dtype=np.uint8))
    field = np.asarray(coarse.resize((w, h), Image.BICUBIC), np.int16)
    return np.clip(field + rng.randint(-8, 9, field.shape), 0, 255).astype(np.uint8)


def write_splits(root, name, splits):
    for split, lines in splits.items():
        os.makedirs(os.path.join(root, name), exist_ok=True)
        with open(os.path.join(root, name, split), "w") as f:
            f.write("\n".join(lines))


def make_dump_trees(root, with_files):
    """The dumps' synthetic data under `root`: a KITTI raw tree of DUMP_FRAMES
    frames (test split; train/val splits over the same frames for the
    segmentation dump), a Matterport tree of MATTERPORT_FRAMES frames (test
    split) with npy ground truth, and paths.yaml.  Without `with_files` only
    the split files and the ground truth are written (the in-memory route).
    Returns {name: path}."""
    rng = np.random.RandomState(SEED)
    raw, mp_raw = os.path.join(root, "kitti_raw"), os.path.join(root, "matterport_raw")
    kitti = [f"seq0 {i} {'l' if i % 2 == 0 else 'r'}" for i in range(DUMP_FRAMES)]
    matterport = [f"scan{i % 2} pos{i:03d} {i % 3} {i}" for i in range(MATTERPORT_FRAMES)]
    paths = {"splits": os.path.join(root, "splits"),
             "splits_cpu": os.path.join(root, "splits_cpu"),
             "splits_timed": os.path.join(root, "splits_timed"),
             "gt": os.path.join(root, "matterport_gt"),
             "training_data": os.path.join(root, "kitti_training_data"),
             "config": os.path.join(root, "paths.yaml")}
    write_splits(paths["splits"], "kitti", {"test.txt": kitti, "train.txt": kitti[:20],
                                            "val.txt": kitti[20:]})
    write_splits(paths["splits"], "matterport", {"test.txt": matterport})
    # the CPU twin of the KITTI dump covers the first batch
    write_splits(paths["splits_cpu"], "kitti", {"test.txt": kitti[:DUMP_BATCH]})
    write_splits(paths["splits_cpu"], "matterport", {"test.txt": matterport})
    timed = (kitti * -(-TIMED_FRAMES // DUMP_FRAMES))[:TIMED_FRAMES]
    write_splits(paths["splits_timed"], "kitti", {"test.txt": timed, "train.txt": timed,
                                                  "val.txt": []})
    os.makedirs(paths["gt"])
    for line in matterport:
        hw = MATTERPORT_HW
        depth = (rng.rand(*hw) * 15 + 0.5) * (rng.rand(*hw) > 0.5)
        stem = os.path.join(paths["gt"], "_".join(line.split()))
        np.save(stem + "_groundtruth.npy", depth)
        np.save(stem + "_freespace.npy", (rng.rand(*hw) > 0.3).astype(np.float32))
    if not with_files:
        return paths

    import yaml
    from PIL import Image

    for line in kitti:
        _, frame, side = line.split()
        folder = os.path.join(raw, "seq0", "image_02" if side == "l" else "image_03", "data")
        os.makedirs(folder, exist_ok=True)
        Image.fromarray(smooth_frame(rng, KITTI_RAW_HW)).save(
            os.path.join(folder, frame.zfill(10) + ".jpg"))
    for line in matterport:
        scan, pos, h, d = line.split()
        folder = os.path.join(mp_raw, scan, scan, "matterport_color_images")
        os.makedirs(folder, exist_ok=True)
        Image.fromarray(smooth_frame(rng, MATTERPORT_RAW_HW)).save(
            os.path.join(folder, f"{pos}_i{h}_{d}.jpg"))
    with open(paths["config"], "w") as f:
        yaml.safe_dump({"kitti": {"dataset": raw, "training_data": paths["training_data"]},
                        "matterport": {"dataset": mp_raw}}, f)
    return paths


def in_memory(dataset_class):
    """`dataset_class` with seeded in-memory images in place of decoded
    files: the same {'image', 'idx'} samples and the same save_result."""
    class InMemory(dataset_class):
        def __getitem__(self, index):
            rng = np.random.RandomState(SEED + index)
            image = rng.randint(0, 256, (self.height, self.width, 3)).astype(np.float32)
            return {"image": image / 255.0, "idx": index}
    return InMemory


class InMemoryInferenceManager(InferenceManager):
    def create_dataloaders(self):
        name = self.opt.inference_data_type
        files = readlines(os.path.join(self.opt.split_root, name, "test.txt"))
        dataset = in_memory(get_inference_dataset_class(name))(
            None, files, self.opt.height, self.opt.width)
        return DataLoader(dataset, self.opt.batch_size, shuffle=False,
                          num_workers=self.opt.num_workers, drop_last=False), dataset


class InMemoryTester(Tester):
    def create_dataloaders(self):
        name = self.opt.test_data_type
        files = sorted(readlines(os.path.join(self.opt.split_root, name, "train.txt"))
                       + readlines(os.path.join(self.opt.split_root, name, "val.txt")))
        dataset = in_memory(seg_datasets.get_inference_dataset_class(name))(
            None, files, self.opt.height, self.opt.width)
        save_path = os.path.join(os.path.dirname(self.opt.split_root),
                                 "kitti_training_data", self.opt.test_save_folder)
        loader = DataLoader(dataset, self.opt.batch_size, shuffle=False,
                            num_workers=self.opt.num_workers, drop_last=False)
        return loader, dataset, save_path


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def drive(kind, argv, real):
    """Run one dump entry point; returns (the manager, kernel launches).
    kind 'dump' is footprints_tpu_torch.main --mode inference, 'seg' the
    segmentation main; `real` picks the entry point itself, else the
    in-memory manager on the same options."""
    fused_conv3x3.launches = 0
    if kind == "dump":
        manager = (port_main.main(argv) if real else
                   InMemoryInferenceManager(Options().parse(argv)))
        if not real:
            manager.run()
    else:
        manager = seg_main.main(argv) if real else InMemoryTester(SegOptions().parse(argv))
        if not real:
            manager.test()
    sync(manager.device)
    return manager, fused_conv3x3.launches


def files_under(folder):
    return {os.path.relpath(os.path.join(d, f), folder): os.path.join(d, f)
            for d, _, fs in os.walk(folder) for f in fs if f.endswith(".npy")}


def check_dump_files(fail, tag, folder, names, shape):
    """Each expected file: float16 of `shape`, finite, the sigmoid channels
    (all of a ground_seg map, channels 0-1 of a 4-channel dump) in [0,1]."""
    files = files_under(folder)
    fail.check(sorted(files) == sorted(names),
               f"{tag}: {len(files)} files, expected {len(names)}: {sorted(files)[:4]}")
    for name in sorted(files):
        pred = np.load(files[name])
        probs = pred[:2] if shape[0] == 4 else pred
        ok = (pred.shape == shape and pred.dtype == np.float16
              and np.isfinite(pred.astype(np.float32)).all()
              and probs.min() >= 0 and probs.max() <= 1)
        fail.check(ok, f"{tag}/{name}: shape {pred.shape} {pred.dtype}, range "
                       f"[{pred.min()}, {pred.max()}]")
    return files


def worst_f16_gap(got, ref):
    """Max over files of max(|got - ref| / (1 + |ref|)), float32 arithmetic:
    within the F16_BAR when it is at most F16_BAR."""
    worst = 0.0
    for name, path in ref.items():
        a = np.load(got[name]).astype(np.float32)
        b = np.load(path).astype(np.float32)
        worst = max(worst, float((np.abs(a - b) / (1 + np.abs(b))).max()))
    return worst


def byte_identical(run, folder):
    """Dump serially then overlapped into two folders; (identical, n files)."""
    out = {}
    for overlap in (False, True):
        run(os.path.join(folder, f"overlap_{overlap}"), overlap)
        out[overlap] = {k: open(v, "rb").read()
                        for k, v in files_under(os.path.join(folder, f"overlap_{overlap}")).items()}
    return out[True] == out[False] and len(out[True]) > 0, len(out[True])


def union_ms(spans):
    """Time (ms) in which at least one of `spans` ran, from (start_ns,
    end_ns, stream) tuples: the union of their intervals, so spans that
    overlap count once."""
    total, end = 0, float("-inf")
    for start, stop, _ in sorted(spans):
        total += max(0, stop - max(start, end))
        end = max(end, stop)
    return total / 1e6


def same_stream_overlaps(spans):
    """How many of `spans` start before the previous span on their stream
    has ended."""
    n, ends = 0, {}
    for start, stop, stream in sorted(spans):
        n += start < ends.get(stream, float("-inf"))
        ends[stream] = max(ends.get(stream, float("-inf")), stop)
    return n


def span_summary(spans):
    return {"ms_union": union_ms(spans),
            "ms_summed": sum(stop - start for start, stop, _ in spans) / 1e6,
            "streams": len({stream for _, _, stream in spans}),
            "same_stream_overlaps": same_stream_overlaps(spans)}


def profile_dump(run, batch):
    """One overlapped dump under torch.profiler, read from the profiler's
    raw device events: the device's busy share (the union of their
    intervals over the dump's wall time, both under the profiler) beside
    their summed durations, their streams and how many overlap on one
    stream; the same for the block2 post-concat conv's kernels (those
    linked by correlation id to a conv op of its input shape), and their
    union's share of the busy time and of the wall time."""
    wall_ms, raw = profiled(lambda: run(True))
    cliff_ops = cliff_op_ids(raw, batch)
    spans, cliff = device_spans(raw), device_spans(raw, cliff_ops)
    busy, cliff_summary = span_summary(spans), span_summary(cliff)
    return {"wall_ms": wall_ms, "busy_share": busy["ms_union"] / wall_ms,
            "device": busy, "cliff_ops": len(cliff_ops), "cliff_kernels": len(cliff),
            "cliff": cliff_summary,
            "cliff_share_of_busy": cliff_summary["ms_union"] / max(busy["ms_union"], 1e-9),
            "cliff_share_of_wall": cliff_summary["ms_union"] / wall_ms}


def profiled(fn):
    """fn() once under torch.profiler: (its wall ms on the host clock,
    ending in a synchronise, the profiler's raw events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, prof.profiler.kineto_results.events()


def cliff_op_ids(raw, batch, backward=False):
    """Correlation ids of the CPU ops of the block2 post-concat conv at
    `batch`: the forward convs (input [batch, *CLIFF_INPUT] first) or, with
    `backward`, convolution_backward (that input second)."""
    from torch.autograd import DeviceType

    want, at = [batch, *CLIFF_INPUT], 1 if backward else 0
    return {e.correlation_id() for e in raw
            if e.device_type() == DeviceType.CPU and "conv" in e.name()
            and ("backward" in e.name()) == backward
            and len(e.shapes()) > at and list(e.shapes()[at]) == want}


def device_spans(raw, linked=None):
    """(start_ns, end_ns, stream) of the device events: all of them, or those
    linked by correlation id to the CPU ops `linked`."""
    from torch.autograd import DeviceType

    return [(e.start_ns(), e.end_ns(), e.device_resource_id()) for e in raw
            if e.device_type() == DeviceType.CUDA
            and (linked is None or e.linked_correlation_id() in linked)]


def time_dumps(fail, make_manager, run_into, workdir, launches_per_batch):
    """At each timed batch: imgs/s of the dump with its loader and writer
    (host clock from the call to its return, which waits for the last
    save), serial and overlapped in the order serial, overlapped,
    overlapped, serial after one warm-up dump; the loader alone over the
    same split; the cliff conv's time alone (cudnn_batch_probe), which
    varies between calls and runs, so it is no share of a dump's time;
    then one profiled dump."""
    rows = {}
    for batch in TIMED_BATCHES:
        manager = make_manager(batch)
        folder = os.path.join(workdir, f"timed_b{batch}")

        def run(overlap):
            return run_into(manager, folder, overlap)

        run(False)  # warm-up: cuDNN's plans for this batch, the page cache
        rates = {"serial": [], "overlapped": []}
        fused_conv3x3.launches = 0
        for overlap in (False, True, True, False):
            sync(manager.device)
            t0 = time.perf_counter()
            n = run(overlap)
            sync(manager.device)
            rates["overlapped" if overlap else "serial"].append(
                n / (time.perf_counter() - t0))
        n_batches = -(-n // batch)
        fail.check(fused_conv3x3.launches == 4 * n_batches * launches_per_batch,
                   f"timed dump at batch {batch}: {fused_conv3x3.launches} launches, "
                   f"expected {4 * n_batches * launches_per_batch}")
        t0 = time.perf_counter()  # the loader alone: the host's rate limit
        loaded = sum(len(b["idx"]) for b in manager.loader)
        loader_rate = loaded / (time.perf_counter() - t0)
        cliff_ms = cudnn_batch_probe((batch,))[f"batch_{batch}_ms"]
        profiled = profile_dump(run, batch)
        fail.check(profiled["cliff_kernels"] > 0,
                   f"profiled dump at batch {batch}: no kernel linked to the cliff conv")
        rows[f"batch_{batch}"] = {
            "imgs_per_s_serial": rates["serial"],
            "imgs_per_s_overlapped": rates["overlapped"],
            "imgs_per_s_loader_alone": loader_rate,
            "images": n, "batches": n_batches,
            "cliff_ms_per_call_alone": cliff_ms,
            "profile": profiled}
    return rows


def phase_dump(fail, workdir):
    """main --mode inference: the KITTI dump at 192x640, its CPU twin, the
    overlap check, a Matterport dump scored by the harness, and the times.
    Returns the kernel launches of the GPU entry-point runs."""
    real = have_dump_libs()
    t0 = time.perf_counter()
    paths = make_dump_trees(os.path.join(workdir, "data"), real)
    tree_s = time.perf_counter() - t0
    mm = ModelManager(save_folder=os.path.join(workdir, "fp"), is_inference=True,
                      device="cpu", seed=SEED)
    mm.save_model("weights")
    weights = os.path.join(workdir, "fp", "weights")

    def argv(device, data_type="kitti", batch=DUMP_BATCH, split_root=paths["splits"],
             out=None, hw=(HEIGHT, WIDTH)):
        return ["--mode", "inference", "--inference_data_type", data_type,
                "--height", str(hw[0]), "--width", str(hw[1]),
                "--batch_size", str(batch), "--num_workers", "8",
                "--config_path", paths["config"], "--split_root", split_root,
                "--encoder_depth", "34", "--load_path", weights, "--device", device,
                "--inference_save_path", out]

    route = ("footprints_tpu_torch.main.main (synthetic trees)" if real else
             "InferenceManager on in-memory images (no Pillow/PyYAML)")
    gpu_out, cpu_out = os.path.join(workdir, "kitti_gpu"), os.path.join(workdir, "kitti_cpu")
    # the main path: counts set to 0 just before, read just after
    manager, launches = drive("dump", argv("cuda", out=gpu_out), real)
    n_batches = -(-DUMP_FRAMES // DUMP_BATCH)
    fail.check(launches == LAUNCHES_PER_FORWARD * n_batches,
               f"dump: {launches} kernel launches for {n_batches} batches, expected "
               f"{LAUNCHES_PER_FORWARD} per batch")
    names = [f"{i:03d}.npy" for i in range(DUMP_FRAMES)]
    gpu_files = check_dump_files(fail, "dump", gpu_out, names, (4, HEIGHT, WIDTH))
    _, cpu_launches = drive("dump", argv("cpu", split_root=paths["splits_cpu"], out=cpu_out),
                            real)
    cpu_files = check_dump_files(fail, "dump cpu", cpu_out, names[:DUMP_BATCH],
                                 (4, HEIGHT, WIDTH))
    gap = worst_f16_gap(gpu_files, cpu_files)
    fail.check(gap <= F16_BAR and cpu_launches == 0,
               f"dump: first batch GPU vs CPU gap {gap} (bar {F16_BAR}), "
               f"{cpu_launches} launches on the CPU")

    def run_into(m, folder, overlap):
        m.savepath = folder
        return m.run(overlap=overlap)

    same, n_same = byte_identical(lambda f, o: run_into(manager, f, o),
                                  os.path.join(workdir, "kitti_overlap"))
    fail.check(same and n_same == DUMP_FRAMES,
               f"dump: overlapped dump differs from the serial one ({n_same} files)")
    emit("dump", route=route, frames=DUMP_FRAMES, batch=DUMP_BATCH, shape=[HEIGHT, WIDTH],
         depth=34, launches=launches, launches_per_batch=launches / n_batches,
         files=len(gpu_files), first_batch_gpu_vs_cpu=gap, bar=f"{F16_BAR} + {F16_BAR}|cpu|",
         overlap_byte_identical=same, tree_seconds=tree_s)

    # Matterport at predict_simple's matterport shape, scored by the harness
    mp, mp_files = {}, {}
    mp_launches = 0
    for device in ("cuda", "cpu"):
        out = os.path.join(workdir, f"matterport_{device}")
        _, n = drive("dump", argv(device, "matterport", MATTERPORT_BATCH, out=out,
                                  hw=MATTERPORT_HW), real)
        mp_launches += n if device == "cuda" else 0
        expected = LAUNCHES_PER_FORWARD * -(-MATTERPORT_FRAMES // MATTERPORT_BATCH)
        fail.check(n == (expected if device == "cuda" else 0),
                   f"matterport dump on {device}: {n} launches")
        lines = readlines(os.path.join(paths["splits"], "matterport", "test.txt"))
        mp_files[device] = check_dump_files(
            fail, f"matterport {device}", out,
            [f"{s}/{p}_{h}_{d}.npy" for s, p, h, d in map(str.split, lines)],
            (4, *MATTERPORT_HW))
        mp[device] = {metric: {k: float(v) for k, v in evaluate(
            out, "matterport", metric, gt_dir=paths["gt"], split_root=paths["splits"],
            download=False, verbose=False).items()} for metric in ("iou", "depth")}
    # every file against its CPU twin, then the harness's metrics
    mp_gap = worst_f16_gap(mp_files["cuda"], mp_files["cpu"])
    fail.check(mp_gap <= F16_BAR, f"matterport dump: GPU vs CPU gap {mp_gap} (bar {F16_BAR})")
    diffs = [abs(v - mp["cpu"][m][k]) for m in mp["cuda"] for k, v in mp["cuda"][m].items()]
    fail.check(all(np.isfinite(v) for m in mp.values() for s in m.values() for v in s.values())
               and max(diffs) <= 1e-2,
               f"matterport metrics GPU {mp['cuda']} vs CPU {mp['cpu']}")
    emit("dump", matterport=dict(frames=MATTERPORT_FRAMES, batch=MATTERPORT_BATCH,
                                 shape=list(MATTERPORT_HW), launches=mp_launches,
                                 gpu_vs_cpu=mp_gap, bar=f"{F16_BAR} + {F16_BAR}|cpu|",
                                 metrics_gpu=mp["cuda"], metrics_cpu=mp["cpu"],
                                 max_metric_gap=max(diffs), metric_bar=1e-2))

    def make_manager(batch):
        opts = Options().parse(argv("cuda", batch=batch, split_root=paths["splits_timed"],
                                    out=gpu_out))
        return (InferenceManager if real else InMemoryInferenceManager)(opts)

    times = time_dumps(fail, make_manager, run_into, workdir, LAUNCHES_PER_FORWARD)
    emit("dump", times=times, model="FootprintNetwork-34, f32, 192x640")
    return launches + mp_launches


def phase_seg_dump(fail, workdir):
    """segmentation.main --mode inference: the ground_seg dump of the same
    frames, its checks and times.  Returns the entry-point run's launches."""
    real = have_dump_libs()
    paths = {"splits": os.path.join(workdir, "data", "splits"),
             "splits_timed": os.path.join(workdir, "data", "splits_timed"),
             "config": os.path.join(workdir, "data", "paths.yaml")}
    net = Segmentor(34, True, generator=torch.Generator().manual_seed(SEED))
    params, state = segmentor_jax_params_from_state_dict(net.state_dict(), 34, True)
    weights = os.path.join(workdir, "seg", "epoch_0")
    save_checkpoint(os.path.join(weights, "checkpoint.npz"),
                    {"params": params, "state": state})

    def argv(batch=DUMP_BATCH, folder="ground_seg", split_root=paths["splits"]):
        return ["--mode", "inference", "--test_data_type", "kitti",
                "--height", str(HEIGHT), "--width", str(WIDTH),
                "--batch_size", str(batch), "--num_workers", "8",
                "--config_path", paths["config"], "--split_root", split_root,
                "--encoder_depth", "34", "--load_path", weights, "--device", "cuda",
                "--test_save_folder", folder]

    route = ("footprints_tpu_torch.preprocessing.segmentation.main.main" if real else
             "Tester on in-memory images (no Pillow/PyYAML)")
    tester, launches = drive("seg", argv(), real)
    n_batches = -(-DUMP_FRAMES // DUMP_BATCH)
    fail.check(launches == SEG_LAUNCHES_PER_FORWARD * n_batches,
               f"seg_dump: {launches} kernel launches for {n_batches} batches, expected "
               f"{SEG_LAUNCHES_PER_FORWARD} per batch")
    lines = sorted(readlines(os.path.join(paths["splits"], "kitti", "train.txt"))
                   + readlines(os.path.join(paths["splits"], "kitti", "val.txt")))
    names = [f"seq0/{'image_02' if side == 'l' else 'image_03'}/data/{frame.zfill(10)}.npy"
             for _, frame, side in (line.split() for line in lines)]
    files = check_dump_files(fail, "seg_dump", tester.save_path, names, (1, HEIGHT, WIDTH))

    def run_into(t, folder, overlap):
        t.save_path = folder
        return t.test(overlap=overlap)

    same, n_same = byte_identical(lambda f, o: run_into(tester, f, o),
                                  os.path.join(workdir, "seg_overlap"))
    fail.check(same and n_same == DUMP_FRAMES,
               f"seg_dump: overlapped dump differs from the serial one ({n_same} files)")

    # the GPU forward against the CPU forward (plain versions), every scale
    cpu = Segmentor(34, True).eval()
    cpu.load_state_dict(tester.net.state_dict())
    x = torch.from_numpy(np.random.RandomState(SEED + 2).rand(
        2, HEIGHT, WIDTH, 3).astype(np.float32))
    with torch.inference_mode():
        got = tester.net(x.to(tester.device))
        ref = cpu(x)
    maes = {k: (g.float().cpu() - r).abs().mean().item() for k, g, r in zip(SCALES, got, ref)}
    for k, mae in maes.items():
        fail.check(mae < 1e-4, f"seg_dump: GPU vs CPU Segmentor at scale {k}: MAE {mae}")
    emit("seg_dump", route=route, frames=DUMP_FRAMES, batch=DUMP_BATCH,
         shape=[HEIGHT, WIDTH], depth=34, psp=True, launches=launches,
         launches_per_batch=launches / n_batches, files=len(files),
         overlap_byte_identical=same, gpu_vs_cpu_mae=maes, bar=1e-4)

    def make_manager(batch):
        opts = SegOptions().parse(argv(batch, "timed", paths["splits_timed"]))
        return (Tester if real else InMemoryTester)(opts)

    times = time_dumps(fail, make_manager, run_into, workdir, SEG_LAUNCHES_PER_FORWARD)
    emit("seg_dump", times=times, model="Segmentor-34 with PSP, f32, 192x640")
    return launches



# --- segmentation training ----------------------------------------------------

def label_field(rng, hw, values):
    """A [h, w] map of `values` in 32x32-pixel blocks (labelled regions, as
    real label maps have, rather than per-pixel noise)."""
    h, w = hw
    coarse = values[rng.randint(0, len(values), (h // 32 + 1, w // 32 + 1))]
    return np.repeat(np.repeat(coarse, 32, 0), 32, 1)[:h, :w]


def make_seg_trees(root):
    """ADE20K and Cityscapes trees as segmentation/datasets.py reads them:
    SEG_FILES ADE20K-shaped JPEGs with _seg.png labels (R // 10 * 256 + G
    ids, some of them ground) and SEG_FILES 2048x1024 Cityscapes PNGs with
    gtFine labelIds; train splits of 24 lines per dataset and val splits of
    6, cycling through the files, and a second split root whose train
    splits hold SEG_TIMED_BATCHES + 1 batches.  Returns (paths.yaml, split
    root, timed split root)."""
    import yaml
    from PIL import Image

    rng = np.random.RandomState(SEED + 5)
    ade, cs = os.path.join(root, "ade20k"), os.path.join(root, "cityscapes")
    # ADE20K (R, G) colours of ids 976 and 2131 (ground), 0 and 3079 (not)
    ade_colours = np.array([[30, 208], [80, 83], [0, 0], [120, 7]], np.uint8)
    ade_lines, cs_lines = [], []
    os.makedirs(ade)
    for i in range(SEG_FILES):
        Image.fromarray(smooth_frame(rng, ADE20K_HW)).save(os.path.join(ade, f"ade_{i}.jpg"))
        seg = np.zeros((*ADE20K_HW, 3), np.uint8)
        seg[..., :2] = ade_colours[label_field(rng, ADE20K_HW, np.arange(4))]
        Image.fromarray(seg).save(os.path.join(ade, f"ade_{i}_seg.png"))
        ade_lines.append(f"ade_{i}.jpg")
        city, frame = f"city{i % 2}", f"{i:06d}"
        for sub, name, arr in [
                ("leftImg8bit", f"{frame}_leftImg8bit.png", smooth_frame(rng, CITYSCAPES_HW)),
                ("gtFine", f"{frame}_gtFine_labelIds.png",
                 label_field(rng, CITYSCAPES_HW, np.array([0, 7, 8, 11, 22, 26], np.uint8)))]:
            folder = os.path.join(cs, sub, "train", city)
            os.makedirs(folder, exist_ok=True)
            Image.fromarray(arr).save(os.path.join(folder, name))
        cs_lines.append(f"train {city} {frame}")
    n_val = SEG_TRAIN_BATCH * SEG_VAL_BATCHES // 2
    roots = []
    for folder, steps in (("splits", SEG_TRAIN_STEPS), ("splits_timed", SEG_TIMED_BATCHES + 1)):
        roots.append(os.path.join(root, folder))
        n_train = SEG_TRAIN_BATCH * steps // 2
        for name, lines in (("ADE20K", ade_lines), ("cityscapes", cs_lines)):
            write_splits(roots[-1], name, {"train.txt": (lines * n_train)[:n_train],
                                           "val.txt": (lines * n_val)[:n_val]})
    config = os.path.join(root, "paths.yaml")
    with open(config, "w") as f:
        yaml.safe_dump({"ADE20K": {"dataset": ade}, "cityscapes": {"dataset": cs}}, f)
    return config, *roots


class InMemorySegSamples:
    """Seeded samples with the shapes, dtypes and value sets of the
    segmentation datasets' output at 192x640 (the route without Pillow or
    PyYAML)."""

    def __init__(self, n, seed):
        self.n, self.seed = n, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed + i)
        hw = (HEIGHT, WIDTH)
        labelled = (rng.rand(*hw) > 0.2).astype(np.float32)
        return {"image": rng.randint(0, 256, (*hw, 3)).astype(np.float32) / 255.0,
                "ground_mask": (rng.rand(*hw) > 0.5).astype(np.float32) * labelled,
                "labelled_pix": labelled}


class InMemorySegTrainer(seg_trainer.Trainer):
    train_batches = SEG_TRAIN_STEPS

    def create_dataloaders(self):
        bs = self.opt.batch_size
        return (DataLoader(InMemorySegSamples(bs * self.train_batches, 0), bs, shuffle=True,
                           num_workers=self.opt.num_workers, seed=seg_trainer.SEED),
                DataLoader(InMemorySegSamples(bs * SEG_VAL_BATCHES, 10_000), bs,
                           shuffle=True, num_workers=2, drop_last=True,
                           seed=seg_trainer.SEED))


class InMemoryTimedSegTrainer(InMemorySegTrainer):
    train_batches = SEG_TIMED_BATCHES + 1


def seg_step_on(device, host, dtype=torch.float32, compute=torch.float32):
    """One train step of the seeded Segmentor-34 (PSP) on `device`, its
    params in `dtype` (f64 only on the CPU, the plain versions), the forward
    in `compute`: (loss metrics as floats, f64 grads by name on the CPU, BN
    running stats, the params' dtypes, the count of full-resolution logits
    that are exactly 0)."""
    net = Segmentor(34, True, device=device, generator=torch.Generator().manual_seed(SEED))
    net.to(dtype)
    zeros = []
    net.decoder.outconv4[1].register_forward_hook(
        lambda module, inputs, out: zeros.append(int((out == 0).sum())))
    optimizer = make_optimizer(net, TrainStepConfig())
    step = seg_trainer.build_train_step(net, optimizer, lambda s: 1e-4, compute)
    metrics = step(0, {k: torch.from_numpy(v).to(device, dtype) for k, v in host.items()})
    grads = {n: p.grad.detach().cpu().double() for n, p in net.named_parameters()
             if p.grad is not None}
    stats = {k: v.detach().cpu().double() for k, v in net.state_dict().items()
             if "running" in k}
    dtypes = {p.dtype for p in net.parameters()} | {p.grad.dtype for p in net.parameters()
                                                     if p.grad is not None}
    return ({k: float(v) for k, v in metrics.items() if k != "lr"}, grads, stats, dtypes,
            zeros[0])


def whole_rel(got, ref):
    """||got - ref|| / ||ref|| over all gradient leaves as one vector."""
    return float(torch.cat([(got[k] - v).flatten() for k, v in ref.items()]).norm()
                 / torch.cat([v.flatten() for v in ref.values()]).norm())


def phase_seg_train(fail, workdir):
    """segmentation.main --mode train in f32, then in bf16; the checkpoint
    loads into a second Trainer; GPU steps in f32 and bf16 against CPU
    steps.  Returns (launches of the two runs, a batch-12 host batch, a
    function building a Trainer over the timed split in a dtype)."""
    real = have_dump_libs()
    argv = ["--mode", "train", "--height", str(HEIGHT), "--width", str(WIDTH),
            "--batch_size", str(SEG_TRAIN_BATCH), "--epochs", "1",
            "--val_batches", str(SEG_VAL_BATCHES), "--host_batch_compact", "exact",
            "--encoder_depth", "34", "--num_workers", "8", "--device", "cuda",
            "--log_path", os.path.join(workdir, "seg_logs")]
    t0 = time.perf_counter()
    if real:
        route = (f"footprints_tpu_torch.preprocessing.segmentation.main.main (synthetic "
                 f"ADE20K {ADE20K_HW[0]}x{ADE20K_HW[1]} JPEGs and Cityscapes "
                 f"{CITYSCAPES_HW[0]}x{CITYSCAPES_HW[1]} PNGs)")
        config, splits, timed_splits = make_seg_trees(os.path.join(workdir, "seg_data"))
        argv += ["--config_path", config, "--split_root", splits]
    else:
        route = "segmentation Trainer with in-memory samples (no Pillow/PyYAML)"
        argv += ["--config_path", "unused"]
        timed_splits = "unused"
    tree_s = time.perf_counter() - t0

    def trainer_for(args, timed=False):
        cls = (seg_trainer.Trainer if real
               else InMemoryTimedSegTrainer if timed else InMemorySegTrainer)
        return cls(SegOptions().parse(args))

    def timed_trainer(name):
        # the last --split_root is the one argparse keeps
        return trainer_for(argv + ["--split_root", timed_splits, "--compute_dtype", name,
                                   "--model_name", f"seg_timed_{name}"], timed=True)

    launches, runs, trainers = 0, {}, {}
    expected = SEG_LAUNCHES_PER_FORWARD * (SEG_TRAIN_STEPS + SEG_VAL_BATCHES)
    for name, dtype in SEG_DTYPES.items():
        args = argv + ["--compute_dtype", name, "--model_name", f"seg_{name}"]
        # the main path: counts set to 0 just before, read just after
        fused_conv3x3.launches = fused_conv3x3.bf16_launches = 0
        torch.cuda.reset_peak_memory_stats()
        if real:
            trainer = seg_main.main(args)
        else:
            trainer = trainer_for(args)
            trainer.train()
        torch.cuda.synchronize()
        n, n_bf16 = fused_conv3x3.launches, fused_conv3x3.bf16_launches
        launches += n
        trainers[name] = trainer
        n_val = sum(1 for mode, _, _ in trainer.logged if mode == "val")
        want_bf16 = SEG_LAUNCHES_PER_FORWARD * SEG_TRAIN_STEPS if dtype == torch.bfloat16 else 0
        fail.check(n_val == 1 and n == expected and n_bf16 == want_bf16,
                   f"seg_train {name}: {n} kernel launches ({n_bf16} bf16), expected "
                   f"{expected} ({want_bf16} bf16): 5 per training forward, 5 per "
                   f"validation forward; {n_val} validation events")
        rest = trainer.evaluator.get_averaged_losses("train")
        fail.check(trainer.step == SEG_TRAIN_STEPS
                   and [(m, s_) for m, s_, _ in trainer.logged] == [("train", 0), ("val", 0)]
                   and all(finite_losses(losses) for _, _, losses in trainer.logged)
                   and finite_losses(rest),
                   f"seg_train {name}: step {trainer.step}, logged {trainer.logged}, "
                   f"later steps {rest}")
        masters = {p.dtype for p in trainer.net.parameters()}
        fail.check(masters == {torch.float32},
                   f"seg_train {name}: master params in {masters}, expected float32")
        ckpt = os.path.join(trainer.opt.log_path, f"seg_{name}", "models", "epoch_0")
        ok = os.path.exists(os.path.join(ckpt, "checkpoint.npz"))
        if ok:
            loaded = load_checkpoint(os.path.join(ckpt, "checkpoint.npz"))
            ok = sorted(loaded) == ["params", "state"] and all(
                a.dtype == np.float32 and np.isfinite(a).all()
                for a in tree_arrays(loaded))
        fail.check(ok, f"seg_train {name}: {ckpt}/checkpoint.npz missing, not f32 or "
                       f"not finite")
        runs[name] = {"launches": n, "bf16_launches": n_bf16, "launches_expected": expected,
                      "logged": [[m, s_, losses["loss"]] for m, s_, losses in trainer.logged],
                      "checkpoint": os.path.relpath(ckpt, workdir),
                      "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "epoch_seconds_with_first_batch_and_validation": trainer.train_seconds}

    # a second Trainer loads the f32 run's checkpoint through --load_path
    first = trainers["float32"]
    second = trainer_for(argv + ["--model_name", "seg_reload", "--load_path",
                                 os.path.join(workdir, runs["float32"]["checkpoint"])])
    want = first.net.state_dict()
    fail.check(all(torch.equal(v, want[k]) for k, v in second.net.state_dict().items()),
               "seg_train: the second Trainer's weights differ from the checkpointed ones")

    host = next(iter(first.train_loader))
    for t in (*trainers.values(), second):
        t.val_iter.close()
    emit("seg_train", route=route, batch=SEG_TRAIN_BATCH, steps=SEG_TRAIN_STEPS,
         shape=[HEIGHT, WIDTH], depth=34, psp=True, datasets=["ADE20K", "cityscapes"],
         runs=runs, reloaded=True, tree_seconds=tree_s)
    seg_check_steps(fail)
    return launches, host, timed_trainer


def seg_check_steps(fail):
    """One seg step of the seeded Segmentor-34 (PSP) at batch 2 on a seeded
    noise batch (as tests/test_torch_seg_step.py picks its input), from the
    same weights on the GPU and the CPU.  f32: the GPU step against an f64
    CPU step at PR 3's bars (loss terms 1e-5 + 1e-5|ref|, each gradient leaf
    ||d||/||ref|| < 2e-2, BN stats 1e-5), with a CPU f32 step's reading
    beside it: at batch 2 train-mode BN's backward nearly cancels at the deep
    encoder's leaves, where a sound f32 step can sit 1e-2 from f64, and the
    CPU f32 step shows where one sits on this input.  bf16:
    finite losses within 1e-2 of the f32 step's, f32 masters and gradients,
    and the GPU bf16 gradient (cuDNN's bf16 convs, the kernel's bf16 route,
    the mixed BN's backward on CUDA) no farther from the f64 step than twice
    the CPU bf16 step's distance (the same code on the CPU, held against the
    JAX package by tests/test_torch_seg_step.py): the whole gradient, and
    each leaf plus 1e-3.  Printed beside them: how many of each step's
    full-resolution logits are exactly 0, where the loss's gradient takes a
    subgradient (train/losses.py:bce_with_logits)."""
    small = collate([InMemorySegSamples(CHECK_BATCH, CHECK_SEED)[i] for i in range(CHECK_BATCH)])
    runs = {"gpu_f32": ("cuda", torch.float32, torch.float32),
            "cpu_f32": ("cpu", torch.float32, torch.float32),
            "cpu_f64": ("cpu", torch.float64, torch.float32),
            "gpu_bf16": ("cuda", torch.float32, torch.bfloat16),
            "cpu_bf16": ("cpu", torch.float32, torch.bfloat16)}
    steps, seconds = {}, {}
    for name, (device, dtype, compute) in runs.items():
        t0 = time.perf_counter()
        steps[name] = seg_step_on(device, small, dtype, compute)
        seconds[name] = time.perf_counter() - t0
    (m_gpu, g_gpu, s_gpu, *_), (m_ref, g_ref, s_ref, *_) = steps["gpu_f32"], steps["cpu_f64"]
    worst_loss = max(abs(m_gpu[k] - v) for k, v in m_ref.items())
    loss_ok = all(abs(m_gpu[k] - v) <= 1e-5 + 1e-5 * abs(v) for k, v in m_ref.items())
    leaf, rel = worst_grad_leaf(g_gpu, g_ref)
    cpu_leaf, cpu_rel = worst_grad_leaf(steps["cpu_f32"][1], g_ref)
    bn_err = max(float((s_gpu[k] - v).abs().max()) for k, v in s_ref.items())
    fail.check(loss_ok, f"seg_train: GPU vs CPU loss terms differ by up to {worst_loss}")
    fail.check(g_gpu.keys() == g_ref.keys() and rel < 2e-2,
               f"seg_train: GPU vs CPU gradient of {leaf}: {rel}")
    fail.check(bn_err <= 1e-5, f"seg_train: GPU vs CPU BN running stats differ by {bn_err}")

    m_bf16, g_bf16, _, dtypes_bf16, _ = steps["gpu_bf16"]
    g_cpu16 = steps["cpu_bf16"][1]
    bf16_gap = max(abs(m_bf16[k] - v) for k, v in m_gpu.items())
    fail.check(finite_losses(m_bf16) and bf16_gap < 1e-2 and dtypes_bf16 == {torch.float32}
               and g_bf16.keys() == g_ref.keys() == g_cpu16.keys(),
               f"seg_train: bf16 step losses {m_bf16} vs f32 {m_gpu}, masters and "
               f"grads in {dtypes_bf16}")
    whole = {"gpu_bf16": whole_rel(g_bf16, g_ref), "cpu_bf16": whole_rel(g_cpu16, g_ref)}
    fail.check(whole["gpu_bf16"] <= 2 * whole["cpu_bf16"],
               f"seg_train: the GPU bf16 gradient sits {whole['gpu_bf16']} from the f64 "
               f"step, the CPU bf16 one {whole['cpu_bf16']}")
    leaf_gap = {}  # leaf: (GPU bf16 to f64, CPU bf16 to f64)
    for k, v in g_ref.items():
        norm = float(v.norm().clamp_min(1e-30))
        leaf_gap[k] = (float((g_bf16[k] - v).norm()) / norm, float((g_cpu16[k] - v).norm()) / norm)
    over = {k: d for k, d in leaf_gap.items() if d[0] > 2 * d[1] + 1e-3}
    fail.check(not over, f"seg_train: GPU bf16 gradient leaves farther from the f64 step "
                         f"than twice the CPU bf16 step's, plus 1e-3: {over}")
    worst_ratio = max(leaf_gap, key=lambda k: leaf_gap[k][0] / max(leaf_gap[k][1], 1e-30))
    least_margin = min(leaf_gap, key=lambda k: 2 * leaf_gap[k][1] + 1e-3 - leaf_gap[k][0])
    emit("seg_train", gpu_vs_cpu_step=dict(
        batch=CHECK_BATCH, shape=[HEIGHT, WIDTH], input=f"noise, seed {CHECK_SEED}",
        reference="CPU, f64", loss_max_abs_err=worst_loss, loss_bar="1e-5 + 1e-5|ref|",
        worst_grad_leaf=leaf, worst_grad_rel=rel, grad_bar=2e-2,
        cpu_f32_worst_grad_leaf=cpu_leaf, cpu_f32_worst_grad_rel=cpu_rel,
        bn_max_abs_err=bn_err, bn_bar=1e-5),
        bf16_step={"losses_f32": m_gpu, "losses_bf16": m_bf16,
                   "max_abs_gap_to_f32": bf16_gap, "sanity_bar": 1e-2,
                   "whole_grad_rel_to_f64": whole, "whole_bar": "2 x CPU bf16's",
                   "whole_grad_rel_gpu_to_cpu_bf16": whole_rel(g_bf16, g_cpu16),
                   "whole_grad_rel_gpu_bf16_to_gpu_f32": whole_rel(g_bf16, g_gpu),
                   "leaf_bar": "2 x CPU bf16's + 1e-3",
                   "zero_logits_1_1": {k: v[4] for k, v in steps.items()},
                   "worst_leaf_ratio": [worst_ratio, *leaf_gap[worst_ratio]],
                   "least_leaf_margin": [least_margin, *leaf_gap[least_margin]]},
        seconds=seconds)


def tree_arrays(tree):
    """The arrays of a checkpoint pytree (nested dicts, lists, tuples)."""
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in tree_arrays(v)]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in tree_arrays(v)]
    return [] if tree is None else [np.asarray(tree)]


def site_backward_bf16(fail, batch):
    """At each fused site at `batch`, on the card: the kernel's bf16 route
    and the autograd Function's bf16 gradients (x, the full weight, b, the
    residual) against autograd through the f32 plain version on the same
    bf16-rounded tensors and cotangent.  Bars: the output within 2e-2 +
    2e-2|ref| (phase sites' bf16 bar); every gradient ||d||/||ref|| < 2e-2
    and elementwise within 2e-2 max|ref| + 2e-2|ref| (cuDNN's bf16 dgrad
    and wgrad of bf16 cotangents, each result rounded to 8 bits).  Then the
    bf16 forward and backward timed, ms per call."""
    rows = []
    for si, site in enumerate(sites(batch)):
        name, pad_mode, _, _, _, _, act = site
        x, w, b, r = site_inputs(site, torch.bfloat16, seed=500 + si)
        halves = w._base is not None
        ci = x.shape[-1]
        inputs = {k: t for k, t in (("x", x), ("w", w._base if halves else w),
                                    ("b", b), ("residual", r)) if t is not None}

        def weight(full):
            if not halves:
                return full
            return full[:, :ci] if name.endswith("up_half") else full[:, ci:]

        def leaves(dtype):
            return {k: t.detach().to(dtype).requires_grad_(True) for k, t in inputs.items()}

        ls = leaves(torch.bfloat16)
        if pad_mode == "up2_reflect":
            y = fc.up_conv_fused(ls["x"], weight(ls["w"]), ls.get("b"), act=act)
        elif r is not None:
            y = fc.conv_reflect_res_fused(ls["x"], weight(ls["w"]), ls["b"],
                                          ls["residual"], act=act)
        else:
            y = fc.conv_reflect_fused(ls["x"], weight(ls["w"]), ls["b"], act=act)
        gy = torch.randn(y.shape, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(600 + si)
                         ).to(torch.bfloat16)
        got = torch.autograd.grad(y, list(ls.values()), gy, retain_graph=True)
        ls32 = leaves(torch.float32)
        y32 = fused_conv3x3_plain(ls32["x"], weight(ls32["w"]), ls32.get("b"),
                                  ls32.get("residual"), pad_mode=pad_mode, act=act)
        ref = torch.autograd.grad(y32, list(ls32.values()), gy.float())
        errs = {}
        for k, a, e in [("y", y, y32), *zip(ls, got, ref)]:
            a, e = a.detach().float(), e.detach()
            d = (a - e).abs()
            rel = float((a - e).norm() / e.norm())
            if k == "y":
                ok = bool((d <= 2e-2 + 2e-2 * e.abs()).all())
            else:
                ok = bool((d <= 2e-2 * e.abs().max() + 2e-2 * e.abs()).all()) and rel < 2e-2
            errs[k] = {"max_abs": d.max().item(), "rel": rel,
                       "max_over_max_ref": d.max().item() / e.abs().max().item()}
            fail.check(ok and bool(torch.isfinite(a).all()) and a.dtype == torch.float32,
                       f"seg_train_times: {name} at batch {batch}: bf16 {k} vs autograd "
                       f"of the f32 plain version, {errs[k]}")
        fail.check(y.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in got),
                   f"seg_train_times: {name}: the bf16 route returned {y.dtype}")
        del y32, ref, ls32
        fixed = [None if t is None else t.detach()
                 for t in (ls["x"], weight(ls["w"]), ls.get("b"), ls.get("residual"))]

        def forward():
            with torch.no_grad():
                return fused_conv3x3(*fixed, pad_mode=pad_mode, act=act)

        def backward():
            return torch.autograd.grad(y, list(ls.values()), gy, retain_graph=True)

        rows.append({"site": name, "err_vs_f32_plain": errs, "forward_ms": time_ms(forward),
                     "backward_ms": time_ms(backward)})
    return rows


def steady_epoch_rate(fail, trainer, saver=None, launches_per_batch=SEG_LAUNCHES_PER_FORWARD):
    """imgs/s of trainer.train() from the end of its first step (its
    loading, cuDNN's first calls) to the end of its last: the loader,
    compaction, prefetcher and step of the trainer's own loop.  The trainer
    starts at step 1, past step 0's log event and validation, and the
    epoch's checkpoint (the save_model of `saver`, the trainer unless
    given) is replaced by the closing stamp."""
    stamps = []

    def stamp(*_, **__):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    step_fn = trainer.train_step

    def train_step(step, batch):
        metrics = step_fn(step, batch)
        if not stamps:
            stamp()
        return metrics

    trainer.train_step, trainer.step = train_step, 1
    (saver or trainer).save_model = stamp
    trainer.val_iter.close()
    fused_conv3x3.launches = 0
    trainer.train()
    n = len(trainer.train_loader)
    fail.check(len(stamps) == 2 and not trainer.logged
               and fused_conv3x3.launches == launches_per_batch * n,
               f"{type(trainer).__name__}: timed epoch of {n} batches logged "
               f"{trainer.logged}, {fused_conv3x3.launches} launches")
    return (n - 1) * trainer.opt.batch_size / (stamps[-1] - stamps[0])


def loader_rate(loader):
    """imgs/s of the loader alone, from its first batch to its last."""
    batches = iter(loader)
    next(batches)
    t0 = time.perf_counter()
    n = sum(len(b["image"]) for b in batches)
    return n / (time.perf_counter() - t0)


def phase_seg_train_times(fail, host, timed_trainer):
    """The trainer with its loader in f32 and bf16 and the loader alone,
    each over SEG_TIMED_BATCHES batches of 12 after an untimed first batch;
    the seg step alone on a batch already on the card, f32 and bf16, at
    batch 12 and 16: ms, imgs/s, peak memory, the forward / backward / Adam
    split, and one profiled step's busy time with the cliff conv's share
    (forward, and its backward, from unions of device intervals); then the
    bf16 route at each fused site at batch 12."""
    trainer_rates = {}
    for name in SEG_DTYPES:
        trainer = timed_trainer(name)
        trainer_rates[name] = steady_epoch_rate(fail, trainer)
    loader_alone = loader_rate(trainer.train_loader)
    del trainer
    rows = {}
    host16 = {k: np.concatenate([v, v[:4]]) for k, v in host.items()}
    for name, dtype in SEG_DTYPES.items():
        for batch, h in ((12, host), (16, host16)):
            net = Segmentor(34, True, device="cuda", generator=torch.Generator().manual_seed(SEED))
            optimizer = make_optimizer(net, TrainStepConfig())
            step = seg_trainer.build_train_step(net, optimizer, lambda s: 1e-4, dtype)
            b = {k: torch.from_numpy(v).cuda() for k, v in h.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: step(0, b), iters=10, warmup=3)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            split = {"forward_loss_ms": 0.0, "backward_ms": 0.0, "adam_ms": 0.0}
            for _ in range(5):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                ev[0].record()
                losses = compute_seg_losses(forward_in(net, b["image"], dtype),
                                            b["ground_mask"], b["labelled_pix"])
                ev[1].record()
                optimizer.zero_grad(set_to_none=True)
                losses["loss"].backward()
                ev[2].record()
                optimizer.step()
                ev[3].record()
                torch.cuda.synchronize()
                for i, key in enumerate(split):
                    split[key] += ev[i].elapsed_time(ev[i + 1]) / 5
            wall_ms, raw = profiled(lambda: step(0, b))
            busy = span_summary(device_spans(raw))
            fwd = span_summary(device_spans(raw, cliff_op_ids(raw, batch)))
            bwd = span_summary(device_spans(raw, cliff_op_ids(raw, batch, backward=True)))
            fail.check(busy["ms_union"] > 0 and fwd["ms_union"] > 0,
                       f"seg_train_times {name} b{batch}: the profile saw no device time "
                       f"or no cliff conv kernel")
            rows[f"{name}_b{batch}"] = {
                "step_ms": ms, "imgs_per_s": batch / (ms * 1e-3), "peak_memory_gib": peak,
                **split, "profiled_wall_ms": wall_ms, "busy_ms_union": busy["ms_union"],
                "busy_share_of_profiled_wall": busy["ms_union"] / wall_ms,
                "cliff_fwd_ms_union": fwd["ms_union"], "cliff_fwd_kernels_streams": fwd["streams"],
                "cliff_fwd_share_of_busy": fwd["ms_union"] / max(busy["ms_union"], 1e-9),
                "cliff_bwd_ms_union": bwd["ms_union"],
                "cliff_bwd_share_of_busy": bwd["ms_union"] / max(busy["ms_union"], 1e-9)}
            del net, optimizer, step, b
            torch.cuda.empty_cache()
    emit("seg_train_times", model="Segmentor-34 with PSP, 192x640", steps=rows,
         trainer_imgs_per_s_with_loader=trainer_rates, loader_alone_imgs_per_s=loader_alone,
         timed_batches=SEG_TIMED_BATCHES, timed_frames=SEG_TIMED_BATCHES * SEG_TRAIN_BATCH)
    site_rows = site_backward_bf16(fail, SEG_TRAIN_BATCH)
    per_step = {"forward_ms_per_step": sum(r["forward_ms"] for r in site_rows),
                "backward_ms_per_step": sum(r["backward_ms"] for r in site_rows)}
    emit("seg_train_times", kernel=KERNEL["name"], route=ROUTES[torch.bfloat16],
         batch=SEG_TRAIN_BATCH, sites=site_rows,
         reference="autograd of the f32 plain version, same bf16-rounded tensors",
         bars={"y": "2e-2 + 2e-2|ref|",
               "x, w, b, residual": "2e-2 max|ref| + 2e-2|ref|, ||d||/||ref|| < 2e-2"},
         **per_step)
    return per_step


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

    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    max_abs = timed("sites", phase_sites, fail)
    with tempfile.TemporaryDirectory() as workdir:
        launches, net = timed("main", phase_main, fail, workdir)
    totals = timed("times", phase_times, net)
    timed("profile", phase_profile, net)
    del net
    with tempfile.TemporaryDirectory() as workdir:
        train_launches, host, epoch, run = timed("train", phase_train, fail, workdir)
        timed("train_times", phase_train_times, fail, host, epoch)
        train_launches += timed("train_bf16", phase_train_bf16, fail, run, workdir)
        timed("train_bf16_times", phase_train_bf16_times, fail, host, run)
    with tempfile.TemporaryDirectory() as workdir:
        dump_launches = timed("dump", phase_dump, fail, workdir)
        seg_launches = timed("seg_dump", phase_seg_dump, fail, workdir)
    with tempfile.TemporaryDirectory() as workdir:
        seg_train_launches, seg_host, timed_trainer = timed(
            "seg_train", phase_seg_train, fail, workdir)
        bf16_sites = timed("seg_train_times", phase_seg_train_times, fail, seg_host,
                           timed_trainer)
    # the FootprintNetwork's bf16 training runs the same 5 site shapes in
    # each of its 2 decoders
    emit("train_bf16_times", kernel=KERNEL["name"], route=ROUTES[torch.bfloat16],
         batch=TRAIN_BATCH, launches_per_step_forward=LAUNCHES_PER_FORWARD,
         forward_ms_per_step=2 * bf16_sites["forward_ms_per_step"],
         backward_ms_per_step=2 * bf16_sites["backward_ms_per_step"],
         source="phase seg_train_times' per-site bf16 times at batch 12, x2 decoders")
    launches += train_launches + dump_launches + seg_launches + seg_train_launches
    emit("seconds", **seconds)

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
