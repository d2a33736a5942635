#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (footprints_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero without the
final result line:

  1. device   torch and CUDA versions, the card's name and power limit;
  2. build    nvcc-builds the CUDA kernels from footprints_tpu_torch/csrc/;
  3. sites    holds fused_conv3x3 against its plain PyTorch version at the
              decoder sites (kernel_sites: each call of the kernel in the
              model's forward) of the kitti 192x640 forward, batch 4, in f32
              (atol = rtol = 1e-4, TF32 off on both sides: 576-term dot
              products summed in another order) and bf16 (2e-2 against the
              f32 plain version on the same bf16-rounded inputs: the output
              is rounded to bf16), and at the sites of the Matterport
              dump's 512x640 forward, batch 4, in f32;
  4. main     writes a seeded FootprintNetwork-34 as model.pth and serves
              it through footprints_tpu_torch.predict_simple on the GPU: one
              image, then folder mode over test_data/, each run again with
              --device cpu.  Checks each .npy is a finite [4,192,640] map
              within MAE 1e-4 of its CPU twin, that each GPU run captured
              one CUDA graph of the forward and called the kernel twice a
              site (the capture's warm-up and the capture; a replay calls
              no wrapper), and that the GPU forward matches the CPU forward
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
              peak, each at least the site's bytes at the HBM rate, and
              the share of that bound in the device time (graph); then the
              serving forward's imgs/s at batch 16 and the single-image p50,
              and the op's host cost per call (two device launches: the
              weight pre-pack and the kernel);
  6. profile  torch.profiler device time by kernel over the batch-16
              forward, the idle share, and the full table in
              smoke_out/profile_b16.json; checks the forward's two device
              kernels (the pre-pack and the main kernel) ran once a site
              each per forward;
  7. train    trains FootprintNetwork-34 at 192x640, batch 12, through
              footprints_tpu_torch.main on a synthetic KITTI tree of
              375x1242 frames (where PIL, OpenCV and PyYAML all import;
              otherwise TrainManager with in-memory samples of the same
              shapes through the same loader, compactor, prefetcher and
              step, and the route says so): 4 steps, one validation batch
              at step 0, 'exact' compact transport.  Checks every logged
              loss is finite, weights_0/checkpoint.npz holds step 4, a
              second TrainManager resumes step 4 and the Adam moments, and
              the kernel ran once a site per training forward and per
              validation forward, the dgrad and wgrad kernels once a site
              each per step (the same counts in every rank of phases dp and
              spatial, and the Segmentor's sites in every training phase).
              Then one GPU step against one CPU step
              in f64 from the same weights and batch (batch 2, 192x640, the
              first validation samples): each loss term within
              1e-5 + 1e-5|ref|, each gradient leaf ||d||/||ref|| < 2e-2
              (worst printed), BN running stats within 1e-5;
  8. train_times  the train step alone on a batch-12 batch already on the
              card (mean of 10 steps after 3 warm-up, CUDA events): ms,
              imgs/s and peak memory; its forward / backward / Adam split;
              the trainer's own rate over phase 7's epoch, loader
              included; at each fused site at batch 12, the kernel's output
              and the op's registered gradients (x, the full weight, b,
              the residual) against autograd through the plain version in
              f64 on the same card tensors (output, x, residual 1e-4 +
              1e-4|ref|; weight and b, sums of 368640 or more products,
              1e-3 max|ref| + 1e-3|ref| and ||d||/||ref|| < 1e-4), beside
              the f32 plain version's own distance to it, the dgrad and
              wgrad kernels against their plain versions in f64 at the
              same bars, then the kernel's forward, the Function's
              backward (the dgrad and wgrad kernels) and the same
              backward on cuDNN (cudnn_backward) timed, each backward
              kernel beside its plain version, its cuDNN counterpart and
              its bound, and one profiled backward that must show both
              kernels' device kernels (dgrad's weight pre-pack and main
              kernel, wgrad's partial sums and their sum) and no cuDNN
              conv kernel; the same at batch 4; a
              torch.profiler table of one
              step by category with the idle share (1 - kernel time / the
              profiled step's CUDA-event span, unclamped) and the top
              operators by input shape, in full in
              smoke_out/profile_train_b12.json; and
              cuDNN's time for every conv of both models' decoders that
              cuDNN runs (recorded from a forward) at batch 4, 8, 12 and
              16, with the default heuristics and with
              torch.backends.cudnn.benchmark on (restored after), and the
              shapes and batches on a cliff (smoke_out/cudnn_probe.json);
  8a. probe  the clock64() probe (footprints_tpu_torch/ops/probe.py, its
              library built beside the main one during phase 2) of the
              forward, dgrad and wgrad kernels at batch 12 on tail.conv1 and
              block4.post.conv2, f32 and bf16: one JSON line per kernel with
              the shares of a block's cycles spent waiting (on copies,
              mbarriers, barriers), staging (issuing copies, the f32
              split), in the MMAs and in the epilogue, and the blocks
              resident per SM; the launch counters do not move;
  8b. train_bf16  on phase 7's data, main --mode train --compute_dtype
              bfloat16 (the packed heads on by 'auto'): 4 steps and the
              step-0 validation, every launch on the bf16 route, f32
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
  8d. dp     data parallelism (footprints_tpu_torch/parallel/), on phase 7's
              tree and batch: (a) python -m torch.distributed.run
              --standalone --nproc_per_node=1 -m footprints_tpu_torch.main
              --mode train (NCCL, world 1) at batch 12: a launch a site a
              forward (read from the rank's last line), a finite logged loss,
              weights_0/checkpoint.npz at step 4 written once and resumed
              by a plain TrainManager; (b) dryrun_multichip(2,
              device='cuda'): two ranks on the one card over gloo, one f32
              step and one bf16 packed-head step of FootprintNetwork-34 at
              192x640, 2 images a rank, replicas bitwise equal after each,
              a launch a site per rank per forward (the bf16 ones on the
              bf16 route); (c) on phase 8b's batch-2 noise batch, the world-1
              (NCCL) and world-2 (gloo, 1 image a rank) DP steps against
              the f64 CPU step of phase 8b at phase 7's bars, the
              single-process GPU step's distance printed beside them; (d)
              a Segmentor-34 (PSP) world-2 f32 step, replicas bitwise
              equal, against its f64 CPU step at the same bars; (e) the
              world-1 DP step against the plain step at batch 12, f32 and
              bf16 with the packed heads, in turns (CUDA events), and the
              world-2 step's time at batch 12 with one profiled step's
              all-reduce host time net of gloo's stream synchronise (its
              wait for queued compute), the card's busy share summed over
              both ranks, peak memory per rank (no claim);
  8d'. spatial  row-sharded eval (footprints_tpu_torch/parallel/halo.py),
              every rank on the one card over gloo, seeded weights (seed
              10), noise batches: (a) FootprintNetwork-34 at 192x640,
              batch 4, 2 row shards: the f32 eval losses on every rank
              within 1e-5 + 1e-5|ref| of the single-process eval on the
              card, the gathered '1/1' map within MAE 1e-4, a launch a site
              a rank a forward; the bf16 eval with the packed heads no
              farther from the f32 eval than twice the single process's
              bf16 eval + 1e-3, every launch on the bf16 route; (b)
              Segmentor-34 (PSP), the same at its own sites (one world of 2
              with (a)); (c) FootprintNetwork-34 at 512x640, batch 2, 4 row
              shards (middle ranks with a seam on each side), as (a).  In
              each, every kernel call of the main path (on the rank's rows
              plus its seam rows) against the plain version on the same
              input at phase sites' bars.  Printed, no claim: the f32 eval
              step's ms on every rank against the single process (CUDA
              events), peak activation memory a rank, the exchanges' host
              ms in one profiled step, the exchanges per eval step, and
              cuDNN's f32 time of the decoder's 1/4-scale convs at the
              shard shapes, NCHW against channels_last.  Then row-sharded
              training in the same worlds (footprints_tpu_torch/
              parallel/halo.py's adjoints): one f32 and one bf16 train step
              (the FootprintNetwork's with the packed heads) of (a), (b)
              and (c) from the seeded weights, against the same step in one
              process on the card: f32 losses within 1e-5 + 1e-5|ref|,
              each gradient leaf before Adam ||d||/||ref|| < 2e-2 (worst
              printed), BN running stats within 1e-5, the replicas bitwise
              equal over the ranks after Adam, a launch a site a rank in
              the forward and none in the backward, one of each backward
              kernel a site a rank; bf16 no farther from
              the one-process f32 step than twice the one-process bf16
              step, plus 1e-3 at a loss term and 2^-8 at a gradient leaf.
              Printed, no claim: the f32 train step's ms a rank against
              one process, the exchanges a step (forward and backward),
              their host ms in one profiled step, and peak memory a rank;
  8e. export  exports phase main's seeded FootprintNetwork-34 through
              python -m footprints_tpu_torch.export on the card (a saved
              torch.export program with the kernel as the custom op
              footprints::fused_conv3x3): a bf16 batch-16 artifact served
              over test_data/ through predict_simple --artifact (each .npy a
              finite [4,192,640] map; a launch a site per batch, all bf16); a
              bf16 batch-2 artifact on the card and on the CPU, each against
              the live f32 forward on its device (per-channel MAE: the card's
              at most twice the CPU's + 1e-3); an f32 batch-2 artifact
              within MAE 1e-4 of the live f32 forward; a seeded Segmentor-34
              (PSP) bf16 artifact at batch 12 through predict_simple's
              manager (a bf16 launch a site) against the live f32 Tester.forward
              on the same frames, under the same rule.  Each export's wall
              time, size and count of ATen calls in its graph;
  8f. export_times  the bf16 artifact's imgs/s at batch 16 and p50 at
              batch 1 beside the live f32 forward's (phase times' method, in
              turns), ServingModel.call's rate on numpy, one profiled
              artifact forward at 16 (busy share, the kernel's share of it,
              smoke_out/profile_artifact_b16.json); the native LANCZOS
              resize of 8 seeded 375x1242 frames to 192x640, byte for byte
              against PIL's, ms per frame each; the KITTI trainer's loader
              alone over phase 7's tree with FOOTPRINTS_NATIVE_RESIZE unset
              and set;
  9. dump     writes a seeded FootprintNetwork-34 checkpoint.npz and dumps a
              synthetic KITTI test split of 26 frames (375x1242) through
              footprints_tpu_torch.main --mode inference on the GPU at
              192x640, batch 12 (a padded tail of 2): where Pillow and
              PyYAML import, the real dataset; otherwise InferenceManager
              over in-memory images with the same {'image', 'idx'} contract
              and save_result, and the route says so.  Checks the 26 files
              (float16 [4,192,640], finite, sigmoid channels in [0,1]), a
              launch a site per batch, the first batch against a --device cpu
              run (2e-3 + 2e-3|cpu|), and the overlapped dump byte-identical
              to the serial one.  Then a Matterport dump at 512x640 (6
              frames, batch 4) on the GPU and its --device cpu twin: every
              file within 2e-3 + 2e-3|cpu| of its twin, and each dump
              scored by footprints_tpu_torch.eval.evaluate (iou and depth,
              download=False) on synthetic npy ground truth: finite, GPU
              and CPU within 1e-2.  Times the dump (loader and writer
              included, host clock ending in a synchronise) over 192 frames
              (the 26, cycled) at batch 12 and 16, serial and overlapped,
              and cuDNN's time alone for the block2 post-concat conv that
              the fused kernel now runs (a yardstick); and profiles one
              overlapped dump at each: the device's busy share from the
              union of the device events' intervals, beside their summed
              durations and how many of them overlap on one stream, and
              no cuDNN conv kernel at that conv's input;
 10. seg_dump the same for a seeded Segmentor-34 with PSP through
              footprints_tpu_torch.preprocessing.segmentation.main --mode
              inference over the sorted train+val split of the same 26
              frames: the ground_seg tree (float16 [1,192,640] in [0,1]), a
              launch a site per batch, overlap byte-identical to serial, the GPU
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
              logged loss is finite, a launch a site per training forward and
              per validation forward (in the bf16 run the training forwards' are
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
              time (the union of the device intervals), with no cuDNN conv
              kernel, forward or backward, at the block2 post-concat conv's
              input; at each fused site at batch 12, the kernel's bf16
              route and the op's registered bf16 gradients against
              autograd through the f32 plain version on the same
              bf16-rounded tensors (output 2e-2 + 2e-2|ref|; gradients
              ||d||/||ref|| < 2e-2 and 2e-2 max|ref| + 2e-2|ref|), the
              bf16 dgrad and wgrad kernels against their plain versions,
              then timed beside the same backward on cuDNN in bf16; the
              same at batch 4;
 13. gt       GT generation through footprints_tpu_torch.preprocessing.
              ground_truth_generation.generator on the GPU (where OpenCV,
              Pillow and PyYAML import; otherwise the same generator classes
              over in-memory loaders that return the loaders' arrays, and
              the route says so), with TF32 turned on before it (the CLI
              must turn it off).  A synthetic KITTI sequence (100 frames,
              both sides: 375x1242 disparities, [1,192,640] float16
              ground_seg, ORB-SLAM2 [3,4] poses of a camera 1.5 m above flat
              ground moving 0.5 m a frame, eight box occluders, flow with a
              moving object): hidden_depths for 24 targets with full
              76-frame windows, depth_masks and moving_objects for 8; a
              synthetic Matterport scan (8 panoramas x 18 = 144 frames,
              1280x1024 16-bit depth PNGs; a real scan has ~2160):
              hidden_depths and depth_masks for 8.  Checks the JAX CLI's
              file names, dtypes and shapes (float64 zeros for a depth-mask
              frame with < 100 ground pixels); each type against a
              --device cpu run on the first 4 targets, at most 1e-3 of the
              pixels differing (hidden depths: by more than 1e-4|ref| or in
              being zero; depth masks: both sides fed the same RANSAC
              triplets, the CLI runs' own draws' gap printed); the KITTI
              hidden depths against the plane depth through each pixel's
              centre (median relative error < 2%, the 95th percentile and
              the occluded ground's coverage printed); the moving object
              flagged at >= 0.9 of its pixels and the static scene at
              <= 0.02;
     gt_times the KITTI aggregate per target split into projection, splat
              and median, and compute_depth_mask alone (CUDA events, each
              beside its inputs' and outputs' bytes at the HBM rate); the
              generator's frames/s with its loader and writer over the 24
              targets and the loader alone; the Matterport aggregate on the
              scan's frames repeated to a real scan's 2176 (ms, peak memory).

Exits non-zero when CUDA is absent or the package is not beside this file.
"""

import collections
import functools
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from footprints_tpu_torch import export as port_export
from footprints_tpu_torch import main as port_main
from footprints_tpu_torch import native as port_native
from footprints_tpu_torch import predict_simple, telemetry
from footprints_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from footprints_tpu_torch.convert import segmentor_jax_params_from_state_dict
from footprints_tpu_torch.core.config import readlines
from footprints_tpu_torch.core.ops import np_pixel_disp_to_depth
from footprints_tpu_torch.data import DataLoader, collate, get_inference_dataset_class
from footprints_tpu_torch.data.compact import decompact_on_device
from footprints_tpu_torch.eval import evaluate
from footprints_tpu_torch.eval.inference import InferenceManager
from footprints_tpu_torch.model_manager import ModelManager
from footprints_tpu_torch.models import SCALES, FootprintNetwork, Segmentor
from footprints_tpu_torch.models.footprint import kernel_sites
from footprints_tpu_torch.nn import resnet
from footprints_tpu_torch.preprocessing.ground_truth_generation import data_loader as gt_loader
from footprints_tpu_torch.preprocessing.ground_truth_generation import generator as gt_generator
from footprints_tpu_torch.preprocessing.ground_truth_generation import geometry as gt_geometry
from footprints_tpu_torch.preprocessing.ground_truth_generation import ransac as gt_ransac
from footprints_tpu_torch.preprocessing.ground_truth_generation.processing import (
    compute_depth_mask)
from footprints_tpu_torch.preprocessing.segmentation import datasets as seg_datasets
from footprints_tpu_torch.preprocessing.segmentation import main as seg_main
from footprints_tpu_torch.preprocessing.segmentation import trainer as seg_trainer
from footprints_tpu_torch.preprocessing.segmentation.inference import (Tester,
                                                                     load_segmentor_weights)
from footprints_tpu_torch.preprocessing.segmentation.losses import compute_seg_losses
from footprints_tpu_torch.preprocessing.segmentation.options import Options as SegOptions
from footprints_tpu_torch.ops import build
from footprints_tpu_torch.ops import fused_conv as fc
from footprints_tpu_torch.ops.fused_conv import (fused_conv3x3,
                                                 fused_conv3x3_plain)
from footprints_tpu_torch.options import Options
from footprints_tpu_torch.parallel import (all_reduce_mean, replica_digest, replicate_tree,
                                           shard_batch, sync_batch_norm)
from footprints_tpu_torch.parallel.dryrun import dryrun_multichip, spawn
from footprints_tpu_torch.parallel.halo import exchange_rows, shard_rows
from footprints_tpu_torch.train.losses import TARGET_KEYS, compute_losses
from footprints_tpu_torch.train.step import (TrainStepConfig, build_eval_step,
                                             build_train_step, forward_in, make_optimizer)
from footprints_tpu_torch.train.trainer import SEED as TRAIN_SEED
from footprints_tpu_torch.train.trainer import TrainManager
from portbench.devtrace import kernel_category, union_ns
from portbench.flops import (PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS, PEAK_TF32_FLOPS,
                             TF32_PRODUCTS_PER_MAC, backward_bound_s, forward_bound_s,
                             site_flops)

REPO = os.path.dirname(os.path.abspath(__file__))
HEIGHT, WIDTH = 192, 640
SEED = 10
KERNEL = {
    "name": "fused_conv3x3",
    "route": "cuda",
    "source": "footprints_tpu_torch/csrc/fused_conv3x3.cu",
    "replaces": "footprints_tpu/ops/pallas_conv.py:110",
}
# the backward's two kernels; their TPU counterpart is the XLA VJP of
# the Pallas kernel's custom_vjp wrappers (_up_bwd :221, _s2d_bwd :243,
# _s2d_res_bwd :265)
BWD_KERNELS = [{"name": name, "route": "cuda",
                "source": f"footprints_tpu_torch/csrc/{name}.cu",
                "replaces": "footprints_tpu/ops/pallas_conv.py:221"}
               for name in ("fused_conv3x3_dgrad", "fused_conv3x3_wgrad")]
# their launches on the main paths (the training phases), summed as the
# phases check them
BWD_LAUNCHES = {k["name"]: 0 for k in BWD_KERNELS}
# the device kernels of one call of each: dgrad's weight pre-pack and main
# kernel, wgrad's partial sums and their fixed-order sum
BWD_DEVICE_KERNELS = ("fused_conv3x3_dgrad_pack_kernel", "fused_conv3x3_dgrad_kernel",
                      "fused_conv3x3_wgrad_partial_kernel", "fused_conv3x3_wgrad_reduce_kernel")
# the device kernels of one forward call: the weight pre-pack and the main kernel
FWD_DEVICE_KERNELS = ("fused_conv3x3_pack_kernel", "fused_conv3x3_kernel")
# the probe's sites (phase probe): an up site and a reflect site of 64 channels
PROBE_SITES = ("tail.conv1", "block4.post.conv2")
ROUTES = {torch.float32: "wgmma_tf32x3", torch.bfloat16: "wgmma_bf16"}
TRAIN_BATCH, TRAIN_STEPS, VAL_BATCHES = 12, 4, 1
# the FootprintNetwork trainer's rate with its loader: 16 batches of 12 after
# one untimed batch, as the seg trainer's
TRAIN_TIMED_BATCHES = 16
CHECK_BATCH = 2  # the GPU-vs-CPU train step
KITTI_RAW_HW = (375, 1242)
DUMP_BATCH, DUMP_FRAMES = 12, 26  # options.py's default batch; a padded tail of 2
TIMED_BATCHES = (12, 16)  # the default batch, and one past it
# the timed dumps cycle through the 26 frames for 16 batches of 12 (12 of 16):
# the loader builds each batch on one thread, so a dump of a few batches
# times mostly the first batch's loading
TIMED_FRAMES = 192
MATTERPORT_HW, MATTERPORT_RAW_HW = (512, 640), (1024, 1280)
MATTERPORT_FRAMES, MATTERPORT_BATCH = 6, 4
F16_BAR = 2e-3  # a float16 dump against its CPU twin: 2e-3 + 2e-3|cpu|
# the decoders' block2 post-concat conv1 input, reflect-padded, per image: a
# cuDNN conv there would mean the fused kernel no longer runs that block
BLOCK2_POST_INPUT = [256, HEIGHT // 8 + 2, WIDTH // 8 + 2]
# segmentation training: segmentation/options.py's default batch and datasets
SEG_TRAIN_BATCH, SEG_TRAIN_STEPS, SEG_VAL_BATCHES = 12, 4, 1
ADE20K_HW, CITYSCAPES_HW = (512, 683), (1024, 2048)
SEG_FILES = 6  # distinct frames per dataset; the split files cycle through them
SEG_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the trainer's rate with its loader: 16 batches of 12 (192 frames, as the
# timed dumps) after one untimed batch
SEG_TIMED_BATCHES = 16
CHECK_SEED = 20_000  # the seg check steps' noise batch (InMemorySegSamples)
# export and bf16 serving: the serving batch, the CPU-leg check batch, the
# Segmentor's dump batch; the native resize's frames
EXPORT_BATCH, EXPORT_CHECK_BATCH, SEG_EXPORT_BATCH = 16, 2, DUMP_BATCH
NATIVE_FRAMES = 8


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


class Failures(list):
    def check(self, ok, what):
        if not ok:
            self.append(what)
            print(f"FAIL: {what}", flush=True)
        return ok


@functools.cache
def model_sites(model, batch, hw=(HEIGHT, WIDTH)):
    """The kernel's call sites in one forward of the FootprintNetwork-34
    ("footprint") or the Segmentor-34 with the PSP ("segmentor"), the
    models the phases run, at `batch` x `hw` (kernel_sites), named without
    their decoder's prefix, each once with the calls it stands for (the
    FootprintNetwork's two decoders make the same ones): {(name, pad_mode,
    input NHWC shape, Co, residual?, bias?, act): calls}."""
    net = (FootprintNetwork(34, device="meta") if model == "footprint"
           else Segmentor(34, True, device="meta"))
    return types.MappingProxyType(collections.Counter(
        (name.split(".", 1)[1], *rest) for name, *rest in kernel_sites(net, batch, *hw)))


def launches_per_forward(model):
    """The kernel's launches in one forward of `model`: one a call site."""
    return sum(model_sites(model, 1).values())


def site_inputs(site, dtype, seed):
    """Seeded (x, w, b, residual) on the card.  The two conv1 halves of
    block2 and block4 get w as an input-channel slice view of one contiguous
    [Co, 2Ci, 3, 3] weight (up half first), as nn/blocks.py passes them."""
    name, pad_mode, shape, co, with_res, with_bias, _ = site
    g = torch.Generator().manual_seed(seed)
    n, h, w_, ci = shape
    ho, wo = (h, w_) if pad_mode == "reflect" else (2 * h, 2 * w_)
    halves = ".post.conv1." in name
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


def bounds(site, x, w, b, r):
    """Least times (ms) of the work the site's function needs in x's dtype,
    each input read once and the output written once, apart: {"ops_ffma_ms",
    "ops_tc_ms", "bytes_ms"}, which the benchmark's forward_bound_s
    (portbench/flops.py) folds into one.  f32 counts 3 TF32 products per MAC
    on the tensor cores (the f32-accurate route); bf16 one bf16 product."""
    _, pad_mode, (n, h, w_, _), co, _, _, _ = site
    ho, wo = (h, w_) if pad_mode == "reflect" else (2 * h, 2 * w_)
    flops = site_flops(site[:6])
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


def bwd_wrappers():
    return {"fused_conv3x3_dgrad": fc.fused_conv3x3_dgrad,
            "fused_conv3x3_wgrad": fc.fused_conv3x3_wgrad}


def reset_bwd_counts():
    """Set the backward kernels' counts to 0, just before a main path."""
    for f in bwd_wrappers().values():
        f.launches = f.bf16_launches = 0


def bwd_counts():
    """{kernel: [launches, bf16 launches]} of the backward kernels."""
    return {k: [f.launches, f.bf16_launches] for k, f in bwd_wrappers().items()}


def check_bwd_counts(fail, tag, per_rank, steps, per_step, bf16):
    """A main path's backward-kernel launches since reset_bwd_counts, one
    bwd_counts() per rank: each rank `per_step` of each kernel per train
    step, all on the bf16 route when `bf16`.  Adds them to BWD_LAUNCHES."""
    want = [steps * per_step, steps * per_step if bf16 else 0]
    fail.check(len(per_rank) > 0 and all(v == want for r in per_rank for v in r.values()),
               f"{tag}: backward kernel launches [all, bf16] per rank {per_rank}, expected "
               f"{want} of each kernel")
    for r in per_rank:
        for k, v in r.items():
            BWD_LAUNCHES[k] += v[0]
    return per_rank


def cudnn_backward(pad_mode, x, w, gz, need_x, need_w):
    """The op's backward on cuDNN, as it ran before the dgrad and wgrad
    kernels, kept here only as the yardstick (library_ms; no code of the port calls it): x upsampled
    (nearest x2, at 'up2_reflect') and reflect-padded, cuDNN's dgrad and
    wgrad (aten.convolution_backward), then the pad's and the upsample's
    adjoints.  Returns (gx NHWC or None, gw or None)."""
    xu = x.permute(0, 3, 1, 2)
    if pad_mode == "up2_reflect":
        xu = F.interpolate(xu, scale_factor=2, mode="nearest")
    gxp, gw, _ = torch.ops.aten.convolution_backward(
        gz.permute(0, 3, 1, 2), F.pad(xu, (1, 1, 1, 1), mode="reflect"), w, None, (1, 1),
        (0, 0), (1, 1), False, (0, 0), 1, (need_x, need_w, False))
    gx = None
    if need_x:
        gx = torch.ops.aten.reflection_pad2d_backward(gxp, xu, (1, 1, 1, 1)).permute(0, 2, 3, 1)
        if pad_mode == "up2_reflect":
            n, h, w_, c = x.shape
            gx = gx.reshape(n, h, 2, w_, 2, c).sum((2, 4))
    return gx, gw


def backward_kernels(fail, tag, site, x, w, gz):
    """The dgrad and wgrad kernels at one site on the card (x and w as the
    op gets them, gz the pre-activation cotangent): each against its plain
    version in f64 on the same tensors, then the ms per call (mean of 20
    eager calls, CUDA events) of the kernel, of its plain version in x's
    dtype (f32 sums) and of cudnn_backward for the same gradient (library),
    beside its bound.  f32 bars: site_backward's (gx 1e-4 + 1e-4|ref|; gw
    1e-3 max|ref| + 1e-3|ref| and ||d||/||ref|| < 1e-4); bf16: 2e-2 max|ref|
    + 2e-2|ref| and ||d||/||ref|| < 2e-2 (the result rounded to 8 bits)."""
    pad_mode, f32 = site[1], x.dtype == torch.float32
    calls = {
        "fused_conv3x3_dgrad": (
            lambda: fc.fused_conv3x3_dgrad(gz, w, pad_mode=pad_mode),
            lambda: fc.fused_conv3x3_dgrad_plain(gz, w, pad_mode=pad_mode),
            lambda: cudnn_backward(pad_mode, x, w, gz, True, False),
            lambda: fc.fused_conv3x3_dgrad_plain(gz.double(), w.double(), pad_mode=pad_mode)),
        "fused_conv3x3_wgrad": (
            lambda: fc.fused_conv3x3_wgrad(gz, x, pad_mode=pad_mode),
            lambda: fc.fused_conv3x3_wgrad_plain(gz, x, pad_mode=pad_mode),
            lambda: cudnn_backward(pad_mode, x, w, gz, False, True),
            lambda: fc.fused_conv3x3_wgrad_plain(gz.double(), x.double(), pad_mode=pad_mode))}
    # the least time of one kernel's work (portbench/flops.py), and whether
    # the operations (the forward's MACs) or the bytes set it
    bound_ms = backward_bound_s(site[:6], str(x.dtype).removeprefix("torch.")) * 1e3
    ops = bounds(site, x, w, None, None)
    ops_ms = min(ops["ops_ffma_ms"], ops["ops_tc_ms"]) if f32 else ops["ops_tc_ms"]
    bound_by = "operations" if ops_ms >= bound_ms else "bytes"
    out = {}
    for name, (kernel, plain, library, reference) in calls.items():
        got, ref = kernel(), reference()
        torch.cuda.synchronize()
        d = (got.double() - ref).abs()
        rel = float((got.double() - ref).norm() / ref.norm())
        if not f32:
            ok = bool((d <= 2e-2 * ref.abs().max() + 2e-2 * ref.abs()).all()) and rel < 2e-2
        elif name.endswith("dgrad"):
            ok = bool((d <= 1e-4 + 1e-4 * ref.abs()).all())
        else:
            ok = bool((d <= 1e-3 * ref.abs().max() + 1e-3 * ref.abs()).all()) and rel < 1e-4
        max_abs = d.max().item()
        fail.check(ok and bool(torch.isfinite(got).all()) and got.dtype == x.dtype,
                   f"{tag}: {site[0]}: {name} vs its plain version in f64: max abs "
                   f"{max_abs}, rel {rel}")
        del got, ref, d
        out[name] = {"max_abs_err": max_abs, "rel_vs_f64": rel, "ok": ok,
                     "ms": time_ms(kernel), "plain_ms": time_ms(plain),
                     "library_ms": time_ms(library), "bound_ms": bound_ms,
                     "bound_by": bound_by}
    return out


def phase_probe(fail, probe_build):
    """The clock64() probe (ops/probe.py) of the forward, dgrad and wgrad
    kernels at batch 12 on PROBE_SITES, f32 and bf16: per kernel, the
    shares of a block's cycles spent waiting, staging, in the MMAs and in
    the epilogue, and the blocks resident on an SM.  The probe's library was
    built beside the main one (`probe_build`, a future); its launches do not
    count."""
    from footprints_tpu_torch.ops.probe import probe_backward, probe_forward

    probe_build.result()
    out = []
    for si, site in enumerate(model_sites("footprint", TRAIN_BATCH)):
        if site[0] not in PROBE_SITES:
            continue
        for dtype in (torch.float32, torch.bfloat16):
            x, w, _, _ = site_inputs(site, dtype, seed=800 + si)
            n, h, w_, _ = x.shape
            f = 1 if site[1] == "reflect" else 2
            gz = torch.randn(n, f * h, f * w_, site[3], device="cuda",
                             generator=torch.Generator("cuda").manual_seed(900 + si)).to(dtype)
            _, _, b, r = site_inputs(site, dtype, seed=800 + si)
            before = fused_conv3x3.launches
            row = {"site": site[0], "dtype": str(dtype).replace("torch.", ""),
                   "kernel": KERNEL["name"], "batch": TRAIN_BATCH,
                   **probe_forward(x, w, b, r, site[1], site[6])}
            emit("probe", **row)
            out.append(row)
            fail.check(fused_conv3x3.launches == before, "probe: the forward probe's launch "
                       "moved the counter")
            before = bwd_counts()
            for kind, t in (("dgrad", w), ("wgrad", x)):
                row = {"site": site[0], "dtype": str(dtype).replace("torch.", ""),
                       "kernel": f"fused_conv3x3_{kind}", "batch": TRAIN_BATCH,
                       **probe_backward(kind, gz, t, site[1])}
                emit("probe", **row)
                out.append(row)
            fail.check(bwd_counts() == before, f"probe: the probe's launches moved the "
                       f"counters {before} -> {bwd_counts()}")
    return out


def phase_sites(fail):
    """Kernel vs plain at every site of the 192x640 forward, f32 and bf16,
    and at the Matterport dump's 512x640 sites (batch 4, f32: the dump's
    dtype).  Returns the f32 max abs error."""
    worst = 0.0
    f32, bf16 = (torch.float32, 1e-4), (torch.bfloat16, 2e-2)
    cases = [(site, (f32, bf16)) for site in model_sites("footprint", 4)]
    cases += [(site, (f32,)) for site in model_sites("footprint", MATTERPORT_BATCH,
                                                      MATTERPORT_HW)]
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

    def captures():
        """predict_simple's graph captures so far."""
        total = telemetry.totals().get("predict.graph.capture")
        return total.count if total else 0

    def serve(tag, device):
        """One CLI run on `device`: (its output dir, its kernel launches,
        its graph captures)."""
        out = os.path.join(workdir, f"{tag}_{device}")
        before, captured = fused_conv3x3.launches, captures()
        if have_pil:
            predict_simple.main(["--image", targets[tag], "--model_path", weights,
                                 "--no_save_vis", "--save_dir", out,
                                 "--device", device])
        else:
            predict_simple.InferenceManager(
                None, out, save_visualisations=False, model_load_folder=weights,
                device=device).predict_arrays([tag], [targets[tag]])
        return (os.path.join(out, "outputs"), fused_conv3x3.launches - before,
                captures() - captured)

    # each GPU run has a CPU twin (the plain versions) on the same input and
    # weights; the CPU runs launch no kernel
    fused_conv3x3.launches = 0
    runs = [(tag, serve(tag, "cuda"), serve(tag, "cpu")) for tag in targets]
    torch.cuda.synchronize()
    launches = fused_conv3x3.launches

    n_files, worst_mae, per_batch = 0, 0.0, launches_per_forward("footprint")
    for tag, (out, n_launch, n_graph), (cpu_out, n_cpu, n_cpu_graph) in runs:
        # one batch of 4 a run: its graph's warm-up and capture call the
        # kernel once a site each
        fail.check(n_launch == 2 * per_batch and n_cpu == 0,
                   f"{tag}: {n_launch} kernel calls for one batch on the GPU "
                   f"(expected {2 * per_batch}), {n_cpu} on the CPU")
        fail.check(n_graph == 1 and n_cpu_graph == 0,
                   f"{tag}: {n_graph} graph captures on the GPU (expected 1), "
                   f"{n_cpu_graph} on the CPU")
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
    Returns the kernel's totals over one forward's launches."""
    totals = {k: 0.0 for k in ("ms", "ms_bf16", "graph_ms", "graph_ms_bf16", "plain_ms",
                               "library_ms", "library_ms_bf16", "bound_ms", "ops_ms",
                               "bytes_ms", "bound_ffma_ms", "bound_tc_ms",
                               "bound_tc_bf16_ms")}
    for si, (site, calls) in enumerate(model_sites("footprint", 4).items()):
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
        f32 = bounds(site, x, w, b, r)
        bound_ffma = max(f32["ops_ffma_ms"], f32["bytes_ms"])
        bound_tc = max(f32["ops_tc_ms"], f32["bytes_ms"])
        bound_tc_bf16 = forward_bound_s(site[:6], "bfloat16") * 1e3
        # the least time this card could take for the f32-accurate work
        t_ops = min(f32["ops_ffma_ms"], f32["ops_tc_ms"])
        t_bound = forward_bound_s(site[:6], "float32") * 1e3
        bound_by = "operations" if t_ops >= f32["bytes_ms"] else "bytes"
        for key, v in (("ms", t_kernel), ("ms_bf16", t_kernel_bf16),
                       ("graph_ms", t_graph), ("graph_ms_bf16", t_graph_bf16),
                       ("plain_ms", t_plain), ("library_ms", t_lib),
                       ("library_ms_bf16", t_lib_bf16), ("bound_ms", t_bound),
                       ("ops_ms", t_ops), ("bytes_ms", f32["bytes_ms"]),
                       ("bound_ffma_ms", bound_ffma), ("bound_tc_ms", bound_tc),
                       ("bound_tc_bf16_ms", bound_tc_bf16)):
            totals[key] += calls * v
        emit("times", kernel=KERNEL["name"], site=name, shape=list(x.shape),
             co=w.shape[0], launches_per_forward=calls, route=ROUTES[torch.float32],
             ms=t_kernel, graph_ms=t_graph, plain_ms=t_plain, library_ms=t_lib,
             bound_ffma_ms=bound_ffma, bound_tc_ms=bound_tc, bound_ms=t_bound,
             bound_by=bound_by, share_of_bound=t_bound / t_kernel,
             share_of_bound_graph=bound_tc / t_graph,
             tflops_done=site_flops(site[:6]) / (t_kernel * 1e-3) / 1e12,
             route_bf16=ROUTES[torch.bfloat16], ms_bf16=t_kernel_bf16,
             graph_ms_bf16=t_graph_bf16,
             library_ms_bf16=t_lib_bf16, bound_tc_bf16_ms=bound_tc_bf16,
             share_of_bound_bf16=bound_tc_bf16 / t_kernel_bf16,
             share_of_bound_graph_bf16=bound_tc_bf16 / t_graph_bf16)

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
         share_of_bound_graph=totals["bound_tc_ms"] / totals["graph_ms"],
         share_of_bound_graph_bf16=totals["bound_tc_bf16_ms"] / totals["graph_ms_bf16"],
         **totals)
    emit("times", forward="FootprintNetwork-34 serving forward ('1/1' head), f32",
         **stats)
    emit("times", kernel=KERNEL["name"], host_us_per_call=wrapper_host_costs(),
         device_launches_per_call=len(FWD_DEVICE_KERNELS), input=[1, 8, 8, 16], calls=2000)
    return totals


def host_us_per_call(fn, calls=2000):
    """Host microseconds per call of fn after 50 warm-up calls, with no
    synchronise inside the loop: on a tiny input the card keeps up, so this
    reads the launch path's host cost."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def wrapper_host_costs():
    """Host cost per call on a 1x8x8x16 input of conv_reflect_fused (the
    model's path) under inference mode, no_grad and recording a graph, of
    the op called through the dispatcher (a loaded program's path), and of
    the CUDA implementation alone (the bare ctypes launch)."""
    g = torch.Generator("cuda").manual_seed(SEED)
    x = torch.randn(1, 8, 8, 16, device="cuda", generator=g)
    w = torch.randn(16, 16, 3, 3, device="cuda", generator=g)
    b = torch.randn(16, device="cuda", generator=g)
    xg = x.clone().requires_grad_()
    costs = {}
    with torch.inference_mode():
        costs["wrapper_inference_mode"] = host_us_per_call(
            lambda: fc.conv_reflect_fused(x, w, b))
    with torch.no_grad():
        costs["wrapper_no_grad"] = host_us_per_call(lambda: fc.conv_reflect_fused(x, w, b))
        costs["op_dispatched_no_grad"] = host_us_per_call(
            lambda: fc.fused_conv3x3_op(x, w, b, None, "reflect", "elu"))
        costs["bare_launch"] = host_us_per_call(
            lambda: fc._launch(x, w, b, None, "reflect", "elu"))
    costs["wrapper_recording_a_graph"] = host_us_per_call(
        lambda: fc.conv_reflect_fused(xg, w, b))
    costs["op_dispatched_recording_a_graph"] = host_us_per_call(
        lambda: fc.fused_conv3x3_op(xg, w, b, None, "reflect", "elu"))
    return costs


def profile_forward(forward, json_name):
    """Device time by kernel over 5 calls of forward() at batch 16, and the
    share of the wall time in which no kernel ran; the full table in
    smoke_out/<json_name>.  Returns the summary."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        for _ in range(2):
            forward()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                forward()
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
    with open(os.path.join(REPO, "smoke_out", json_name), "w") as f:
        json.dump({**summary, "kernels": rows}, f, indent=1)
    return summary, rows


def phase_profile(fail, net):
    """Device time by kernel over 5 serving forwards at batch 16, and the
    share of the wall time in which no kernel ran."""
    x = torch.rand(16, HEIGHT, WIDTH, 3, device="cuda")
    summary, rows = profile_forward(lambda: net(x, scales=("1/1",)), "profile_b16.json")
    names = [r["name"] for r in rows]
    per_forward = {k: sum(r["count"] for r in rows if k in r["name"]) for k in FWD_DEVICE_KERNELS}
    want = launches_per_forward("footprint")
    fail.check(all(n == want for n in per_forward.values()),
               f"profile: the forward's device kernels per forward {per_forward}, expected "
               f"{want} of each ({len(names)} kernels profiled)")
    emit("profile", **summary, forward_device_kernels_per_forward=per_forward, top=rows[:10])


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

    def create_dataloaders(self, shard=(0, 1)):
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
    reset_bwd_counts()
    torch.cuda.reset_peak_memory_stats()
    if have_data_libs:
        tm = port_main.main(argv)
    else:
        tm = InMemoryTrainManager(Options().parse(argv))
        tm.train()
    torch.cuda.synchronize()
    launches = fused_conv3x3.launches
    per_forward = launches_per_forward("footprint")
    bwd = check_bwd_counts(fail, "train", [bwd_counts()], TRAIN_STEPS, per_forward,
                           bf16=False)[0]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    n_val_events = sum(1 for mode, _, _ in tm.logged if mode == "val")
    expected = per_forward * (TRAIN_STEPS + VAL_BATCHES * n_val_events)
    fail.check(n_val_events == 1 and launches == expected,
               f"train: {launches} kernel launches, expected {expected} "
               f"({per_forward} per training forward and per validation forward; "
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
         launches_expected=expected, backward_kernel_launches=bwd,
         logged=[[m, s, l["loss"]] for m, s, l in tm.logged],
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
    for kernel in ("fused_conv3x3_dgrad", "fused_conv3x3_wgrad", "fused_conv3x3"):
        if kernel in n:
            return kernel
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


CUDNN_CONV_CATEGORIES = ("cudnn dgrad", "cudnn wgrad", "cudnn fft conv (fwd or bwd)",
                         "cudnn forward conv")


def site_backward(fail, batch):
    """At each fused site at `batch`, on the card: the kernel's output and
    the op's registered gradients for x, the full weight, b and the
    residual, held against autograd through fused_conv3x3_plain in f64 on
    the same tensors, beside the f32 plain version's own distance to that
    reference (TF32 off); the dgrad and wgrad kernels against their plain
    versions (backward_kernels); then the kernel's forward (no graph), the
    Function's backward (the elementwise ELU derivative, the dgrad and
    wgrad kernels, the bias's sum) and the same backward on cuDNN
    on cuDNN (library_backward_ms) timed, ms per call, and two profiled
    backwards, which must run the BWD_DEVICE_KERNELS and no cuDNN conv
    kernel.  Bars:
    the output, x and the residual within 1e-4 + 1e-4|ref| (those of
    tests/test_torch_cuda.py).  Each entry of the weight and bias gradients
    sums N H W products (122880 to 1474560 here; about 1000 in the card
    tests, whose weight bars are 10x tighter).  On an H100, cuDNN's f32
    wgrad of the plain version itself sits about 3e-5 (norm) from f64 at
    block4 (printed as plain_f32_rel), so the bars are 1e-3 max|ref| +
    1e-3|ref| elementwise and ||d||/||ref|| < 1e-4: about 3x above that
    floor, and far below a wrong adjoint or slice."""
    from torch.autograd import DeviceType

    rows = []
    for si, site in enumerate(model_sites("footprint", batch)):
        name, pad_mode, _, _, _, _, act = site
        x, w, b, r = site_inputs(site, torch.float32, seed=300 + si)
        halves = w._base is not None  # conv1's halves: slices of one weight
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

        gz = (gy if act != "elu" else gy * (y.detach().clamp(max=0) + 1)).contiguous()

        def library_backward():  # the Function's backward on cuDNN
            g = gy if act != "elu" else gy * (y.detach().clamp(max=0) + 1)
            cudnn_backward(pad_mode, fixed[0], fixed[1], g, True, True)
            return g.sum((0, 1, 2))

        kernels = backward_kernels(fail, f"train_times b{batch}", site, fixed[0], fixed[1], gz)
        # two calls in the window: the profiler drops the first kernels it
        # sees (at every site the backward's first kernel was missing)
        _, raw = profiled(lambda: (backward(), backward()))
        names = {e.name() for e in raw if e.device_type() == DeviceType.CUDA}
        cats = {train_kernel_category(n) for n in names}
        fail.check({"fused_conv3x3_dgrad", "fused_conv3x3_wgrad"} <= cats
                   and all(any(k in n for n in names) for k in BWD_DEVICE_KERNELS)
                   and not cats & set(CUDNN_CONV_CATEGORIES),
                   f"train_times: {name} at batch {batch}: the profiled backward ran "
                   f"{sorted(names)}")
        rows.append({"site": name, "err_vs_f64": errs, "forward_ms": time_ms(forward),
                     "backward_ms": time_ms(backward),
                     "library_backward_ms": time_ms(library_backward),
                     # ELU's derivative as the Function takes it (one pass)
                     # and written out (three, as the cuDNN backward took it)
                     "elementwise_gz_ms": time_ms(lambda: torch.ops.aten.elu_backward(
                         gy, 1.0, 1.0, 1.0, True, y.detach())) if act == "elu" else 0.0,
                     "elementwise_gz_three_pass_ms": time_ms(
                         lambda: gy * (y.detach().clamp(max=0) + 1)) if act == "elu" else 0.0,
                     "kernels": kernels,
                     "profiled_backward_kernels": sorted(n[:80] for n in names)})
        del gz, kernels
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
    """cuDNN's f32 time (TF32 off) per call, mean of 5 after 2, of every conv
    of both decoders that cuDNN runs, in the memory format and with the
    bias the model passes, at each batch, with the default heuristics and
    with torch.backends.cudnn.benchmark on (restored after).  A shape is on
    a cliff at a batch where its time per image exceeds 4x its least time
    per image over the batches (and 1 ms per call)."""
    out, rows = {}, []
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


def backward_totals(site_rows, model):
    """A step's totals over `model`'s sites (each row run as many times as
    the model calls the kernel there: model_sites): the forward kernel's
    and the Function's backward ms, the backward on cuDNN
    (cudnn_backward), and per backward kernel its ms, plain_ms,
    library_ms and bound_ms summed, the worst max_abs_err and bound_by."""
    calls = {site[0]: n for site, n in model_sites(model, 1).items()}
    reps = [calls[r["site"]] for r in site_rows]
    out = {f"{key}_per_step": sum(c * r[key] for c, r in zip(reps, site_rows))
           for key in ("forward_ms", "backward_ms", "library_backward_ms")}
    for k in BWD_KERNELS:
        rows = [r["kernels"][k["name"]] for r in site_rows]
        t = {key: sum(c * r[key] for c, r in zip(reps, rows))
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        ops = sum(c * r["bound_ms"] for c, r in zip(reps, rows) if r["bound_by"] == "operations")
        out[k["name"]] = {**t, "max_abs_err": max(r["max_abs_err"] for r in rows),
                          "bound_by": "operations" if 2 * ops >= t["bound_ms"] else "bytes",
                          "share_of_bound": t["bound_ms"] / t["ms"]}
    return out


def phase_train_times(fail, host, epoch):
    """The train step's time, memory and breakdown at batch 12, then the
    fused sites' forward and backward at batch 4 and 12 (site_backward).
    Returns the backward's per-step totals by batch (backward_totals)."""
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

    emit("train_times", train_step_ms_b12=ms,
         train_imgs_per_s_b12=TRAIN_BATCH / (ms * 1e-3),
         peak_memory_gib_b12=peak_gib, **split, **epoch)
    totals = {}
    for batch in (4, TRAIN_BATCH):
        site_rows = site_backward(fail, batch)
        per_step = backward_totals(site_rows, "footprint")
        emit("train_times", kernel=KERNEL["name"], batch=batch,
             launches_per_step_forward=launches_per_forward("footprint"),
             launches_per_step_backward=0,
             backward_kernel_launches_per_step={k["name"]: launches_per_forward("footprint")
                                                for k in BWD_KERNELS},
             sites=site_rows, reference="autograd of the plain version, f64, same tensors",
             bars={"y, x, residual": "1e-4 + 1e-4|ref|",
                   "w, b": "1e-3 max|ref| + 1e-3|ref|, ||d||/||ref|| < 1e-4"},
             **per_step)
        totals[batch] = per_step
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
    return totals


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
    reset_bwd_counts()
    torch.cuda.reset_peak_memory_stats()
    if run["real"]:
        tm = port_main.main(run["argv"] + args)
    else:
        tm = trainer_for(run, args)
        tm.train()
    torch.cuda.synchronize()
    launches, bf16 = fused_conv3x3.launches, fused_conv3x3.bf16_launches
    per_forward = launches_per_forward("footprint")
    bwd = check_bwd_counts(fail, "train_bf16", [bwd_counts()], TRAIN_STEPS, per_forward,
                           bf16=True)[0]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_val = sum(1 for mode, _, _ in tm.logged if mode == "val")
    expected = per_forward * (TRAIN_STEPS + VAL_BATCHES * n_val)
    fail.check(n_val == 1 and launches == bf16 == expected,
               f"train_bf16: {launches} kernel launches ({bf16} bf16), expected {expected}, "
               f"all bf16 (one a site per training and per validation forward; "
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
         backward_kernel_launches=bwd,
         logged=[[m, s_, losses["loss"]] for m, s_, losses in tm.logged],
         checkpoint=os.path.relpath(ckpt, workdir), resumed_step=tm2.step,
         packed_targets_on_card=packs, peak_memory_gib=peak_gib,
         epoch_seconds_with_first_batch_and_validation=tm.train_seconds)
    f32_check = train_check_steps(fail)
    return launches + phase_pretrained(fail, run, workdir), f32_check


def train_check_steps(fail):
    """At batch 2 on a seeded noise batch, from the seeded weights: the GPU
    bf16 step (both heads) against an f64 CPU step, no farther from it than
    twice a CPU bf16 step's distance (the same code on the CPU, held
    against the JAX package by tests/test_torch_bf16_train.py), for the
    whole gradient and each leaf plus 1e-3; and the GPU f32 step with both
    heads against the one without: loss terms within 1e-6 relative, the
    whole gradient ||d||/||ref|| < 1e-5, beside the same heads-off step run
    twice (cuDNN's own run-to-run spread).  Printed beside them: the worst
    leaves and the count of mask logits that are exactly 0.  Returns the f64
    CPU step and the GPU f32 step (both heads on) for phase dp."""
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
    return {k: steps[k] for k in ("cpu_f64", "gpu_f32_heads")}


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
    a launch a site for the step and for its validation.  Returns them."""
    path = os.path.join(workdir, "resnet34_torchvision.pth")
    want = write_torchvision_resnet34(path, SEED)
    tm = trainer_for(run, ["--compute_dtype", "bfloat16", "--model_name", "smoke_pretrained",
                           "--pretrained_encoder", path], batches=1)
    sd = tm.model_manager.net.state_dict()
    exact = all(torch.equal(sd[k].cpu(), v) for k, v in want.items())
    # the main path: counts set to 0 just before, read just after
    fused_conv3x3.launches = fused_conv3x3.bf16_launches = 0
    reset_bwd_counts()
    tm.train()
    torch.cuda.synchronize()
    launches = fused_conv3x3.launches
    per_forward = launches_per_forward("footprint")
    check_bwd_counts(fail, "train_bf16 pretrained", [bwd_counts()], 1, per_forward, bf16=True)
    expected = per_forward * (1 + VAL_BATCHES)
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
    rate = steady_epoch_rate(fail, trainer, "footprint", trainer.model_manager)
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


def same_stream_overlaps(spans):
    """How many of `spans` start before the previous span on their stream
    has ended."""
    n, ends = 0, {}
    for start, stop, stream in sorted(spans):
        n += start < ends.get(stream, float("-inf"))
        ends[stream] = max(ends.get(stream, float("-inf")), stop)
    return n


def span_summary(spans):
    return {"ms_union": union_ns([span[:2] for span in spans]) / 1e6,
            "ms_summed": sum(stop - start for start, stop, _ in spans) / 1e6,
            "streams": len({stream for _, _, stream in spans}),
            "same_stream_overlaps": same_stream_overlaps(spans)}


def profile_dump(run, batch):
    """One overlapped dump under torch.profiler, read from the profiler's
    raw device events: the device's busy share (the union of their
    intervals over the dump's wall time, both under the profiler) beside
    their summed durations, their streams and how many overlap on one
    stream; and the count of kernels of a cuDNN conv at block2's
    post-concat input (block2_cudnn_kernels), which the fused kernel runs."""
    wall_ms, raw = profiled(lambda: run(True))
    busy = span_summary(device_spans(raw))
    return {"wall_ms": wall_ms, "busy_share": busy["ms_union"] / wall_ms,
            "device": busy,
            "block2_cudnn_kernels": len(device_spans(raw, block2_conv_op_ids(raw, batch)))}


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


def block2_conv_op_ids(raw, batch, backward=False):
    """Correlation ids of the CPU conv ops at block2's post-concat input at
    `batch`: the forward convs (input [batch, *BLOCK2_POST_INPUT] first) or,
    with `backward`, convolution_backward (that input second)."""
    from torch.autograd import DeviceType

    want, at = [batch, *BLOCK2_POST_INPUT], 1 if backward else 0
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
    same split; then one profiled dump."""
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
        profiled = profile_dump(run, batch)
        fail.check(profiled["block2_cudnn_kernels"] == 0,
                   f"profiled dump at batch {batch}: {profiled['block2_cudnn_kernels']} kernels "
                   f"of a cuDNN conv at block2's post-concat input, which the fused kernel runs")
        rows[f"batch_{batch}"] = {
            "imgs_per_s_serial": rates["serial"],
            "imgs_per_s_overlapped": rates["overlapped"],
            "imgs_per_s_loader_alone": loader_rate,
            "images": n, "batches": n_batches,
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
    per_batch = launches_per_forward("footprint")
    fail.check(launches == per_batch * n_batches,
               f"dump: {launches} kernel launches for {n_batches} batches, expected "
               f"{per_batch} per batch")
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
        expected = per_batch * -(-MATTERPORT_FRAMES // MATTERPORT_BATCH)
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

    times = time_dumps(fail, make_manager, run_into, workdir, per_batch)
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
    per_batch = launches_per_forward("segmentor")
    fail.check(launches == per_batch * n_batches,
               f"seg_dump: {launches} kernel launches for {n_batches} batches, expected "
               f"{per_batch} per batch")
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

    times = time_dumps(fail, make_manager, run_into, workdir, per_batch)
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

    def create_dataloaders(self, shard=(0, 1)):
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
    per_forward = launches_per_forward("segmentor")
    expected = per_forward * (SEG_TRAIN_STEPS + SEG_VAL_BATCHES)
    for name, dtype in SEG_DTYPES.items():
        args = argv + ["--compute_dtype", name, "--model_name", f"seg_{name}"]
        # the main path: counts set to 0 just before, read just after
        fused_conv3x3.launches = fused_conv3x3.bf16_launches = 0
        reset_bwd_counts()
        torch.cuda.reset_peak_memory_stats()
        if real:
            trainer = seg_main.main(args)
        else:
            trainer = trainer_for(args)
            trainer.train()
        torch.cuda.synchronize()
        n, n_bf16 = fused_conv3x3.launches, fused_conv3x3.bf16_launches
        bwd = check_bwd_counts(fail, f"seg_train {name}", [bwd_counts()], SEG_TRAIN_STEPS,
                               per_forward, bf16=dtype == torch.bfloat16)[0]
        launches += n
        trainers[name] = trainer
        n_val = sum(1 for mode, _, _ in trainer.logged if mode == "val")
        want_bf16 = per_forward * SEG_TRAIN_STEPS if dtype == torch.bfloat16 else 0
        fail.check(n_val == 1 and n == expected and n_bf16 == want_bf16,
                   f"seg_train {name}: {n} kernel launches ({n_bf16} bf16), expected "
                   f"{expected} ({want_bf16} bf16): {per_forward} per training forward "
                   f"and per validation forward; {n_val} validation events")
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
                      "backward_kernel_launches": bwd,
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
    and the op's registered bf16 gradients (x, the full weight, b, the
    residual) against autograd through the f32 plain version on the same
    bf16-rounded tensors and cotangent.  Bars: the output within 2e-2 +
    2e-2|ref| (phase sites' bf16 bar); every gradient ||d||/||ref|| < 2e-2
    and elementwise within 2e-2 max|ref| + 2e-2|ref| (the bf16 dgrad and
    wgrad kernels of bf16 cotangents, each result rounded to 8 bits); the
    two kernels against their plain versions (backward_kernels).  Then the
    bf16 forward and backward timed, ms per call, beside the same backward
    on cuDNN in bf16 (library_backward_ms)."""
    rows = []
    for si, site in enumerate(model_sites("segmentor", batch)):
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

        def library_backward():
            g = gy if act != "elu" else gy * (y.detach().clamp(max=0) + 1)
            cudnn_backward(pad_mode, fixed[0], fixed[1], g, True, True)
            return g.sum((0, 1, 2))

        gz = (gy if act != "elu" else gy * (y.detach().clamp(max=0) + 1)).contiguous()
        kernels = backward_kernels(fail, f"seg_train_times b{batch}", site, fixed[0],
                                   fixed[1], gz)
        rows.append({"site": name, "err_vs_f32_plain": errs, "forward_ms": time_ms(forward),
                     "backward_ms": time_ms(backward),
                     "library_backward_ms": time_ms(library_backward), "kernels": kernels})
        del gz, kernels
    return rows


def steady_epoch_rate(fail, trainer, model, saver=None):
    """imgs/s of trainer.train() of `model` from the end of its first step (its
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
               and fused_conv3x3.launches == launches_per_forward(model) * n,
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
    split, and one profiled step's busy time (a union of device intervals),
    beside the kernels of a cuDNN conv at the block2 post-concat conv's
    input, forward and backward (none: the fused kernel runs it); then the
    bf16 route at each fused site at batch 4 and 12.  Returns the sites' rows
    at batch 12 (site_backward_bf16)."""
    trainer_rates = {}
    for name in SEG_DTYPES:
        trainer = timed_trainer(name)
        trainer_rates[name] = steady_epoch_rate(fail, trainer, "segmentor")
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
            block2 = sum(len(device_spans(raw, block2_conv_op_ids(raw, batch, bwd)))
                         for bwd in (False, True))
            fail.check(busy["ms_union"] > 0 and block2 == 0,
                       f"seg_train_times {name} b{batch}: the profile saw no device time, "
                       f"or a cuDNN conv at block2's post-concat input, which the fused "
                       f"kernel runs")
            rows[f"{name}_b{batch}"] = {
                "step_ms": ms, "imgs_per_s": batch / (ms * 1e-3), "peak_memory_gib": peak,
                **split, "profiled_wall_ms": wall_ms, "busy_ms_union": busy["ms_union"],
                "busy_share_of_profiled_wall": busy["ms_union"] / wall_ms}
            del net, optimizer, step, b
            torch.cuda.empty_cache()
    emit("seg_train_times", model="Segmentor-34 with PSP, 192x640", steps=rows,
         trainer_imgs_per_s_with_loader=trainer_rates, loader_alone_imgs_per_s=loader_alone,
         timed_batches=SEG_TIMED_BATCHES, timed_frames=SEG_TIMED_BATCHES * SEG_TRAIN_BATCH)
    for batch in (4, SEG_TRAIN_BATCH):
        site_rows = site_backward_bf16(fail, batch)
        emit("seg_train_times", kernel=KERNEL["name"], route=ROUTES[torch.bfloat16],
             batch=batch, sites=site_rows,
             reference="autograd of the f32 plain version, same bf16-rounded tensors",
             bars={"y": "2e-2 + 2e-2|ref|",
                   "x, w, b, residual": "2e-2 max|ref| + 2e-2|ref|, ||d||/||ref|| < 2e-2"},
             **backward_totals(site_rows, "segmentor"))
    return site_rows


# --- GT generation --------------------------------------------------------------

GT_HW, MP_GT_HW, MP_DEPTH_HW = (192, 640), (480, 640), (1024, 1280)
GT_FRAMES = 100  # per stereo side
GT_CAM_HEIGHT, GT_STEP, GT_BASELINE = 1.5, 0.5, 0.54  # m: ground below, forward per frame
GT_MAX_DEPTH = 60.0  # ground farther away reads as a disparity hole
# boxes standing on the ground beside the path (world metres): x0, x1, z0, z1, height
GT_BOXES = ([(-3.6, -1.6, z, z + 1.5, 1.0) for z in (8.0, 20.0, 32.0, 44.0)]
            + [(1.8, 3.8, z, z + 1.5, 1.2) for z in (14.0, 26.0, 38.0, 50.0)])
# hidden depths: 24 targets whose 76-frame windows (25 back, 50 forward, step
# 2, both sides) lie inside the 100 frames; depth and moving-object masks: 8
GT_HIDDEN = [f"seq0 {f} {'lr'[f % 2]}" for f in range(26, 50)]
GT_MASKS = [f"seq0 {f} {'lr'[i % 2]}" for i, f in enumerate(range(30, 46, 2))]
GT_CPU_TARGETS = 4  # the --device cpu twin covers the first 4 of each split
GT_BLOB, GT_BLOB_FLOW = (130, 150, 260, 360), 6.0  # a moving object: rows, cols; px
GT_PLANE_BAR = 0.02  # median relative error of the hidden depths against the plane
GT_PIXEL_BAR = 1e-3  # share of pixels where the GPU and CPU outputs may differ
# Matterport: a room with two pieces of furniture, 8 panoramas x (3 heights x 6
# directions); a real scan has ~2160 frames, cut here for file-writing time
MP_ROOM = ((-6.0, 6.0), (-5.0, 5.0), (0.0, 2.8))
MP_BOXES = [((1.0, -1.5, 0.0), (2.2, -0.3, 0.75)), ((-3.0, 1.5, 0.0), (-2.0, 3.0, 1.0))]
MP_POSITIONS = [(-4.0, -3.0), (-1.5, -3.5), (1.5, -3.5), (4.0, -3.0),
                (-4.0, 0.0), (0.0, 0.5), (3.5, 1.0), (0.0, 3.5)]
MP_K_FULL = (1075.0, 1075.0, 640.0, 512.0)  # fx, fy, cx, cy at 1280x1024
MP_TARGETS = [f"scan0 pano{p:06d} {p % 2} {p % 6}" for p in range(len(MP_POSITIONS))]
MP_REAL_FRAMES = 2176  # ~2160 frames of a Matterport3D scan, padded to 64


def have_gt_libs():
    """The GT loaders read with OpenCV and Pillow, the CLI's paths with PyYAML."""
    return all(importlib.util.find_spec(m) is not None for m in ("cv2", "PIL", "yaml"))


def kitti_rays(sample_hw, device):
    """Ray directions (dx, dy, 1) of the KITTI loader's camera at GT_HW
    through the points where a `sample_hw` image's pixels land when
    cv2.resize brings it to GT_HW; a field affine in those points then
    resizes to its value at each GT_HW pixel.  Also returns those points."""
    (h, w), (sh, sw) = GT_HW, sample_hw
    u = (torch.arange(sw, dtype=torch.float64, device=device) + 0.5) * w / sw - 0.5
    v = (torch.arange(sh, dtype=torch.float64, device=device) + 0.5) * h / sh - 0.5
    u, v = u[None, :].expand(sh, sw), v[:, None].expand(sh, sw)
    return (u - 0.5 * w) / (0.58 * w), (v - 0.5 * h) / (1.92 * h), u, v


def kitti_depth(dx, dy, cam_x, cam_z):
    """Depth along the optical axis (0 where nothing within GT_MAX_DEPTH is
    hit) and the ground-hit mask of rays (dx, dy, 1) from a camera at
    (cam_x, 0, cam_z): the ground GT_CAM_HEIGHT below and GT_BOXES."""
    t_ground = torch.where(dy > 0, GT_CAM_HEIGHT / dy.clamp_min(1e-12), torch.inf)
    t = t_ground
    for x0, x1, z0, z1, height in GT_BOXES:
        near_z, far_z = max(z0, cam_z + 0.1) - cam_z, z1 - cam_z
        if far_z <= near_z:
            continue
        tx0, tx1 = (x0 - cam_x) / dx, (x1 - cam_x) / dx
        ty0, ty1 = (GT_CAM_HEIGHT - height) / dy, GT_CAM_HEIGHT / dy
        near = torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)).clamp_min(near_z)
        far = torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)).clamp_max(far_z)
        t = torch.where((near <= far) & (near < t), near, t)
    depth = torch.where(t < GT_MAX_DEPTH, t, 0.0)
    return depth, (t == t_ground) & (depth > 0)


def kitti_frame(frame, side, sample_hw, device, flow=False):
    """One frame of the synthetic sequence as the GT loaders read it: the
    PSMNet-layout disparity sampled at `sample_hw` (scaled so the loader's
    width rescale gives GT_HW pixels), the ground_seg [1,192,640] float16
    (PR 4's dump), the ORB-SLAM2 [3,4] pose of the left camera and, with
    `flow`, the [2, *sample_hw] flow to the previous frame: the flow the
    motion induces, plus GT_BLOB_FLOW px in x on the moving object."""
    cam_x, cam_z = (0.0 if side == "image_02" else GT_BASELINE), GT_STEP * frame
    dx, dy, u, v = kitti_rays(sample_hw, device)
    depth, _ = kitti_depth(dx, dy, cam_x, cam_z)
    fx = 0.58 * GT_HW[1]
    scale_x, scale_y = sample_hw[1] / GT_HW[1], sample_hw[0] / GT_HW[0]
    disp = torch.where(depth > 0, fx * GT_BASELINE / depth.clamp_min(1e-12), 0.0) * scale_x
    _, ground = kitti_depth(*kitti_rays(GT_HW, device)[:2], cam_x, cam_z)
    pose = np.eye(4)[:3]
    pose[2, 3] = cam_z
    out = {"disparity": disp.float().cpu().numpy(), "pose": pose.astype(np.float32),
           "ground_seg": ground[None].to(torch.float16).cpu().numpy()}
    if flow:
        z = depth + GT_STEP  # the previous camera is GT_STEP behind
        fu = 0.5 * GT_HW[1] + 0.58 * GT_HW[1] * depth * dx / z - u
        fv = 0.5 * GT_HW[0] + 1.92 * GT_HW[0] * depth * dy / z - v
        r0, r1, c0, c1 = GT_BLOB
        blob = (v >= r0) & (v < r1) & (u >= c0) & (u < c1)
        fu = fu + GT_BLOB_FLOW * blob
        out["flow"] = (torch.stack([fu * scale_x, fv * scale_y]) * (depth > 0)
                       ).float().cpu().numpy()
    return out


def mp_pose(position, height, direction):
    """Camera-to-world pose: yaw in 60-degree steps, pitch -30 / 0 / +30 by
    height index, 1.5 m above the floor; camera x right, y down, z forward,
    world z up."""
    yaw, pitch = np.deg2rad(60.0 * direction), np.deg2rad(30.0 * (height - 1))
    forward = np.array([np.cos(yaw) * np.cos(pitch), np.sin(yaw) * np.cos(pitch),
                        np.sin(pitch)])
    right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
    pose = np.eye(4)
    pose[:3, :3] = np.stack([right, np.cross(forward, right), forward], 1)
    pose[:3, 3] = [position[0], position[1], GT_CAM_HEIGHT]
    return pose


def mp_depth(pose, hw, device):
    """Depth along the optical axis and floor-hit mask of the room seen
    through MP_K_FULL scaled to `hw`."""
    h, w = hw
    fx, fy = MP_K_FULL[0] * w / 1280, MP_K_FULL[1] * h / 1024
    cx, cy = MP_K_FULL[2] * w / 1280, MP_K_FULL[3] * h / 1024
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                          torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    rays = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)])
    R = torch.from_numpy(pose[:3, :3]).to(device)
    d = torch.einsum("ij,jhw->ihw", R, rays)
    c = pose[:3, 3]
    walls = [torch.where(tw > 0, tw, torch.inf) for tw in
             ((wall - c[axis]) / d[axis] for axis, bounds in enumerate(MP_ROOM)
              for wall in bounds)]
    floor = walls[4]  # z = MP_ROOM[2][0]
    t = torch.stack(walls).amin(0)
    for lo, hi in MP_BOXES:
        t0 = (torch.tensor(lo, dtype=torch.float64, device=device)[:, None, None]
              - torch.from_numpy(c).to(device)[:, None, None]) / d
        t1 = (torch.tensor(hi, dtype=torch.float64, device=device)[:, None, None]
              - torch.from_numpy(c).to(device)[:, None, None]) / d
        near = torch.minimum(t0, t1).nan_to_num(-torch.inf).amax(0)
        far = torch.maximum(t0, t1).nan_to_num(torch.inf).amin(0)
        t = torch.where((near <= far) & (near > 0) & (near < t), near, t)
    return t, t == floor


def mp_frames():
    return [(f"pano{p:06d}", h, d) for p in range(len(MP_POSITIONS))
            for h in range(3) for d in range(6)]


def mp_frame(pos, height, direction, depth_hw, device):
    """(ground_seg [1,480,640] float16, depth [*depth_hw] in m, pose)."""
    pose = mp_pose(MP_POSITIONS[int(pos[4:])], height, direction)
    depth, _ = mp_depth(pose, depth_hw, device)
    _, ground = mp_depth(pose, MP_GT_HW, device)
    return (ground[None].to(torch.float16).cpu().numpy(),
            depth.clamp_max(65535 * 0.00025).cpu().numpy(), pose)


def make_gt_trees(root, real, device):
    """The synthetic KITTI sequence and Matterport scan under `root`, the
    splits and paths.yaml; without `real` only the splits (the in-memory
    route).  Returns {name: path}."""
    paths = {"kitti_td": os.path.join(root, "kitti_td"),
             "mp_raw": os.path.join(root, "mp_raw"), "mp_td": os.path.join(root, "mp_td"),
             "config": os.path.join(root, "paths.yaml")}
    for name, lines in (("hidden", GT_HIDDEN), ("masks", GT_MASKS), ("mp", MP_TARGETS)):
        paths[name] = os.path.join(root, f"{name}.txt")
        with open(paths[name], "w") as f:
            f.write("\n".join(lines))
    if not real:
        return paths

    import yaml
    from PIL import Image

    flows = {(int(f) - k, "image_02" if s == "l" else "image_03")
             for f, s in (line.split()[1:] for line in GT_MASKS) for k in (0, 1)}
    td = paths["kitti_td"]

    def save(path, array):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, array)

    def save_png(path, depth):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray((depth / 0.00025).astype(np.uint16)).save(path, compress_level=1)

    with ThreadPoolExecutor(8) as pool:
        jobs = []
        for frame in range(GT_FRAMES):
            name = f"{frame:010d}.npy"
            for side in ("image_02", "image_03"):
                data = kitti_frame(frame, side, KITTI_RAW_HW, device,
                                   flow=(frame, side) in flows)
                jobs.append(pool.submit(save, os.path.join(
                    td, "stereo_matching_disps", "seq0", side, name), data["disparity"]))
                jobs.append(pool.submit(save, os.path.join(
                    td, "ground_seg", "seq0", side, "data", name), data["ground_seg"]))
                if "flow" in data:
                    jobs.append(pool.submit(save, os.path.join(
                        td, "optical_flow", "seq0", side, "data", name), data["flow"]))
            jobs.append(pool.submit(save, os.path.join(
                td, "poses", "seq0", "orbslam_poses", name), data["pose"]))
        scan = os.path.join(paths["mp_raw"], "scan0", "scan0")
        for pos, height, direction in mp_frames():
            ground, depth, pose = mp_frame(pos, height, direction, MP_DEPTH_HW, device)
            jobs.append(pool.submit(save, os.path.join(
                paths["mp_td"], "ground_seg", "scan0", "data",
                f"{pos}_{height}_{direction}.npy"), ground))
            jobs.append(pool.submit(save_png, os.path.join(
                scan, "matterport_depth_images", f"{pos}_d{height}_{direction}.png"), depth))
            os.makedirs(os.path.join(scan, "matterport_camera_poses"), exist_ok=True)
            np.savetxt(os.path.join(scan, "matterport_camera_poses",
                                    f"{pos}_pose_{height}_{direction}.txt"), pose)
            os.makedirs(os.path.join(scan, "matterport_camera_intrinsics"), exist_ok=True)
            np.savetxt(os.path.join(scan, "matterport_camera_intrinsics",
                                    f"{pos}_intrinsics_{height}.txt"),
                       [[1280, 1024, *MP_K_FULL, 0, 0, 0, 0, 0]])
        for job in jobs:
            job.result()
    with open(paths["config"], "w") as f:
        yaml.safe_dump({"kitti": {"dataset": "", "training_data": td},
                        "matterport": {"dataset": paths["mp_raw"],
                                       "training_data": paths["mp_td"]}}, f)
    return paths


class InMemoryKITTILoader(gt_loader.KITTILoader):
    """The KITTI loader's dicts from the scene itself, rendered at the
    working size (no files, no OpenCV)."""
    device = "cpu"

    def load_frame_data(self, sequence, frame, side, load_flow=False,
                        use_buffer=True, threshold_ground=True):
        if use_buffer and (sequence, frame, side) in self.buffer:
            return self.buffer[(sequence, frame, side)]
        if not 0 <= frame < GT_FRAMES:
            return None
        data = kitti_frame(frame, side, GT_HW, self.device, flow=load_flow)
        ground = data["ground_seg"][0].astype(np.float64)
        pose = np.eye(4)
        pose[:3] = data["pose"]
        out = {"disparity": data["disparity"].astype(np.float64), "pose": pose,
               "ground_seg": ((ground > self.footprint_threshold).astype(float)
                              if threshold_ground else ground)}
        if load_flow:
            out["flow"] = data["flow"].astype(np.float64)
        if use_buffer:
            self.buffer[(sequence, frame, side)] = out
        return out


class InMemoryMatterportLoader(gt_loader.MatterportLoader):
    """The Matterport loader's arrays from the scene itself, at the working
    size (no files, no OpenCV or Pillow)."""
    device = "cpu"

    def load_frame_data(self, scan, pos, height, direction):
        ground, depth, pose = mp_frame(pos, int(height), int(direction), MP_GT_HW,
                                       self.device)
        depth = np.floor(depth / 0.00025) * 0.00025  # the PNG's 16-bit steps
        K = np.eye(4)
        K[:2, :3] = [[MP_K_FULL[0], 0, MP_K_FULL[2]], [0, MP_K_FULL[1], MP_K_FULL[3]]]
        K[0] *= self.width / self.FULL_WIDTH
        K[1] *= self.height / self.FULL_HEIGHT
        return (ground[0] > self.footprint_threshold).astype(float), depth, pose, K

    def load_scan_data(self):
        frames = [self.load_frame_data(self.current_scan, p, str(h), str(d))
                  for p, h, d in mp_frames()]
        for (p, h, d), frame in zip(mp_frames(), frames):
            self.pose_tracker[(p, str(h), str(d))] = frame[2]
        stack = [np.stack(a).astype(np.float32) for a in zip(*frames)]
        self.scan_data = {"ground_segs": stack[0], "depths": stack[1], "poses": stack[2],
                          "intrinsics": stack[3],
                          "inv_intrinsics": np.stack([np.linalg.pinv(f[3]) for f in frames]
                                                     ).astype(np.float32)}


def in_memory_generator(data_type, kind, argv, paths, device):
    """The CLI's generator class for (data_type, kind) over the in-memory
    loader, its outputs under the same training-data folder."""
    base = gt_generator.GENERATORS[(data_type, kind)]
    loader_cls = InMemoryKITTILoader if data_type == "kitti" else InMemoryMatterportLoader
    training_data = paths["kitti_td" if data_type == "kitti" else "mp_td"]

    class InMemory(base):
        def parse_config(self, config_path, data_key):
            return "", training_data

        def __init__(self, opts):
            super().__init__(opts)
            self.loader = loader_cls("", training_data, self.height, self.width,
                                     footprint_threshold=self.footprint_threshold)
            self.loader.device = device

    return InMemory(gt_generator.get_options(argv))


def drive_gt(data_type, kind, argv, real, paths, device):
    """Run the GT CLI (`real`), or the same generator class over the
    in-memory loader; returns the generator and its host seconds (loader,
    device work and writer included)."""
    t0 = time.perf_counter()
    if real:
        generator = gt_generator.main(argv)
    else:
        generator = in_memory_generator(data_type, kind, argv, paths, device)
        generator.run()
    return generator, time.perf_counter() - t0


def gt_outputs(folder):
    return {os.path.relpath(os.path.join(d, f), folder): np.load(os.path.join(d, f))
            for d, _, fs in os.walk(folder) for f in fs if f.endswith(".npy")}


def gt_names(lines, data_type):
    if data_type == "kitti":
        return sorted(f"seq0/{'image_02' if s == 'l' else 'image_03'}/data/{f.zfill(10)}.npy"
                      for f, s in (line.split()[1:] for line in lines))
    return sorted(f"scan0/data/{'_'.join(line.split()[1:])}.npy" for line in lines)


def check_gt_files(fail, tag, files, lines, data_type, dtype):
    """The JAX CLI's names, dtype and shape; a depth mask may be its float64
    zeros (fewer than 100 ground pixels).  Returns how many are."""
    hw = GT_HW if data_type == "kitti" else MP_GT_HW
    zeros = [n for n, a in files.items() if dtype == np.bool_ and a.dtype == np.float64
             and a.shape == hw and not a.any()]
    bad = [n for n, a in files.items() if n not in zeros and (
        a.shape != hw or a.dtype != dtype or not np.isfinite(a).all())]
    fail.check(sorted(files) == gt_names(lines, data_type) and not bad,
               f"{tag}: {len(files)} files, expected {len(lines)}; "
               f"wrong dtype/shape/non-finite: {bad[:3]}")
    return len(zeros)


def gt_gap(got, ref):
    """Share of pixels where `got` differs from `ref` by more than 1e-4|ref|
    or in being zero (hidden depths), or at all (masks)."""
    if ref.dtype == np.bool_:
        return float((got != ref).mean())
    return float(((np.abs(got - ref) > 1e-4 * np.abs(ref)) | ((got > 0) != (ref > 0))).mean())


def gt_run(fail, tag, data_type, kind, lines_path, paths, real, device):
    """One type through the CLI on `device` and its --device cpu twin on the
    first GT_CPU_TARGETS lines: the files' names, dtypes and shapes, and the
    share of pixels that differ.  Returns (the generator, its seconds, the
    device run's files)."""
    lines = readlines(lines_path)
    dtype = np.float32 if kind == "hidden_depths" else np.bool_

    def argv(dev, folder, end=-1):
        return ["--type", kind, "--data_type", data_type, "--textfile", lines_path,
                "--config_path", paths["config"], "--device", dev,
                "--save_folder_name", folder, "--idx_end", str(end)]

    td = paths["kitti_td" if data_type == "kitti" else "mp_td"]
    generator, seconds = drive_gt(data_type, kind, argv(device, kind), real, paths, device)
    drive_gt(data_type, kind, argv("cpu", kind + "_cpu", GT_CPU_TARGETS), real, paths, "cpu")
    files = gt_outputs(os.path.join(td, kind))
    twins = gt_outputs(os.path.join(td, kind + "_cpu"))
    zeros = check_gt_files(fail, tag, files, lines, data_type, dtype)
    check_gt_files(fail, tag + " (cpu)", twins, sorted(lines)[:GT_CPU_TARGETS], data_type, dtype)
    gaps = {n: gt_gap(files[n], twins[n]) for n in twins if n in files}
    worst = max(gaps.values(), default=1.0)
    fields = {}
    if kind == "depth_masks":
        # the two runs draw RANSAC's triplets from a CUDA and a CPU generator:
        # the same draws are fed to both sides to hold everything else
        fields["cli_gpu_vs_cpu_pixel_share_own_draws"] = worst
        worst = fed_mask_gap(generator, sorted(lines)[:GT_CPU_TARGETS])
    fail.check(len(gaps) == GT_CPU_TARGETS and worst <= GT_PIXEL_BAR,
               f"{tag}: GPU vs CPU differ at {worst:.2e} of the pixels (bar {GT_PIXEL_BAR})")
    emit("gt", data=data_type, type=kind, targets=len(files), float64_zeros_files=zeros,
         gpu_vs_cpu_pixel_share=worst, cpu_targets=len(gaps), **fields,
         frames_per_s_with_loader_and_writer=len(files) / seconds)
    return generator, seconds, files


def depth_mask_inputs(generator, line, i):
    """(depth, ground_seg, K, invK) as the generator's process_data hands
    them to compute_depth_mask."""
    data = generator.load_data(i, line)
    if "disparity" in data:  # KITTI
        loader = generator.loader
        depth = np_pixel_disp_to_depth(data["disparity"], loader.K[0, 0],
                                       loader.stereo_baseline)
        return depth, data["ground_seg"], loader.K, loader.invK
    return data["depth"], data["ground_seg"], data["K"], data["invK"]


def fed_mask_gap(generator, lines):
    """The worst share of pixels where compute_depth_mask on the generator's
    device and on the CPU differ, both fed the same triplets (drawn on the
    CPU, seeded), over `lines`' frames with enough ground."""
    worst = 0.0
    for i, line in enumerate(lines):
        arrays = [np.asarray(a, np.float32) for a in depth_mask_inputs(generator, line, i)]
        fit = (arrays[1] > generator.footprint_threshold) & (arrays[0] > 0)
        if (arrays[1] > generator.footprint_threshold).sum() < gt_generator.MIN_GROUND_PIXELS:
            continue
        idx = gt_ransac.draw_triplets(torch.from_numpy(fit.reshape(-1)), gt_ransac.DEFAULT_ITERS,
                                      torch.Generator().manual_seed(SEED))
        masks = [compute_depth_mask(*(torch.from_numpy(a).to(dev) for a in arrays),
                                    height=generator.height, width=generator.width,
                                    idx=idx.to(dev)).cpu().numpy()
                 for dev in (generator.device, "cpu")]
        worst = max(worst, float((masks[0] != masks[1]).mean()))
    return worst


def plane_errors(files):
    """Relative error of each hidden depth against the scene's plane depth
    through the pixel's centre, at the nonzero pixels (inf at a nonzero
    pixel above the horizon, where no ground is); and the share of the
    pixels whose ground a box hides in the target's own view that got a
    depth."""
    h, w = GT_HW
    rows = np.arange(h, dtype=np.float64)[:, None] + 0.5
    plane = np.broadcast_to(np.where(
        rows > 0.5 * h, 1.92 * h * GT_CAM_HEIGHT / np.maximum(rows - 0.5 * h, 1e-9), np.inf),
        GT_HW)
    dx, dy = kitti_rays(GT_HW, "cpu")[:2]
    errors, hidden, covered = [], 0, 0
    for name, out in files.items():
        side, frame = name.split("/")[1], int(name.split("/")[-1][:10])
        _, ground = kitti_depth(dx, dy, 0.0 if side == "image_02" else GT_BASELINE,
                                GT_STEP * frame)
        occluded = (plane < GT_MAX_DEPTH) & ~ground.numpy()
        hit = out > 0
        errors.append(np.abs(out[hit] - plane[hit]) / plane[hit])
        hidden += int(occluded.sum())
        covered += int((occluded & hit).sum())
    errors = np.nan_to_num(np.concatenate(errors), nan=np.inf)
    return errors, covered / max(hidden, 1)


def phase_gt(fail, workdir, device="cuda"):
    """GT generation through the port's CLI (module docstring, phase 13).
    Returns the generators and the KITTI hidden-depth run's seconds, for
    phase gt_times."""
    real = have_gt_libs()
    # the CLI must turn TF32 off itself (utils.select_device): a pixel's
    # index is the floor of a projected coordinate
    torch.backends.cuda.matmul.allow_tf32 = True
    route = ("footprints_tpu_torch.preprocessing.ground_truth_generation.generator.main"
             if real else "the generators over in-memory loaders (no OpenCV/Pillow/PyYAML)")
    t0 = time.perf_counter()
    paths = make_gt_trees(workdir, real, device)
    setup_s = time.perf_counter() - t0
    emit("gt", route=route, setup_seconds=setup_s,
         kitti=f"1 sequence, {GT_FRAMES} frames x 2 sides, disparities at "
               f"{KITTI_RAW_HW[0]}x{KITTI_RAW_HW[1]}",
         matterport=f"{len(mp_frames())} frames ({len(MP_POSITIONS)} panoramas x 18), depth "
                    f"PNGs at {MP_DEPTH_HW[1]}x{MP_DEPTH_HW[0]}: cut from a real scan's "
                    f"~2160 frames for file-writing time")
    hidden_gen, hidden_s, hidden = gt_run(fail, "gt kitti hidden_depths", "kitti",
                                          "hidden_depths", paths["hidden"], paths, real, device)
    fail.check(not torch.backends.cuda.matmul.allow_tf32,
               "gt: the CLI left TF32 on for matmuls")
    errors, coverage = plane_errors(hidden)
    median = float(np.median(errors)) if len(errors) else float("inf")
    fail.check(median < GT_PLANE_BAR,
               f"gt kitti hidden_depths: median relative error {median:.4f} against the "
               f"plane (bar {GT_PLANE_BAR})")
    emit("gt", data="kitti", type="hidden_depths", plane_median_rel_err=median,
         plane_p95_rel_err=float(np.quantile(errors, 0.95, method="nearest")),
         above_horizon_pixels=int(np.isinf(errors).sum()), nonzero_pixels=len(errors),
         occluded_ground_coverage=coverage)

    mask_gen, _, masks = gt_run(fail, "gt kitti depth_masks", "kitti", "depth_masks",
                                paths["masks"], paths, real, device)
    flagged = sum(int(m.sum()) for m in masks.values())
    fail.check(flagged > 0, "gt kitti depth_masks: no pixel flagged")

    _, _, moving = gt_run(fail, "gt kitti moving_objects", "kitti", "moving_objects",
                          paths["masks"], paths, real, device)
    r0, r1, c0, c1 = GT_BLOB
    blob = np.zeros(GT_HW, bool)
    blob[r0:r1, c0:c1] = True
    recall = float(np.mean([m[blob].mean() for m in moving.values()]))
    static = float(np.mean([m[~blob].mean() for m in moving.values()]))
    fail.check(recall >= 0.9 and static <= 0.02,
               f"gt kitti moving_objects: the moving object flagged at {recall:.3f} "
               f"(bar 0.9), the static scene at {static:.4f} (bar 0.02)")
    emit("gt", data="kitti", type="masks", depth_mask_flagged_pixels=flagged,
         moving_object_recall=recall, static_flagged_share=static)

    mp_gen, _, mp_hidden = gt_run(fail, "gt matterport hidden_depths", "matterport",
                                  "hidden_depths", paths["mp"], paths, real, device)
    coverage = float(np.mean([(m > 0).mean() for m in mp_hidden.values()]))
    fail.check(coverage > 0.05, f"gt matterport hidden_depths: {coverage:.3f} of the pixels")
    _, _, mp_masks = gt_run(fail, "gt matterport depth_masks", "matterport", "depth_masks",
                            paths["mp"], paths, real, device)
    emit("gt", data="matterport", frames_per_scan=len(mp_frames()),
         hidden_depth_nonzero_share=coverage,
         depth_mask_flagged_pixels=sum(int(m.sum()) for m in mp_masks.values()))
    return {"kitti_hidden": (hidden_gen, hidden_s), "kitti_masks": mask_gen,
            "mp_hidden": mp_gen}


def phase_gt_times(fail, runs, smi):
    """The GT path's device times (CUDA events) on one KITTI target's
    76-frame window, the depth mask alone, the loader alone, and the
    Matterport aggregate at a real scan's MP_REAL_FRAMES frames."""
    hidden_gen, hidden_s = runs["kitti_hidden"]
    t = hidden_gen.to_device
    data = hidden_gen.load_data(0, hidden_gen.filenames[0])
    depths, poses, K, invK = (t(data[k]) for k in ("depths", "poses", "intrinsics",
                                                     "inv_intrinsics"))
    n, (h, w) = len(depths), GT_HW
    grid = gt_geometry.pixel_grid(h, w, depths.device)

    def project():
        return gt_geometry.project_to_camera(
            gt_geometry.project_to_world(depths, invK, grid), poses, K)

    cam = project()

    def splat():
        return gt_geometry.extract_depth_from_projections(cam, h, w)

    projections = splat()

    def aggregate():
        return gt_geometry.aggregate_hidden_depth(depths, poses, K, invK, height=h, width=w)

    stages = {"projection": (project, n * h * w * 4 * (1 + 4)),
              "splat": (splat, n * h * w * 4 * (4 + 1)),
              "median": (lambda: gt_geometry.masked_median(projections, min_hits=2),
                         (n + 1) * h * w * 4),
              "aggregate": (aggregate, (n + 1) * h * w * 4)}
    kitti = {name: {"ms": time_ms(fn), "bound_ms": nbytes / PEAK_BYTES * 1e3}
             for name, (fn, nbytes) in stages.items()}

    mask_gen = runs["kitti_masks"]
    args = [t(a) for a in depth_mask_inputs(mask_gen, mask_gen.filenames[0], 0)]
    mask_ms = time_ms(lambda: compute_depth_mask(*args, height=h, width=w,
                                                 generator=mask_gen.generator))

    loader_gen = type(hidden_gen)(hidden_gen.opts)  # a cold buffer, as the timed run's
    t0 = time.perf_counter()
    for i, line in enumerate(loader_gen.filenames):
        loader_gen.load_data(i, line)
    loader_s = time.perf_counter() - t0

    mp_gen = runs["mp_hidden"]
    data = mp_gen.load_data(0, mp_gen.filenames[0])
    reps = -(-MP_REAL_FRAMES // len(data["depths"]))
    scan = [t(data[k]).repeat(reps, 1, 1)[:MP_REAL_FRAMES]
            for k in ("depths", "poses", "intrinsics", "inv_intrinsics")]
    small = gt_geometry.aggregate_hidden_depth(
        *(t(data[k]) for k in ("depths", "poses", "intrinsics", "inv_intrinsics")),
        height=MP_GT_HW[0], width=MP_GT_HW[1], robust=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    big = gt_geometry.aggregate_hidden_depth(*scan, height=MP_GT_HW[0], width=MP_GT_HW[1],
                                             robust=False)
    peak = torch.cuda.max_memory_allocated()
    fail.check(bool(torch.isfinite(big).all()) and bool(((big > 0) == (small > 0)).all()),
               "gt_times: the Matterport aggregate over the repeated scan hits other "
               "pixels than over the scan")
    mp_ms = time_ms(lambda: gt_geometry.aggregate_hidden_depth(
        *scan, height=MP_GT_HW[0], width=MP_GT_HW[1], robust=False), iters=3, warmup=1)
    emit("gt_times", nvidia_smi=smi,
         kitti_window_frames=n, kitti_aggregate_per_target=kitti,
         depth_mask_ms=mask_ms,
         generator_frames_per_s_with_loader_and_writer=len(hidden_gen.filenames) / hidden_s,
         loader_alone_frames_per_s=len(loader_gen.filenames) / loader_s,
         targets=len(hidden_gen.filenames),
         matterport_frames=MP_REAL_FRAMES,
         matterport_source=f"the scan's {len(data['depths'])} ground-masked frames repeated",
         matterport_aggregate_ms=mp_ms,
         matterport_aggregate_bound_ms=(MP_REAL_FRAMES + 1) * MP_GT_HW[0] * MP_GT_HW[1] * 4
         / PEAK_BYTES * 1e3,
         matterport_peak_gib=peak / 2**30, matterport_inputs_gib=held / 2**30)


# --- export and bf16 serving -------------------------------------------------

def export_cli(weights, out, *args):
    """One run of python -m footprints_tpu_torch.export's main at 192x640:
    (the artifact's metadata, the run's wall seconds)."""
    t0 = time.perf_counter()
    port_export.main(["--model_path", weights, "--out", out, "--height", str(HEIGHT),
                      "--width", str(WIDTH), *args])
    seconds = time.perf_counter() - t0
    with open(out + ".json") as f:
        return json.load(f), seconds


def live_forward(net, x):
    """The live serving forward of a FootprintNetwork: [N,4,H,W] numpy."""
    with torch.inference_mode():
        out = net(x, scales=("1/1",))["1/1"]
    return out.permute(0, 3, 1, 2).float().cpu().numpy()


def live_segmentor(net, x):
    """The seg Tester's forward (it reads only self.net) on the live net."""
    with torch.inference_mode():
        return Tester.forward(types.SimpleNamespace(net=net), x).cpu().numpy()


def channel_mae(got, ref):
    """MAE per output channel ([N,4,H,W]) or of the whole map ([N,H,W])."""
    got, ref = np.float32(got), np.float32(ref)
    return np.abs(got - ref).mean(axis=(0, 2, 3) if got.ndim == 4 else None)


def phase_export(fail, workdir):
    """Export FootprintNetwork-34 (phase main's seeded weights) and a seeded
    Segmentor-34 (PSP) through the export CLI on the card, and serve them:
    (a) bf16 at batch 16 through predict_simple --artifact over test_data/;
    (b) bf16 at batch 2 on the card and on the CPU, each against the live
    f32 forward on its device; (c) f32 at batch 2 against the live f32
    forward; (d) the Segmentor in bf16 at batch 12 through predict_simple's
    manager against the live f32 Tester.forward, on the card and the CPU.
    Returns (the artifacts' card launches, the batch-16 artifact's path,
    the FootprintNetwork weights)."""
    weights = os.path.join(workdir, "export_weights")
    os.makedirs(weights)
    net = FootprintNetwork(34, generator=torch.Generator().manual_seed(SEED))
    torch.save(net.state_dict(), os.path.join(weights, "model.pth"))
    seg_weights = os.path.join(workdir, "export_seg", "epoch_0.pth")
    os.makedirs(os.path.dirname(seg_weights))
    seg = Segmentor(34, True, generator=torch.Generator().manual_seed(SEED))
    torch.save(seg.state_dict(), seg_weights)
    del net, seg
    exports = {}

    def make(tag, *args, weights_path=weights):
        out = os.path.join(workdir, f"{tag}.pt2")
        meta, seconds = export_cli(weights_path, out, *args)
        exports[tag] = {"seconds": seconds, "bytes": meta["bytes"],
                        "dtype": meta["dtype"], "batch": meta["batch"],
                        "platforms": meta["platforms"],
                        "graph_ops": sum(n.op == "call_function" for n in
                                         torch.export.load(out).graph.nodes)}
        fail.check(meta["platforms"] == ["cuda", "cpu"] and meta["bytes"]
                   == os.path.getsize(out), f"export {tag}: metadata {meta}")
        return out

    # (a) the main path: predict_simple --artifact on the card
    a16 = make("bf16_b16", "--batch", str(EXPORT_BATCH), "--dtype", "bfloat16")
    served = os.path.join(workdir, "served")
    have_pil = importlib.util.find_spec("PIL") is not None
    fused_conv3x3.launches = fused_conv3x3.bf16_launches = 0
    if have_pil:
        route = "predict_simple.main --artifact"
        predict_simple.main(["--image", os.path.join(REPO, "test_data"), "--artifact", a16,
                             "--device", "cuda", "--no_save_vis", "--save_dir", served])
    else:
        route = "InferenceManager(artifact=...).predict_arrays (no PIL)"
        predict_simple.InferenceManager(
            None, served, save_visualisations=False, artifact=a16,
            device="cuda").predict_arrays(["arrays"], [np.random.RandomState(SEED).rand(
                HEIGHT, WIDTH, 3).astype(np.float32)])
    torch.cuda.synchronize()
    launches = {"served": (fused_conv3x3.launches, fused_conv3x3.bf16_launches)}
    files = sorted(os.listdir(os.path.join(served, "outputs")))
    batches = -(-len(files) // EXPORT_BATCH)
    per_forward = launches_per_forward("footprint")
    fail.check(len(files) > 0 and launches["served"] == (per_forward * batches,) * 2,
               f"artifact serving: {len(files)} files, (launches, bf16) "
               f"{launches['served']} for {batches} batches")
    for f in files:
        pred = np.load(os.path.join(served, "outputs", f))
        fail.check(pred.shape == (4, HEIGHT, WIDTH) and pred.dtype == np.float32
                   and np.isfinite(pred).all(),
                   f"artifact serving {f}: {pred.shape} {pred.dtype}")

    # (b), (c): the bf16 and f32 artifacts at batch 2 against the live f32
    # forward, on the card and (bf16) on the CPU
    x = np.random.RandomState(SEED + 2).rand(EXPORT_CHECK_BATCH, HEIGHT, WIDTH,
                                             3).astype(np.float32)
    live = {}
    for device in ("cuda", "cpu"):
        mm = ModelManager(is_inference=True, device=device)
        mm.load_model(weights)
        live[device] = live_forward(mm.net, torch.from_numpy(x).to(device))
    del mm
    a2 = make("bf16_b2", "--batch", str(EXPORT_CHECK_BATCH), "--dtype", "bfloat16")
    gaps = {}
    for device in ("cuda", "cpu"):
        fused_conv3x3.launches = fused_conv3x3.bf16_launches = 0
        got = port_export.load_serving(a2, device=device).call(x)
        sync(device)
        launches[f"bf16_b2_{device}"] = (fused_conv3x3.launches, fused_conv3x3.bf16_launches)
        fail.check(np.isfinite(got).all() and got.shape == (EXPORT_CHECK_BATCH, 4, HEIGHT,
                                                            WIDTH), f"bf16 b2 on {device}")
        gaps[device] = channel_mae(got, live[device])
    fail.check(launches["bf16_b2_cuda"] == (per_forward,) * 2
               and launches["bf16_b2_cpu"] == (0, 0), f"bf16 b2 launches {launches}")
    fail.check(bool((gaps["cuda"] <= 2 * gaps["cpu"] + 1e-3).all()),
               f"bf16 artifact on the card vs f32 live MAE per channel {gaps['cuda']}, "
               f"on the CPU {gaps['cpu']}: more than twice the CPU's + 1e-3")
    a32 = make("f32_b2", "--batch", str(EXPORT_CHECK_BATCH), "--dtype", "float32")
    fused_conv3x3.launches = fused_conv3x3.bf16_launches = 0
    f32_mae = float(channel_mae(port_export.load_serving(a32).call(x), live["cuda"]).mean())
    torch.cuda.synchronize()
    launches["f32_b2_cuda"] = (fused_conv3x3.launches, fused_conv3x3.bf16_launches)
    fail.check(f32_mae < 1e-4 and launches["f32_b2_cuda"] == (per_forward, 0),
               f"f32 artifact vs live f32 forward MAE {f32_mae}, launches "
               f"{launches['f32_b2_cuda']}")

    # (d) the Segmentor artifact through predict_simple's manager
    aseg = make("seg_bf16_b12", "--batch", str(SEG_EXPORT_BATCH), "--dtype", "bfloat16",
                "--network", "segmentor", weights_path=seg_weights)
    frames = np.random.RandomState(SEED + 3).rand(SEG_EXPORT_BATCH, HEIGHT, WIDTH,
                                                  3).astype(np.float32)
    fused_conv3x3.launches = fused_conv3x3.bf16_launches = 0
    manager = predict_simple.InferenceManager(None, os.path.join(workdir, "served_seg"),
                                              save_visualisations=False, artifact=aseg,
                                              device="cuda")
    seg_card = manager.predict_arrays([f"frame{i}" for i in range(len(frames))], frames)
    torch.cuda.synchronize()
    launches["seg_served"] = (fused_conv3x3.launches, fused_conv3x3.bf16_launches)
    fail.check(launches["seg_served"] == (launches_per_forward("segmentor"),) * 2
               and seg_card.shape == (SEG_EXPORT_BATCH, HEIGHT, WIDTH)
               and seg_card.dtype == np.float16 and np.isfinite(seg_card).all(),
               f"Segmentor artifact: {seg_card.shape} {seg_card.dtype}, launches "
               f"{launches['seg_served']}")
    seg_cpu = port_export.load_serving(aseg, device="cpu").call(frames)
    seg_gaps = {}
    for device, got in (("cuda", seg_card), ("cpu", seg_cpu)):
        live_net = Segmentor(34, True, device=device).eval()
        load_segmentor_weights(live_net, seg_weights)
        seg_gaps[device] = float(channel_mae(
            got, live_segmentor(live_net, torch.from_numpy(frames).to(device))))
    del live_net
    fail.check(seg_gaps["cuda"] <= 2 * seg_gaps["cpu"] + 1e-3,
               f"Segmentor bf16 artifact vs live f32 Tester.forward MAE {seg_gaps}")
    emit("export", route=route, exports=exports, served_files=len(files),
         launches_and_bf16_launches=launches,
         bf16_b2_mae_per_channel={k: v.tolist() for k, v in gaps.items()},
         bar="card <= 2 x CPU + 1e-3 per channel", f32_b2_mae=f32_mae, f32_bar=1e-4,
         segmentor_bf16_mae=seg_gaps)
    card = [v for k, v in launches.items() if not k.endswith("_cpu")]
    return sum(n for n, _ in card), a16, weights


def phase_export_times(fail, workdir, a16, weights, run):
    """The bf16 artifact's serving rate at batch 16 and p50 at batch 1 beside
    the live f32 forward's (phase times' method, in turns); one profiled
    artifact forward at 16; the native LANCZOS resize against PIL's on
    KITTI frames; the KITTI trainer's loader alone with and without
    FOOTPRINTS_NATIVE_RESIZE."""
    a1 = os.path.join(workdir, "bf16_b1.pt2")
    export_cli(weights, a1, "--batch", "1", "--dtype", "bfloat16")
    mm = ModelManager(is_inference=True, device="cuda")
    mm.load_model(weights)
    forwards = {}
    for batch, path in ((EXPORT_BATCH, a16), (1, a1)):
        x = torch.rand(batch, HEIGHT, WIDTH, 3, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(batch))
        art = port_export.load_serving(path).module
        forwards[batch] = {"f32_live": lambda x=x: mm.net(x, scales=("1/1",)),
                           "bf16_artifact": lambda x=x, art=art: art(x)}
    rows = {}
    with torch.inference_mode():
        for name in ("f32_live", "bf16_artifact", "bf16_artifact", "f32_live"):
            ms = time_ms(forwards[EXPORT_BATCH][name], iters=10)
            rows.setdefault(name, {}).setdefault("imgs_per_s_b16", []).append(
                EXPORT_BATCH / (ms * 1e-3))
            forward = forwards[1][name]
            for _ in range(3):
                forward()
            lat = []
            for _ in range(30):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                forward()
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
            rows[name].setdefault("p50_ms_b1", []).append(statistics.median(lat))
    # the user's call: numpy in, numpy out, host clock
    serving = port_export.load_serving(a16)
    images = np.random.RandomState(SEED).rand(EXPORT_BATCH, HEIGHT, WIDTH,
                                              3).astype(np.float32)
    serving.call(images)
    t0 = time.perf_counter()
    for _ in range(5):
        serving.call(images)
    call_rate = 5 * EXPORT_BATCH / (time.perf_counter() - t0)
    emit("export_times", model="FootprintNetwork-34, 192x640", forwards=rows,
         bf16_artifact_call_imgs_per_s_b16=call_rate,
         method="imgs/s: 10 calls on a card tensor (CUDA events); p50: 30 host-clock "
                "batch-1 calls ending in a synchronise; in turns live, artifact, "
                "artifact, live; call: ServingModel.call on numpy, 5 calls")
    x16 = torch.rand(EXPORT_BATCH, HEIGHT, WIDTH, 3, device="cuda")
    summary, top = profile_forward(lambda: serving.module(x16), "profile_artifact_b16.json")
    emit("export_times", profile="bf16 artifact forward, batch 16", **summary,
         busy_share=1 - summary["idle_share"],
         kernel_share_of_busy=summary["ms_by_category"].get("fused_conv3x3", 0.0)
         / summary["kernel_ms_per_forward"], top=top[:10])
    del mm, serving, forwards

    # the native LANCZOS resize against PIL's, byte for byte
    from PIL import Image

    rng = np.random.RandomState(SEED)
    raw = [smooth_frame(rng, KITTI_RAW_HW) for _ in range(NATIVE_FRAMES)]
    port_native.load_library()  # built before the timing
    same = [np.array_equal(port_native.resize_lanczos(a, HEIGHT, WIDTH),
                           np.asarray(Image.fromarray(a).resize((WIDTH, HEIGHT),
                                                                Image.LANCZOS)))
            for a in raw]
    fail.check(all(same), f"native LANCZOS vs PIL, byte for byte: {same}")
    resize_ms = {}
    for name, fn in (("pil", lambda a: Image.fromarray(a).resize((WIDTH, HEIGHT), Image.LANCZOS)),
                     ("native", lambda a: port_native.resize_lanczos(a, HEIGHT, WIDTH))):
        t0 = time.perf_counter()
        for _ in range(3):
            for a in raw:
                fn(a)
        resize_ms[name] = (time.perf_counter() - t0) * 1e3 / (3 * NATIVE_FRAMES)
    rates = {}
    if run["real"]:
        # the trainer's own training loader (TrainManager.create_dataloaders)
        opt = Options().parse(run["argv"] + ["--split_root",
                                             run["splits"][TRAIN_TIMED_BATCHES + 1]])
        loader, _ = TrainManager.create_dataloaders(types.SimpleNamespace(opt=opt))
        rates["workers"] = opt.num_workers
        for setting in ("unset", "1"):
            if setting == "1":
                os.environ["FOOTPRINTS_NATIVE_RESIZE"] = "1"
            try:
                rates[setting] = loader_rate(loader)
            finally:
                os.environ.pop("FOOTPRINTS_NATIVE_RESIZE", None)
    emit("export_times", native_resize=f"{KITTI_RAW_HW[0]}x{KITTI_RAW_HW[1]} -> "
         f"{HEIGHT}x{WIDTH} LANCZOS, uint8 RGB", frames=NATIVE_FRAMES,
         byte_exact_vs_pil=all(same), ms_per_frame=resize_ms,
         loader_alone_imgs_per_s_by_FOOTPRINTS_NATIVE_RESIZE=rates or
         "not measured (no PIL/OpenCV/PyYAML: no KITTI tree)",
         loader=f"{TRAIN_TIMED_BATCHES} batches of {TRAIN_BATCH} after an untimed first")


# --- phase dp: data parallelism (footprints_tpu_torch/parallel/) ------------

DP_WORLD = 2  # ranks sharing the one card over gloo (NCCL refuses two ranks on one device)
DP_TIMED_STEPS = 3


def dp_summary(mesh, net, optimizer, metrics, launches):
    """A data-parallel step's result on this rank: the ranks' mean of each
    loss term, every rank's replica digest and this rank's kernel launches;
    from rank 0 the averaged gradients (f32) and the BN running stats."""
    names = sorted(k for k in metrics if k != "lr")
    losses = all_reduce_mean(mesh, torch.stack([metrics[k] for k in names])).tolist()
    digests = [None] * mesh.world_size
    torch.distributed.all_gather_object(digests, replica_digest(net, optimizer),
                                        group=mesh.side_group)
    out = {"losses": dict(zip(names, losses)), "digests": digests, "launches": launches}
    if mesh.rank == 0:
        out["grads"] = {n: p.grad.detach().cpu().numpy() for n, p in net.named_parameters()
                        if p.grad is not None}
        out["stats"] = {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()
                        if "running" in k}
    return out


def dp_footprint_rank(mesh, host, heads=True):
    """One data-parallel step of the seeded FootprintNetwork-34 (f32, as
    train_step_on builds it) on this rank's rows of `host`."""
    mm = ModelManager(device=mesh.device, seed=SEED, steps_per_epoch=TRAIN_STEPS)
    sync_batch_norm(mm.net, mesh)
    replicate_tree(mesh, mm.net)
    config = TrainStepConfig(steps_per_epoch=TRAIN_STEPS, s2d_head=heads, p4_head=heads)
    step = build_train_step(mm.net, mm.optimizer, config, mesh)
    batch = shard_batch(mesh, host)
    before = fused_conv3x3.launches
    reset_bwd_counts()
    metrics = step(0, batch)
    torch.cuda.synchronize(mesh.device)
    return {**dp_summary(mesh, mm.net, mm.optimizer, metrics, fused_conv3x3.launches - before),
            "bwd_launches": bwd_counts()}


def dp_segmentor_rank(mesh, host):
    """One data-parallel f32 step of the seeded Segmentor-34 (PSP), as
    seg_step_on builds it."""
    net = Segmentor(34, True, device=mesh.device, generator=torch.Generator().manual_seed(SEED))
    sync_batch_norm(net, mesh)
    replicate_tree(mesh, net)
    optimizer = make_optimizer(net, TrainStepConfig())
    step = seg_trainer.build_train_step(net, optimizer, lambda s: 1e-4, torch.float32, mesh)
    batch = shard_batch(mesh, host)
    before = fused_conv3x3.launches
    reset_bwd_counts()
    metrics = step(0, batch)
    torch.cuda.synchronize(mesh.device)
    return {**dp_summary(mesh, net, optimizer, metrics, fused_conv3x3.launches - before),
            "bwd_launches": bwd_counts()}


def dp_card_batch(mesh, host, heads):
    """This rank's rows of `host` on its card, with the packed targets the
    trainer's decode makes when the heads are on."""
    keys = TARGET_KEYS if heads else ()
    return decompact_on_device(shard_batch(mesh, host), None, keys, keys)


# the profiler's spans of the DP step's all-reduces: the global BN's forward
# and backward (nn/layers.py:_AllReduceSum) and the gradient bucket
# (parallel/mesh.py:all_reduce_gradients)
DP_REDUCE_SPANS = ("_AllReduceSum", "_AllReduceSumBackward", "all_reduce_gradients")
# the host's waits for the card: gloo synchronises the stream before it
# copies a CUDA tensor to the host, which waits for all compute queued before
DP_SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize")


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def overlap_ns(a, b):
    """Time in which an interval of merged `a` and one of merged `b` both ran."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def dp_profiled(fn, device, span_names=DP_REDUCE_SPANS):
    """fn() once under torch.profiler: its wall ms (host clock ending in a
    synchronise); the device's busy ms (the union of this process's kernel
    intervals) and idle ms (wall - busy); the host ms inside the collective
    spans (`span_names`, by default the all-reduces' DP_REDUCE_SPANS; the
    keys say all_reduce whatever the spans), by name and as their union,
    which includes gloo's stream synchronise and so the wait for every
    kernel queued before each span; the synchronise calls' ms inside the spans (any
    thread); and the spans net of them, the collectives' own host time
    (copies, the exchange, the wait for the peer rank), with its share of
    the wall; and the 8 ops of most self CPU time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    raw = prof.profiler.kineto_results.events()
    host = [e for e in raw if e.device_type() == DeviceType.CPU]
    spans = {k: merged((e.start_ns(), e.end_ns()) for e in host if e.name() == k)
             for k in span_names}
    in_spans = merged(iv for ivs in spans.values() for iv in ivs)
    syncs = merged((e.start_ns(), e.end_ns()) for e in host if e.name() in DP_SYNC_CALLS)
    spans_ms = sum(end - start for start, end in in_spans) / 1e6
    sync_ms = overlap_ns(in_spans, syncs) / 1e6
    busy_ms = union_ns([span[:2] for span in device_spans(raw)]) / 1e6
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
    return {"profiled_wall_ms": wall_ms, "busy_ms_union": busy_ms,
            "idle_ms": wall_ms - busy_ms,
            "all_reduce_span_ms": {k: sum(end - start for start, end in ivs) / 1e6
                                   for k, ivs in spans.items()},
            "all_reduce_spans_ms_union": spans_ms,
            "stream_sync_in_spans_ms": sync_ms, "stream_sync_calls": len(syncs),
            "all_reduce_net_of_sync_ms": spans_ms - sync_ms,
            "all_reduce_net_of_sync_share": (spans_ms - sync_ms) / wall_ms,
            "top_self_cpu_ms": {e.key[:60]: e.self_cpu_time_total / 1e3 for e in top}}


def dp_world1_times(mesh, host):
    """At world 1 over NCCL: the DP step (global BN's all-reduces, the
    gradient all-reduce) against the plain step (no group), f32 and bf16
    with the packed heads, in turns (plain, dp, dp, plain), each reading
    the mean of DP_TIMED_STEPS steps by CUDA events; peak memory; one
    profiled step of each (dp_profiled)."""
    out = {}
    for compute in ("float32", "bfloat16"):
        heads = compute == "bfloat16"
        config = TrainStepConfig(steps_per_epoch=TRAIN_STEPS, compute_dtype=compute,
                                 s2d_head=heads, p4_head=heads)
        steps = {}
        for name in ("plain", "dp"):
            mm = ModelManager(device=mesh.device, seed=SEED, steps_per_epoch=TRAIN_STEPS)
            if name == "dp":
                sync_batch_norm(mm.net, mesh)
            steps[name] = build_train_step(mm.net, mm.optimizer, config,
                                           mesh if name == "dp" else None)
        b = dp_card_batch(mesh, host, heads)
        for fn in steps.values():
            time_ms(lambda: fn(0, b), iters=1, warmup=2)
        torch.cuda.reset_peak_memory_stats(mesh.device)
        readings = {"plain": [], "dp": []}
        for name in ("plain", "dp", "dp", "plain"):
            readings[name].append(time_ms(lambda: steps[name](0, b), iters=DP_TIMED_STEPS,
                                          warmup=0))
        out[compute] = {"plain_ms": readings["plain"], "dp_ms": readings["dp"],
                        "peak_memory_gib_both_models": torch.cuda.max_memory_allocated(
                            mesh.device) / 2 ** 30,
                        "profiled": {name: dp_profiled(lambda: fn(0, b), mesh.device)
                                     for name, fn in steps.items()}}
    return out


def dp_world2_times(mesh, host):
    """At world 2 on the one card over gloo: the f32 DP step at the global
    batch of `host` (host clock ending in a synchronise, mean of
    DP_TIMED_STEPS after 2), one profiled step (dp_profiled: the
    all-reduces' host time net of gloo's waits for queued compute, and its
    share of the wall), and this rank's peak memory."""
    mm = ModelManager(device=mesh.device, seed=SEED, steps_per_epoch=TRAIN_STEPS)
    sync_batch_norm(mm.net, mesh)
    replicate_tree(mesh, mm.net)
    step = build_train_step(mm.net, mm.optimizer,
                            TrainStepConfig(steps_per_epoch=TRAIN_STEPS), mesh)
    b = dp_card_batch(mesh, host, False)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    for _ in range(2):
        step(0, b)
    torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    for _ in range(DP_TIMED_STEPS):
        step(0, b)
    torch.cuda.synchronize(mesh.device)
    ms = (time.perf_counter() - t0) * 1e3 / DP_TIMED_STEPS
    return {"batch_per_rank": len(b["image"]), "step_ms": ms,
            **dp_profiled(lambda: step(0, b), mesh.device),
            "peak_memory_gib": torch.cuda.max_memory_allocated(mesh.device) / 2 ** 30}


def dp_world1_rank(mesh, check_host, timed_host):
    return {"check": dp_footprint_rank(mesh, check_host),
            "times": dp_world1_times(mesh, timed_host)}


def dp_world2_rank(mesh, check_host, seg_host, timed_host):
    return {"check": dp_footprint_rank(mesh, check_host),
            "segmentor": dp_segmentor_rank(mesh, seg_host),
            "times": dp_world2_times(mesh, timed_host)}


def dp_against(fail, tag, got, ref):
    """Phase 7's bars on a DP step's rank-0 result against an f64 CPU
    step's (metrics, grads, stats): loss terms 1e-5 + 1e-5|ref|, each
    gradient leaf ||d||/||ref|| < 2e-2, BN running stats 1e-5."""
    m_ref, g_ref, s_ref = ref[:3]
    grads = {k: torch.from_numpy(v).double() for k, v in got["grads"].items()}
    worst_loss = max(abs(got["losses"][k] - v) for k, v in m_ref.items())
    loss_ok = all(abs(got["losses"][k] - v) <= 1e-5 + 1e-5 * abs(v) for k, v in m_ref.items())
    leaf, rel = worst_grad_leaf(grads, g_ref)
    bn_err = max(float(np.abs(got["stats"][k] - v.numpy()).max()) for k, v in s_ref.items())
    fail.check(loss_ok, f"dp {tag}: loss terms differ from the f64 step by up to {worst_loss}")
    fail.check(grads.keys() == g_ref.keys() and rel < 2e-2,
               f"dp {tag}: gradient of {leaf} {rel} from the f64 step")
    fail.check(bn_err <= 1e-5, f"dp {tag}: BN running stats differ by {bn_err}")
    return {"loss_max_abs_err": worst_loss, "worst_grad_leaf": leaf, "worst_grad_rel": rel,
            "bn_max_abs_err": bn_err}


def dp_torchrun(fail, run, workdir):
    """(a) world 1 through the real launch path: torchrun, NCCL,
    main --mode train; the checkpoint resumed by a plain TrainManager."""
    fail.check(run["real"], "dp: the torchrun run needs the KITTI tree (Pillow, OpenCV, "
                            "PyYAML)")
    if not run["real"]:
        return 0, {}
    argv = run["argv"] + ["--model_name", "smoke_dp"]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
         "-m", "footprints_tpu_torch.main", *argv],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, capture_output=True, text=True,
        timeout=600)
    seconds = time.perf_counter() - t0
    os.makedirs(os.path.join(REPO, "smoke_out"), exist_ok=True)
    with open(os.path.join(REPO, "smoke_out", "dp_torchrun.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    fail.check(proc.returncode == 0, f"dp: torchrun exited {proc.returncode}: "
                                     f"{proc.stderr[-2000:]}")
    out = proc.stdout
    meshes = re.findall(r"data parallel: (.*)", out)
    fail.check(meshes == ["rank 0 of 1 on cuda:0 over nccl"],
               f"dp: torchrun's rank reported {meshes}, expected rank 0 of 1 on cuda:0 "
               f"over nccl")
    counts = re.findall(r"rank 0: (\d+) fused_conv3x3 launches in this process, (\d+) bf16",
                        out)
    launches = int(counts[0][0]) if len(counts) == 1 else 0
    expected = launches_per_forward("footprint") * (TRAIN_STEPS + VAL_BATCHES)
    fail.check(launches == expected, f"dp: torchrun rank 0 launched the kernel {counts}, "
                                     f"expected {expected}")
    bwd = re.findall(r"rank 0: .*backward: (\d+) fused_conv3x3_dgrad, (\d+) "
                     r"fused_conv3x3_wgrad", out)
    bwd = [{"fused_conv3x3_dgrad": [int(d), 0], "fused_conv3x3_wgrad": [int(w), 0]}
           for d, w in bwd]
    check_bwd_counts(fail, "dp torchrun rank 0", bwd, TRAIN_STEPS,
                     launches_per_forward("footprint"), bf16=False)
    losses = [float(v) for v in re.findall(r"Epoch 0 -- Batch 0 -- Loss (\S+)", out)]
    fail.check(len(losses) == 1 and np.isfinite(losses).all(), f"dp: logged losses {losses}")
    weights = os.path.join(workdir, "train_logs", "smoke_dp", "models", "weights_0")
    ckpt = os.path.join(weights, "checkpoint.npz")
    ok = os.path.exists(ckpt) and out.count("saving checkpoint to") == 1
    if ok:
        loaded = load_checkpoint(ckpt)
        ok = int(loaded["step"]) == TRAIN_STEPS == int(loaded["opt_state"][0][0])
    fail.check(ok, f"dp: {ckpt} missing, written more than once, or not at step "
                   f"{TRAIN_STEPS}")
    resumed = {}
    if ok:
        tm = trainer_for(run, ["--model_name", "smoke_dp", "--load_path", weights])
        (count, _, _), _ = tm.model_manager.train_state()["opt_state"]
        resumed = {"world_size": tm.mesh.world_size, "step": tm.step, "adam_count": int(count)}
        tm.val_iter.close()
        fail.check(resumed == {"world_size": 1, "step": TRAIN_STEPS, "adam_count": TRAIN_STEPS},
                   f"dp: the plain TrainManager resumed {resumed}")
    return launches, {"launcher": "torch.distributed.run --standalone --nproc_per_node=1",
                      "mesh": meshes, "launches": launches, "launches_expected": expected,
                      "backward_kernel_launches": bwd,
                      "logged_loss": losses, "checkpoint": os.path.relpath(ckpt, workdir),
                      "resumed": resumed, "seconds": seconds}


def phase_dp(fail, run, workdir, host, f32_check):
    """(a) world 1 through torchrun + NCCL; (b) dryrun_multichip at world 2
    on the one card; (c) the world-1 (NCCL) and world-2 (gloo) DP steps on
    the check batch against the f64 CPU step of train_check_steps; (d) the
    Segmentor-34's world-2 step against its f64 CPU step; (e) times.
    Returns the kernel's launches on the main paths driven here."""
    t0 = time.perf_counter()
    launches_a, torchrun = dp_torchrun(fail, run, workdir)
    seconds = {"torchrun": time.perf_counter() - t0}

    t0 = time.perf_counter()
    try:
        dry = dryrun_multichip(DP_WORLD, device="cuda", height=HEIGHT, width=WIDTH, depth=34)
    except RuntimeError as e:
        fail.check(False, f"dp: dryrun_multichip({DP_WORLD}, device='cuda'): {e}")
        dry = []
    seconds["dryrun"] = time.perf_counter() - t0
    fp, seg = launches_per_forward("footprint"), launches_per_forward("segmentor")
    fail.check(len(dry) == DP_WORLD and all(
        r["f32"]["launches"] == fp and r["f32"]["bf16_launches"] == 0
        and r["bf16"]["launches"] == r["bf16"]["bf16_launches"] == fp
        for r in dry), f"dp: dryrun launches per rank {dry}")
    launches_b = sum(r["f32"]["launches"] + r["bf16"]["launches"] for r in dry)

    small = collate([InMemorySamples(CHECK_BATCH, CHECK_SEED)[i] for i in range(CHECK_BATCH)])
    seg_small = collate([InMemorySegSamples(CHECK_BATCH, CHECK_SEED)[i]
                         for i in range(CHECK_BATCH)])
    t0 = time.perf_counter()
    try:
        w1 = spawn(1, dp_world1_rank, small, host, device="cuda", backend="nccl")[0]
        w2 = spawn(DP_WORLD, dp_world2_rank, small, seg_small, host, device="cuda",
                   backend="gloo")
    except RuntimeError as e:
        fail.check(False, f"dp: a DP world failed: {e}")
        return launches_a + launches_b
    seconds["worlds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seg_ref = seg_step_on("cpu", seg_small, torch.float64)
    seconds["seg_f64_reference"] = time.perf_counter() - t0

    ref, gpu_single = f32_check["cpu_f64"], f32_check["gpu_f32_heads"]
    checks = {"world_1_nccl": dp_against(fail, "world 1", w1["check"], ref),
              "world_2_gloo": dp_against(fail, "world 2", w2[0]["check"], ref),
              "segmentor_world_2_gloo": dp_against(fail, "segmentor world 2",
                                                   w2[0]["segmentor"], seg_ref)}
    leaf, rel = worst_grad_leaf(gpu_single[1], ref[1])
    checks["single_process_gpu_step"] = {
        "loss_max_abs_err": max(abs(gpu_single[0][k] - v) for k, v in ref[0].items()),
        "worst_grad_leaf": leaf, "worst_grad_rel": rel,
        "bn_max_abs_err": max(float((gpu_single[2][k] - v).abs().max())
                              for k, v in ref[2].items())}
    for tag, got in (("footprint", w2[0]["check"]), ("segmentor", w2[0]["segmentor"])):
        fail.check(len(set(got["digests"])) == 1,
                   f"dp {tag} world 2: replicas differ: {got['digests']}")
    per_rank = {"footprint": [r["check"]["launches"] for r in w2],
                "segmentor": [r["segmentor"]["launches"] for r in w2]}
    fail.check(w1["check"]["launches"] == fp
               and per_rank["footprint"] == [fp] * DP_WORLD
               and per_rank["segmentor"] == [seg] * DP_WORLD,
               f"dp: check-step launches world 1 {w1['check']['launches']}, world 2 {per_rank}")
    launches_cd = (w1["check"]["launches"] + sum(per_rank["footprint"])
                   + sum(per_rank["segmentor"]))
    bwd = {"world_1": check_bwd_counts(fail, "dp world 1", [w1["check"]["bwd_launches"]], 1,
                                       fp, bf16=False),
           "world_2": check_bwd_counts(fail, "dp world 2", [r["check"]["bwd_launches"]
                                                            for r in w2], 1,
                                       fp, bf16=False),
           "segmentor_world_2": check_bwd_counts(
               fail, "dp segmentor world 2", [r["segmentor"]["bwd_launches"] for r in w2], 1,
               seg, bf16=False),
           "dryrun_per_rank": check_bwd_counts(
               fail, "dp dryrun", [r[k]["bwd_launches"] for r in dry for k in ("f32",)], 1,
               fp, bf16=False) + check_bwd_counts(
               fail, "dp dryrun bf16", [r[k]["bwd_launches"] for r in dry for k in ("bf16",)],
               1, fp, bf16=True)}
    emit("dp", torchrun=torchrun, backward_kernel_launches_per_rank=bwd,
         dryrun={"world": DP_WORLD, "backend": "gloo", "device": "cuda:0 (all ranks)",
                 "shape": [HEIGHT, WIDTH], "depth": 34, "images_per_rank": 2,
                 "loss_f32": dry[0]["f32"]["loss"] if dry else None,
                 "loss_bf16_packed_heads": dry[0]["bf16"]["loss"] if dry else None,
                 "replicas_bitwise_equal": bool(dry),
                 "launches_per_rank": [[r["f32"]["launches"], r["bf16"]["bf16_launches"]]
                                       for r in dry]},
         check_steps=dict(batch=CHECK_BATCH, shape=[HEIGHT, WIDTH],
                          input=f"noise, seed {CHECK_SEED}", reference="CPU, f64",
                          images_per_rank_world_2=CHECK_BATCH // DP_WORLD,
                          loss_bar="1e-5 + 1e-5|ref|", grad_bar=2e-2, bn_bar=1e-5, **checks),
         seconds=seconds)
    world2 = [r["times"] for r in w2]
    emit("dp_times", batch=TRAIN_BATCH, shape=[HEIGHT, WIDTH], depth=34,
         world_1_nccl_vs_plain=w1["times"],
         world_2_gloo_f32={"step_ms_by_rank": [t["step_ms"] for t in world2],
                           "imgs_per_s": TRAIN_BATCH / (max(t["step_ms"] for t in world2)
                                                        * 1e-3),
                           # the ranks time-share the card: their busy times
                           # add up to the card's
                           "card_busy_share_both_ranks": sum(
                               t["busy_ms_union"] for t in world2) / max(
                               t["profiled_wall_ms"] for t in world2),
                           "ranks": world2},
         method="CUDA events in turns (plain, dp, dp, plain) at world 1; host clock "
                "ending in a synchronise at world 2, both ranks on one card")
    return launches_a + launches_b + launches_cd

# --- phase spatial: row-sharded eval and training (parallel/halo.py) ----------

# (case, model, global batch, (H, W), row shards): kitti at 2 shards, both
# models in one world of 2; matterport at 4, whose middle ranks have a seam
# on each side, in a world of 4.  Every rank on the one card over gloo.
SPATIAL_CASES = (("footprint_kitti", "footprint", 4, (HEIGHT, WIDTH), 2),
                 ("segmentor_kitti", "segmentor", 4, (HEIGHT, WIDTH), 2),
                 ("footprint_matterport", "footprint", 2, MATTERPORT_HW, 4))
SPATIAL_SEED = 30_000
SPATIAL_TIMED_STEPS = 3
HALO_SPANS = ("exchange_rows", "gather_rows")
# every case also trains, in f32 and in bf16 (matterport's middle ranks
# adjoin at both seams); the exchanges' backward spans beside the forward ones
SPATIAL_TRAIN_COMPUTE = ("float32", "bfloat16")
HALO_TRAIN_SPANS = HALO_SPANS + ("exchange_rows.backward", "gather_rows.backward")
# the bf16 rule's floor at a gradient leaf: each rank's gradient of a bf16
# parameter copy is rounded to bf16 before the f32 all-reduce, once a rank
# (tests/test_torch_spatial_train.py:BF16_LEAF_FLOOR)
BF16_LEAF_FLOOR = 2.0 ** -8
BF16_HEADS = {"compute_dtype": "bfloat16", "s2d_head": True, "p4_head": True}


def spatial_net(model, device):
    """The seeded FootprintNetwork-34 or Segmentor-34 (PSP) on `device`."""
    g = torch.Generator().manual_seed(SEED)
    net = (FootprintNetwork(34, device=device, generator=g) if model == "footprint"
           else Segmentor(34, True, device=device, generator=g))
    return net.eval()


def spatial_batch(model, n, hw, seed):
    """A seeded host batch: noise images and the model's eval targets."""
    rng = np.random.RandomState(seed)
    h, w = hw

    def mask(p):
        return (rng.rand(n, h, w) < p).astype(np.float32)

    batch = {"image": rng.rand(n, h, w, 3).astype(np.float32)}
    if model == "segmentor":
        return {**batch, "ground_mask": mask(0.5), "labelled_pix": mask(0.8)}
    return {**batch, "depth": (rng.rand(n, h, w) * 20 * mask(0.7)).astype(np.float32),
            "visible_ground": mask(0.5), "all_ground": mask(0.6),
            "ground_depth": (rng.rand(n, h, w) * 15 * mask(0.5)).astype(np.float32),
            "depth_mask": mask(0.4), "moving_object_mask": mask(0.2)}


def spatial_eval_steps(model, net, mesh):
    """{name: eval_fn} of the model's eval steps on `mesh` (None: one
    process): f32, and for the FootprintNetwork bf16 with the packed heads."""
    if model == "segmentor":
        return {"f32": seg_trainer.build_eval_step(net, mesh)}
    return {"f32": build_eval_step(net, TrainStepConfig(), mesh),
            "bf16": build_eval_step(net, TrainStepConfig(**BF16_HEADS), mesh)}


def spatial_forward(model, net, image, mesh):
    """The '1/1' map of the f32 forward (this rank's rows on a mesh)."""
    with torch.no_grad(), shard_rows(net, mesh):
        out = net(image, scales=("1/1",))
    return (out["1/1"] if model == "footprint" else out[0]).cpu().numpy()


class KernelCalls:
    """While active, records each launch of the kernel (its inputs and
    output, copied) through fused_conv._launch, which the op's forward looks
    up at every call."""

    def __enter__(self):
        self.calls, self._launch = [], fc._launch

        def launch(x, w, b, r, pad_mode, act):
            y = self._launch(x, w, b, r, pad_mode, act)
            self.calls.append(([None if t is None else t.clone() for t in (x, w, b, r)],
                               pad_mode, act, y.clone()))
            return y

        fc._launch = launch
        return self

    def __exit__(self, *exc):
        fc._launch = self._launch


def seam_site_check(calls):
    """Each recorded launch (on a row shard extended by its seam rows)
    against the plain version on the same inputs, at phase sites' bars: f32
    1e-4 + 1e-4|ref|; bf16 2e-2 + 2e-2|ref| against the f32 plain version
    of the bf16-rounded inputs.  The launch itself is the main path's."""
    worst, ok, shapes = 0.0, True, []
    for inputs, pad_mode, act, y in calls:
        x = inputs[0]
        tol = 1e-4 if x.dtype == torch.float32 else 2e-2
        ref = fused_conv3x3_plain(*[None if t is None else t.float() for t in inputs],
                                  pad_mode=pad_mode, act=act)
        diff = (y.float() - ref).abs()
        ok = ok and bool(torch.isfinite(y).all()) and bool((diff <= tol + tol * ref.abs()).all())
        worst = max(worst, diff.max().item())
        shapes.append([pad_mode, list(x.shape)])
    return {"max_abs_err": worst, "ok": ok, "calls": len(calls), "inputs": shapes}


def spatial_times(step, batch, device):
    """The eval step's mean ms over SPATIAL_TIMED_STEPS after one warm-up
    (CUDA events on this process's stream, which the collectives
    synchronise), its peak allocated memory above what was allocated before
    it (weights and batch), and one profiled step's host time in the halo
    exchanges (dp_profiled over HALO_SPANS)."""
    step(batch)
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    ms = time_ms(lambda: step(batch), iters=SPATIAL_TIMED_STEPS, warmup=0)
    peak = torch.cuda.max_memory_allocated(device) - base
    prof = dp_profiled(lambda: step(batch), device, HALO_SPANS)
    return {"ms": ms, "peak_activation_gib": peak / 2 ** 30,
            "halo_host_ms": prof["all_reduce_spans_ms_union"],
            "halo_host_net_of_sync_ms": prof["all_reduce_net_of_sync_ms"],
            "profiled_wall_ms": prof["profiled_wall_ms"], "busy_ms_union": prof["busy_ms_union"]}


# (reflect-padded input, output channels) of decoder convs, whole at batch
# 4 and a row shard's (own rows + 2) at 2 and 3 shards of 192x640: the
# 1/4-scale ConvBlock convs (block3's post-concat conv1 and conv2, block4's
# pre-concat convs), then the '1/2' and '1/1' heads' convs
SPATIAL_CUDNN_SHAPES = (
    [((4, c, rows, WIDTH // 4 + 2), 64) for rows in (HEIGHT // 4 + 2, HEIGHT // 8 + 2,
                                                     HEIGHT // 12 + 2) for c in (128, 64)]
    + [((4, c, rows // scale + 2, WIDTH // scale + 2), 2) for scale, c in ((2, 64), (1, 32))
       for rows in (HEIGHT, HEIGHT // 2)])


def spatial_cudnn_probe():
    """cuDNN's f32 time (TF32 off) and peak memory above the start of
    decoder convs at the whole and the row-shard shapes, NCHW against
    channels_last (why nn/blocks.py:ConvBlock hands a row shard's padded
    inputs to cuDNN in channels_last, and OutConvBlock, the heads, NCHW)."""
    out = []
    for shape, co in SPATIAL_CUDNN_SHAPES:
        g = torch.Generator().manual_seed(SEED)
        x = torch.randn(shape, generator=g).cuda()
        w = torch.randn(co, shape[1], 3, 3, generator=g).cuda()
        row = {"x": list(shape), "w": list(w.shape)}
        for fmt, t in (("nchw", x), ("channels_last",
                                      x.contiguous(memory_format=torch.channels_last))):
            F.conv2d(t, w)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            row[f"{fmt}_ms"] = time_ms(lambda: F.conv2d(t, w), iters=5, warmup=1)
            row[f"{fmt}_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        out.append(row)
    return out


def spatial_train_step(model, compute, mesh, device):
    """spatial_net's seeded model in train mode, its optimizer and its train
    step on `mesh` (None: one process) with the forward in `compute`; the
    FootprintNetwork's bf16 step with the packed heads, as its trainer's
    default."""
    g = torch.Generator().manual_seed(SEED)
    if model == "footprint":
        net = FootprintNetwork(34, device=device, generator=g)
        heads = compute == "bfloat16"
        config = TrainStepConfig(compute_dtype=compute, s2d_head=heads, p4_head=heads)
    else:
        net = Segmentor(34, True, device=device, generator=g)
        config = TrainStepConfig()
    if mesh is not None:
        sync_batch_norm(net, mesh)
    optimizer = make_optimizer(net, config)
    if model == "footprint":
        return net, optimizer, build_train_step(net, optimizer, config, mesh)
    return net, optimizer, seg_trainer.build_train_step(
        net, optimizer, lambda s: 1e-4, SEG_DTYPES[compute], mesh)


def spatial_train_result(net, optimizer, step, batch, device, mesh=None):
    """One train step: its losses (the ranks' mean), the gradients before
    Adam and the BN running stats (f32; rank 0's, averaged, on a mesh), the
    replica digests after Adam (every rank's), the kernel's launches in the
    forward (read by a hook at the net's output) and in the rest of the
    step, and the exchanges made by the forward and the loss and by their
    backward."""
    counters = (lambda: (fused_conv3x3.launches, fused_conv3x3.bf16_launches,
                         exchange_rows.calls, exchange_rows.backward_calls,
                         fc.fused_conv3x3_dgrad.launches, fc.fused_conv3x3_wgrad.launches,
                         fc.fused_conv3x3_dgrad.bf16_launches,
                         fc.fused_conv3x3_wgrad.bf16_launches))
    start, at_output = counters(), []
    hook = net.register_forward_hook(lambda *args: at_output.append(counters()))
    metrics = step(0, batch)
    torch.cuda.synchronize(device)
    hook.remove()
    end, mid = counters(), at_output[0]
    counts = {"launches_forward": mid[0] - start[0], "launches_backward": end[0] - mid[0],
              "bf16_launches": end[1] - start[1], "exchanges_forward": end[2] - start[2],
              "exchanges_backward": end[3] - start[3],
              "bwd_launches": {"fused_conv3x3_dgrad": [end[4] - start[4], end[6] - start[6]],
                               "fused_conv3x3_wgrad": [end[5] - start[5], end[7] - start[7]]}}
    if mesh is None:
        return {"losses": {k: float(v) for k, v in metrics.items() if k != "lr"},
                "grads": {n: p.grad.detach().float().cpu().numpy()
                          for n, p in net.named_parameters() if p.grad is not None},
                "stats": {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()
                          if "running" in k}, **counts}
    return {**dp_summary(mesh, net, optimizer, metrics, None), **counts}


def spatial_train_times(step, batch, device):
    """The train step's ms (one step, CUDA events; it follows the check
    step, which met cuDNN's first calls), its peak allocated memory above
    the allocation before it (weights, Adam's state, the batch), and one
    profiled step's host time in the exchanges, forward and backward
    (dp_profiled over HALO_TRAIN_SPANS)."""
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    ms = time_ms(lambda: step(1, batch), iters=1, warmup=0)
    peak = torch.cuda.max_memory_allocated(device) - base
    prof = dp_profiled(lambda: step(2, batch), device, HALO_TRAIN_SPANS)
    return {"ms": ms, "peak_gib": peak / 2 ** 30,
            "halo_host_ms": prof["all_reduce_span_ms"],
            "halo_host_ms_union": prof["all_reduce_spans_ms_union"],
            "halo_host_net_of_sync_ms": prof["all_reduce_net_of_sync_ms"],
            "profiled_wall_ms": prof["profiled_wall_ms"], "busy_ms_union": prof["busy_ms_union"]}


def spatial_train(model, batch, device, mesh=None):
    """The f32 and bf16 train steps of `model` from the seeded weights on
    `batch` (this rank's shard on a mesh), and the f32 step's times."""
    out = {}
    for compute in SPATIAL_TRAIN_COMPUTE:
        net, optimizer, step = spatial_train_step(model, compute, mesh, device)
        out[compute] = spatial_train_result(net, optimizer, step, batch, device, mesh)
        if compute == "float32":
            out["times"] = spatial_train_times(step, batch, device)
        del net, optimizer, step
    return out


def spatial_rank(mesh, cases):
    """Each case on this rank's shard of its batch: every eval step (its
    losses, the kernel's launches in it, the exchanges, and the kernel's
    calls against the plain version), the rows of the f32 '1/1' map, and the
    f32 step's times; then the train steps (spatial_train).  Ranks are
    spawned processes that import this file."""
    out = {}
    for case, model, host in cases:
        net = spatial_net(model, mesh.device)
        local = shard_batch(mesh, host)
        got = {"rows": local["image"].shape[1]}
        for name, step in spatial_eval_steps(model, net, mesh).items():
            before = (fused_conv3x3.launches, fused_conv3x3.bf16_launches, exchange_rows.calls)
            with KernelCalls() as calls:
                losses = step(local)
                torch.cuda.synchronize(mesh.device)
            got[name] = {"losses": {k: float(v) for k, v in losses.items()},
                         "launches": fused_conv3x3.launches - before[0],
                         "bf16_launches": fused_conv3x3.bf16_launches - before[1],
                         "exchanges": exchange_rows.calls - before[2],
                         "seam_sites": seam_site_check(calls.calls)}
        before = fused_conv3x3.launches
        got["1/1"] = spatial_forward(model, net, local["image"], mesh)
        got["forward_launches"] = fused_conv3x3.launches - before
        got["times"] = spatial_times(spatial_eval_steps(model, net, mesh)["f32"], local,
                                     mesh.device)
        del net
        got["train"] = spatial_train(model, local, mesh.device, mesh)
        out[case] = got
    return out


def spatial_single(model, host):
    """The same case in this process, unsharded, on the card."""
    net = spatial_net(model, "cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    steps = spatial_eval_steps(model, net, None)
    out = {name: {k: float(v) for k, v in step(batch).items()} for name, step in steps.items()}
    out["1/1"] = spatial_forward(model, net, batch["image"], None)
    out["times"] = spatial_times(steps["f32"], batch, torch.device("cuda"))
    del net, steps
    out["train"] = spatial_train(model, batch, torch.device("cuda"))
    return out


def spatial_train_checks(fail, case, model, n, hw, got, ref, spatial, smi):
    """phase_spatial's checks of the row-sharded train steps (`got`: the
    ranks' spatial_train, `ref`: the one-process one); emits the
    spatial_train and spatial_train_times lines and returns the kernel's
    launches in the check steps."""
    per_forward = launches_per_forward(model)
    f32, single = got[0]["float32"], ref["float32"]
    grads = {k: torch.from_numpy(v) for k, v in f32["grads"].items()}
    single_grads = {k: torch.from_numpy(v) for k, v in single["grads"].items()}
    loss_err = max(abs(f32["losses"][k] - v) for k, v in single["losses"].items())
    fail.check(sorted(f32["losses"]) == sorted(single["losses"]) and all(
        abs(f32["losses"][k] - v) <= 1e-5 + 1e-5 * abs(v) for k, v in single["losses"].items()),
        f"spatial train {case}: f32 losses {loss_err} from the single process")
    leaf, worst = worst_grad_leaf(grads, single_grads)
    fail.check(grads.keys() == single_grads.keys() and worst < 2e-2,
               f"spatial train {case}: gradient leaf {leaf} {worst} from the single process")
    bn_err = max(float(np.abs(f32["stats"][k] - v).max()) for k, v in single["stats"].items())
    fail.check(bn_err <= 1e-5, f"spatial train {case}: BN running stats {bn_err} off")
    checks = {"losses_max_abs_err": loss_err, "worst_grad_leaf": [leaf, worst],
              "bn_stats_max_abs_err": bn_err}
    launches = 0
    for compute in SPATIAL_TRAIN_COMPUTE:
        ranks = [g[compute] for g in got]
        digests = {d for r in ranks for d in r["digests"]}
        fail.check(len(digests) == 1, f"spatial train {case} {compute}: replicas differ")
        counts = [[r["launches_forward"], r["launches_backward"], r["bf16_launches"]]
                  for r in ranks]
        bf16 = per_forward if compute == "bfloat16" else 0
        fail.check(counts == [[per_forward, 0, bf16]] * spatial,
                   f"spatial train {case} {compute}: launches (forward, backward, bf16) "
                   f"a rank {counts}")
        launches += sum(c[0] + c[1] for c in counts)
        bwd = check_bwd_counts(fail, f"spatial train {case} {compute}",
                               [r["bwd_launches"] for r in ranks], 1, per_forward,
                               bf16=compute == "bfloat16")
        checks[compute] = {"launches_forward_backward_bf16_per_rank": counts,
                           "backward_kernel_launches_per_rank": bwd,
                           "exchanges_forward_backward_per_rank": [
                               [r["exchanges_forward"], r["exchanges_backward"]]
                               for r in ranks]}
    bf16, single_bf16 = got[0]["bfloat16"], ref["bfloat16"]
    gaps = {k: (abs(bf16["losses"][k] - v), abs(single_bf16["losses"][k] - v))
            for k, v in single["losses"].items()}
    fail.check(all(own <= 2 * one + 1e-3 for own, one in gaps.values()),
               f"spatial train {case}: bf16 loss gaps to the f32 step {gaps}")
    own = {k: torch.from_numpy(v) for k, v in bf16["grads"].items()}
    one = {k: torch.from_numpy(v) for k, v in single_bf16["grads"].items()}
    whole = (whole_rel(own, single_grads), whole_rel(one, single_grads))
    leaves = {k: (worst_grad_leaf({k: own[k]}, {k: v})[1],
                  worst_grad_leaf({k: one[k]}, {k: v})[1]) for k, v in single_grads.items()}
    bad = {k: g for k, g in leaves.items() if g[0] > 2 * g[1] + BF16_LEAF_FLOOR}
    fail.check(whole[0] <= 2 * whole[1] and not bad,
               f"spatial train {case}: bf16 gradient gaps to the f32 step, whole {whole}, "
               f"leaves over the rule {bad}")
    checks["bf16_gaps_to_f32"] = {
        "worst_loss": max(g[0] for g in gaps.values()),
        "single_worst_loss": max(g[1] for g in gaps.values()),
        "whole_gradient": whole[0], "single_whole_gradient": whole[1],
        "worst_leaf": max(leaves.items(), key=lambda kv: kv[1][0])}
    emit("spatial_train", case=case, model=f"{model}-34", batch=n, shape=list(hw),
         spatial=spatial, world=spatial, reference="the same step in one process on the card",
         loss_bar="1e-5 + 1e-5|ref|", grad_bar=2e-2, bn_bar=1e-5,
         bf16_rule="<= 2 x the one-process bf16 step's gap + 1e-3 (loss), + 2^-8 (leaf); "
                   "whole gradient <= 2 x", **checks)
    emit("spatial_train_times", case=case, card=smi, batch=n, shape=list(hw), spatial=spatial,
         single_process=ref["times"], ranks=[g["times"] for g in got],
         method="f32 train step, one step after the check step (CUDA events); peak "
                "allocated above the allocation before the step; the exchanges' host "
                "spans, forward and backward, from one profiled step", claim=None)
    return launches


def phase_spatial(fail, smi):
    """Row-sharded eval of both models over ranks on the one card (gloo):
    each case's losses on every rank against the single-process eval on the
    card (1e-5 + 1e-5|ref|), the gathered '1/1' map (MAE < 1e-4), the
    kernel's launches per rank per forward on the route of its dtype, every
    seam call against the plain version, the FootprintNetwork's bf16 eval
    (packed heads) no farther from the f32 eval than twice the single
    process's bf16 eval + 1e-3; then times, memory and the exchanges
    (no claim), beside cuDNN's times at the shard shapes of the decoder's
    1/4-scale convs (spatial_cudnn_probe); then each case's train steps
    (spatial_train_checks).  Returns (the kernel's launches
    on the paths driven here, the worst f32 seam-site error)."""
    emit("spatial_cudnn_probe", card=smi, convs=spatial_cudnn_probe(),
         method="F.conv2d f32, TF32 off, mean of 5 after 1 (CUDA events); peak allocated "
                "above the start")
    hosts = {case: spatial_batch(model, n, hw, SPATIAL_SEED + i)
             for i, (case, model, n, hw, _) in enumerate(SPATIAL_CASES)}
    launches, worst = 0, 0.0
    for spatial in sorted({c[4] for c in SPATIAL_CASES}):
        cases = [c for c in SPATIAL_CASES if c[4] == spatial]
        t0 = time.perf_counter()
        try:
            ranks = spawn(spatial, spatial_rank, [(c[0], c[1], hosts[c[0]]) for c in cases],
                          device="cuda", backend="gloo", spatial=spatial, timeout=600)
        except RuntimeError as e:
            fail.check(False, f"spatial {spatial}: a rank failed: {e}")
            continue
        seconds = time.perf_counter() - t0
        for case, model, n, hw, _ in cases:
            got = [r[case] for r in ranks]
            ref = spatial_single(model, hosts[case])
            per_forward = launches_per_forward(model)
            f32 = [g["f32"] for g in got]
            fail.check(all(g["losses"] == f32[0]["losses"] for g in f32),
                       f"spatial {case}: the ranks' losses differ")
            loss_err = max(abs(f32[0]["losses"][k] - v) for k, v in ref["f32"].items())
            fail.check(sorted(f32[0]["losses"]) == sorted(ref["f32"]) and all(
                abs(f32[0]["losses"][k] - v) <= 1e-5 + 1e-5 * abs(v)
                for k, v in ref["f32"].items()),
                f"spatial {case}: f32 losses {loss_err} from the single process")
            whole = np.concatenate([g["1/1"] for g in got], 1)
            mae = float(np.abs(whole - ref["1/1"]).mean()) if whole.shape == ref[
                "1/1"].shape else float("inf")
            fail.check(mae < 1e-4, f"spatial {case}: '1/1' MAE {mae} to the single process")
            routes = {"f32": [(g["f32"]["launches"], g["f32"]["bf16_launches"]) for g in got]}
            fail.check(routes["f32"] == [(per_forward, 0)] * spatial
                       and [g["forward_launches"] for g in got] == [per_forward] * spatial,
                       f"spatial {case}: f32 launches per rank {routes['f32']}")
            checks = {"losses_max_abs_err": loss_err, "out_1_1_mae": mae}
            if "bf16" in ref:
                bf16 = [g["bf16"] for g in got]
                routes["bf16"] = [(b["launches"], b["bf16_launches"]) for b in bf16]
                fail.check(routes["bf16"] == [(per_forward, per_forward)] * spatial,
                           f"spatial {case}: bf16 launches per rank {routes['bf16']}")
                gaps = {k: (abs(bf16[0]["losses"][k] - v), abs(ref["bf16"][k] - v))
                        for k, v in ref["f32"].items()}
                fail.check(all(b["losses"] == bf16[0]["losses"] for b in bf16)
                           and all(own <= 2 * single + 1e-3 for own, single in gaps.values()),
                           f"spatial {case}: bf16 gaps to the f32 eval {gaps}")
                checks["bf16_worst_gap_to_f32"] = max(own for own, _ in gaps.values())
                checks["single_bf16_worst_gap_to_f32"] = max(s for _, s in gaps.values())
            seams = {name: [g[name]["seam_sites"] for g in got] for name in routes}
            for name, per_rank in seams.items():
                fail.check(all(c["ok"] and c["calls"] == per_forward for c in per_rank),
                           f"spatial {case} {name}: seam sites {per_rank}")
            worst = max(worst, *(c["max_abs_err"] for c in seams["f32"]))
            launches += sum(g["forward_launches"] + sum(g[name]["launches"] for name in routes)
                            for g in got)
            emit("spatial", case=case, model=f"{model}-34", batch=n, shape=list(hw),
                 spatial=spatial, world=spatial, backend="gloo", device="cuda:0 (all ranks)",
                 rows_per_rank=[g["rows"] for g in got], loss_bar="1e-5 + 1e-5|ref|",
                 mae_bar=1e-4, **checks, launches_per_rank=routes,
                 exchanges_per_eval_step=[g["f32"]["exchanges"] for g in got],
                 seam_sites={name: [{"max_abs_err": c["max_abs_err"], "inputs": c["inputs"]}
                                    for c in per_rank] for name, per_rank in seams.items()},
                 seconds_spawn=seconds)
            emit("spatial_times", case=case, card=smi, batch=n, shape=list(hw),
                 spatial=spatial, single_process=ref["times"],
                 ranks=[g["times"] for g in got],
                 method="f32 eval step, mean of 3 after 1 (CUDA events); peak allocated "
                        "above the allocation before the step; the exchanges' host spans "
                        "from one profiled step", claim=None)
            launches += spatial_train_checks(fail, case, model, n, hw,
                                             [g["train"] for g in got], ref["train"],
                                             spatial, smi)
    return launches, worst


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
    # the probe's library (phase probe) builds beside the main one
    probe_pool = ThreadPoolExecutor(1)
    probe_build = probe_pool.submit(build.build_probe)
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
    timed("profile", phase_profile, fail, net)
    del net
    with tempfile.TemporaryDirectory() as workdir:
        train_launches, host, epoch, run = timed("train", phase_train, fail, workdir)
        bwd_totals = timed("train_times", phase_train_times, fail, host, epoch)
        timed("probe", phase_probe, fail, probe_build)
        probe_pool.shutdown()
        bf16_launches, f32_check = timed("train_bf16", phase_train_bf16, fail, run, workdir)
        train_launches += bf16_launches
        timed("train_bf16_times", phase_train_bf16_times, fail, host, run)
        dp_launches = timed("dp", phase_dp, fail, run, workdir, host, f32_check)
        spatial_launches, spatial_worst = timed("spatial", phase_spatial, fail, smi)
        export_launches, a16, export_weights = timed("export", phase_export, fail, workdir)
        timed("export_times", phase_export_times, fail, workdir, a16, export_weights, run)
    with tempfile.TemporaryDirectory() as workdir:
        dump_launches = timed("dump", phase_dump, fail, workdir)
        seg_launches = timed("seg_dump", phase_seg_dump, fail, workdir)
    with tempfile.TemporaryDirectory() as workdir:
        seg_train_launches, seg_host, timed_trainer = timed(
            "seg_train", phase_seg_train, fail, workdir)
        bf16_rows = timed("seg_train_times", phase_seg_train_times, fail, seg_host,
                           timed_trainer)
    with tempfile.TemporaryDirectory() as workdir:
        gt_runs = timed("gt", phase_gt, fail, workdir)
        timed("gt_times", phase_gt_times, fail, gt_runs, smi)
    # the FootprintNetwork's bf16 training runs the Segmentor decoder's sites
    # in each of its decoders
    bf16_step = backward_totals(bf16_rows, "footprint")
    emit("train_bf16_times", kernel=KERNEL["name"], route=ROUTES[torch.bfloat16],
         batch=TRAIN_BATCH, launches_per_step_forward=launches_per_forward("footprint"),
         forward_ms_per_step=bf16_step["forward_ms_per_step"],
         backward_ms_per_step=bf16_step["backward_ms_per_step"],
         library_backward_ms_per_step=bf16_step["library_backward_ms_per_step"],
         backward_kernels_ms_per_step={k["name"]: bf16_step[k["name"]]["ms"]
                                       for k in BWD_KERNELS},
         source="phase seg_train_times' per-site bf16 times at batch 12, at the "
                "FootprintNetwork's calls a site")
    launches += (train_launches + dp_launches + spatial_launches + export_launches
                 + dump_launches + seg_launches + seg_train_launches)
    max_abs = max(max_abs, spatial_worst)
    fail.check(all(n > 0 for n in BWD_LAUNCHES.values()),
               f"the training paths launched the backward kernels {BWD_LAUNCHES} times")
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
    # the backward kernels: their launches on the training paths, their
    # times per FootprintNetwork f32 step at batch 12 (a launch a site each)
    for k in BWD_KERNELS:
        t = bwd_totals[TRAIN_BATCH][k["name"]]
        kernels.append({**k, "launches": BWD_LAUNCHES[k["name"]],
                        **{key: t[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                   "bound_by", "library_ms")}})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
