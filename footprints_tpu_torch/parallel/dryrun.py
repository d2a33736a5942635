"""Data-parallel dry run over n processes (the port's counterpart of
``__graft_entry__.py:dryrun_multichip``), and the spawner it runs on.

    python -c "from footprints_tpu_torch.parallel.dryrun import dryrun_multichip; \
               dryrun_multichip(2, device='cuda')"

``spawn(n, fn, ...)`` starts n processes, joins them in one gloo (or
NCCL) group on localhost, runs ``fn(mesh, *args)`` in each (``spatial=k``:
on ``make_mesh(spatial=k)``) and returns the ranks' results in rank
order.  A rank that raises, dies or outlives ``timeout`` fails the whole
call: the other ranks are terminated and the call raises with the rank's
traceback.  ``device="cuda"`` (the default; it raises without CUDA) puts
every rank on ``cuda:0`` (several ranks on one card need gloo: NCCL
refuses two ranks on one device); the CPU runs only when asked for, as the
tests do.

``dryrun_multichip`` runs one data-parallel FootprintNetwork step in f32,
then one in bf16 with the packed heads, their targets fed through the
compact transport and the trainer's put sequence (compact, copy, decode
with the packed keys), on a batch whose rows differ across ranks (2 images
a rank), so the gradient all-reduce and the global BN are load-bearing.
After each step every rank's params, BN buffers and Adam moments must be
bitwise equal to every other rank's.
"""

import queue as queue_lib
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..data.compact import BatchCompactor, decompact_on_device
from ..model_manager import ModelManager
from ..ops.fused_conv import fused_conv3x3, fused_conv3x3_dgrad, fused_conv3x3_wgrad
from ..train.losses import TARGET_KEYS
from ..train.step import TrainStepConfig, build_train_step
from ..utils import select_device
from .distributed import initialize, shutdown
from .mesh import (all_reduce_mean, make_mesh, replica_digest, replicate_tree, shard_batch,
                   sync_batch_norm)

SEED = 10
IMAGES_PER_RANK = 2


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, port, backend, device, spatial, fn, args, results):
    try:
        initialize(backend, f"tcp://localhost:{port}", n, rank, device=device)
        out = fn(make_mesh(device, spatial=spatial), *args)
        results.put((rank, None, out))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
    finally:
        shutdown()


def spawn(n, fn, *args, device="cuda", backend="gloo", timeout=900, spatial=1):
    """``fn(mesh, *args)`` in each of n new processes, on a mesh of
    ``spatial`` row shards; returns the results (picklable values: numpy,
    not tensors) in rank order.  Raises without CUDA unless ``device`` is
    the CPU."""
    device = select_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, port, backend, device, spatial, fn, args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < n:
            try:
                rank, error, value = results.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(f"rank(s) {dead} died" if dead else
                                       f"ranks {sorted(set(range(n)) - set(out))} "
                                       f"still running after {timeout} s")
                continue
            if error is not None:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{error}")
            out[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [out[r] for r in range(n)]


def dryrun_batch(n_images, height, width):
    """A deterministic batch whose rows differ (the ramp of
    __graft_entry__.py's dry run): the image on the u8/255 grid and
    ground_depth f16-representable, so the compact transport locks its
    real encodings."""
    ramp = (np.arange(n_images * height * width, dtype=np.float32) % 977.0) / np.float32(977.0)
    img = (np.rint(ramp * 255.0).astype(np.uint8).astype(np.float32)
           / np.float32(255.0)).reshape(n_images, height, width)
    image = np.stack([img, 1.0 - img, 0.5 * img], axis=-1)
    return {
        "image": np.rint(image * 255.0).astype(np.uint8).astype(np.float32) / np.float32(255.0),
        "depth": 1.0 + 9.0 * img,  # not f16-exact: passes through as f32
        "visible_ground": (img > 0.7).astype(np.float32),
        "all_ground": (img > 0.5).astype(np.float32),
        "ground_depth": (1.0 + 9.0 * img).astype(np.float16).astype(np.float32),
        "depth_mask": (img > 0.6).astype(np.float32),
        "moving_object_mask": (img < 0.1).astype(np.float32),
    }


def check_replicas(mesh, module, optimizer, what):
    """Raise unless every rank's replica digest equals rank 0's."""
    digests = [None] * mesh.world_size
    dist.all_gather_object(digests, replica_digest(module, optimizer), group=mesh.side_group)
    if len(set(digests)) != 1:
        raise RuntimeError(f"{what}: the replicas differ across ranks: {digests}")
    return digests[0]


def _step(mesh, batch, depth, config):
    mm = ModelManager(depth=depth, seed=SEED, steps_per_epoch=10, device=mesh.device)
    sync_batch_norm(mm.net, mesh)
    replicate_tree(mesh, mm.net)
    step = build_train_step(mm.net, mm.optimizer, config, mesh)
    counts = (lambda: [fused_conv3x3.launches, fused_conv3x3.bf16_launches]
              + [n for f in (fused_conv3x3_dgrad, fused_conv3x3_wgrad)
                 for n in (f.launches, f.bf16_launches)])
    before = counts()
    metrics = step(0, batch)
    loss = float(all_reduce_mean(mesh, metrics["loss"]))
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    d = [a - b for a, b in zip(counts(), before)]
    return {"loss": loss, "digest": check_replicas(mesh, mm.net, mm.optimizer, config),
            "launches": d[0], "bf16_launches": d[1],
            # the backward kernels': [launches, bf16 launches] each
            "bwd_launches": {"fused_conv3x3_dgrad": d[2:4], "fused_conv3x3_wgrad": d[4:6]}}


def _dryrun_rank(mesh, height, width, depth):
    host = dryrun_batch(IMAGES_PER_RANK * mesh.world_size, height, width)
    f32 = _step(mesh, shard_batch(mesh, host), depth, TrainStepConfig(steps_per_epoch=10))

    # the trainer's bf16 default: packed heads, their targets packed by the
    # device decode of the compact transport
    compactor = BatchCompactor("exact")
    compact = compactor({k: v[mesh.rank * IMAGES_PER_RANK:(mesh.rank + 1) * IMAGES_PER_RANK]
                         for k, v in host.items()})
    for key, enc in (("image", "u8_image"), ("all_ground", "u8"),
                     ("ground_depth", "f16x"), ("depth", None)):
        if compactor.scheme[key] != enc:
            raise RuntimeError(f"compact transport not load-bearing: {key} locked "
                               f"{compactor.scheme[key]!r}, expected {enc!r}")
    batch = decompact_on_device({k: torch.from_numpy(np.ascontiguousarray(v)).to(mesh.device)
                                 for k, v in compact.items()},
                                compactor.scheme, TARGET_KEYS, TARGET_KEYS)
    bf16 = _step(mesh, batch, depth, TrainStepConfig(
        steps_per_epoch=10, compute_dtype="bfloat16", s2d_head=True, p4_head=True))
    return {"f32": f32, "bf16": bf16}


def dryrun_multichip(n, *, device="cuda", height=192, width=640, depth=34):
    """One f32 and one bf16 packed-head data-parallel step over ``n`` ranks,
    replicas checked bitwise after each.  Returns the ranks' results: per
    step the global loss, the replica digest and this rank's kernel
    launches (all and bf16), the backward kernels' in ``bwd_launches``."""
    results = spawn(n, _dryrun_rank, height, width, depth, device=device)
    print(f"dryrun_multichip({n}): ok, loss={results[0]['f32']['loss']:.4f} (f32) / "
          f"{results[0]['bf16']['loss']:.4f} (bf16, packed heads), replicas bitwise equal")
    return results
