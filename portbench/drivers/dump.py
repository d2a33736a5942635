"""The batch dump: the test-split dump of ``main --mode inference``
(FootprintNetwork: ``eval/inference.py:InferenceManager.run``) or the
segmentation Tester's ground_seg dump (Segmentor: ``preprocessing/
segmentation/inference.py:Tester.test``), both the program's
``dump_predictions`` loop with the card computing batch n+1 while the host
saves batch n.

The CLI's options, checkpoint, split files and image decoding are
replaced by the cell's seeded model, an in-memory loader that cycles a
seeded pool of frames, and a dataset whose ``save_result`` serialises each
prediction with ``np.save`` into memory (the files would fill the
machine's disk) and keeps the bytes of a seeded sample for the check.

Traffic parameters: ``batch``, ``pool_frames`` (a multiple of ``batch``),
``keep_one_in`` (the density of the kept sample), ``check_images``,
``reference_block``, ``warmup_batches``, ``traced_batches``.
"""

import io
import time
import types

import numpy as np
import torch

import compare
import devtrace
import flops
import harness
from harness import Measure, Outcome


class PoolLoader:
    """Batches of the pool in turn, each {'image': [B,H,W,3] f32 numpy,
    'idx': its images' running numbers}, until ``deadline`` (host clock) or
    ``batches`` batches."""

    def __init__(self, pool, deadline=None, batches=None, start=0):
        self.pool, self.deadline, self.batches, self.start = pool, deadline, batches, start
        self.yielded = 0

    def __iter__(self):
        batch = len(self.pool[0])
        while ((self.deadline is None or time.perf_counter() < self.deadline)
               and (self.batches is None or self.yielded < self.batches)):
            n = self.start + self.yielded * batch
            self.yielded += 1
            yield {"image": self.pool[(n // batch) % len(self.pool)],
                   "idx": list(range(n, n + batch))}

    def images(self):
        return self.yielded * len(self.pool[0])


class MemorySink:
    """The dump's dataset: ``save_result`` serialises a prediction as the
    program's datasets write it (``np.save``), into memory, and keeps the
    bytes of the images in ``keep``."""

    def __init__(self, keep):
        self.keep, self.kept, self.saved = keep, {}, 0

    def save_result(self, index, prediction, savepath, visualisation=None):
        buf = io.BytesIO()
        np.save(buf, prediction)
        self.saved += 1
        if int(index) in self.keep:
            self.kept[int(index)] = buf.getvalue()


def dumper(config, model, sink, batch, device):
    """The program's dump manager for the configuration, its options,
    checkpoint and split replaced by the cell's model, loader and sink."""
    opt = types.SimpleNamespace(batch_size=batch, save_test_visualisations=False)
    if config["model"] == "FootprintNetwork":
        from footprints_tpu_torch.eval.inference import InferenceManager

        class Dumper(InferenceManager):
            def __init__(self):
                self.opt, self.savepath, self.model_manager = opt, "", model
                self.device, self.dataset = model.device, sink

            def dump(self, loader):
                self.loader = loader
                return self.run(overlap=True)

        return Dumper()
    from footprints_tpu_torch.preprocessing.segmentation.inference import Tester

    class SegDumper(Tester):
        def __init__(self):
            self.opt, self.save_path, self.net = opt, "", model
            self.device, self.dataset = torch.device(device), sink

        def dump(self, loader):
            self.loader = loader
            return self.test(overlap=True)

    return SegDumper()


def pool_frames(config, traffic, seed, device):
    frames = harness.seeded_frames(config, seed, traffic["pool_frames"], device)
    return frames.cpu().numpy()


def run(ctx):
    config, traffic, device = ctx.cell.config, ctx.cell.traffic, ctx.device
    batch = traffic["batch"]
    frames = pool_frames(config, traffic, ctx.seed, device)
    pool = [frames[i:i + batch] for i in range(0, len(frames), batch)]
    model = harness.program_model(config, harness.seeded_weights(config, ctx.seed, device),
                                  device)
    sink = MemorySink(harness.kept_indices(ctx.seed, traffic["keep_one_in"]))
    manager = dumper(config, model, sink, batch, device)
    # the warm-up's images are numbered past any the window can reach, so
    # none of them enters the check
    warm = PoolLoader(pool, batches=traffic["warmup_batches"], start=1 << 40)
    manager.dump(warm)
    harness.synchronize(device)

    t0 = time.perf_counter()
    loader = PoolLoader(pool, deadline=t0 + ctx.seconds)
    done = manager.dump(loader)
    window_s = time.perf_counter() - t0
    saved_in_window = sink.saved - warm.images()

    trace = None
    if ctx.trace:
        traced = PoolLoader(pool, batches=traffic["traced_batches"], start=1 << 41)
        trace = devtrace.profiled(lambda: manager.dump(traced),
                                  traffic["traced_batches"] * batch, device)
    device_info = harness.device_info(device, ctx.cell.chips)

    kept = {i: sink.kept[i] for i in sink.kept if i < loader.images()}
    del manager, model, sink
    harness.free_device(device)
    checks = check(config, traffic, ctx.seed, kept, device)
    model_ref = harness.reference_model(config)
    measure = Measure(cell=ctx.cell, window_s=window_s, units=done, trace=trace,
                      flops_per_unit=flops.forward_flops(model_ref, config["height"],
                                                         config["width"], all_heads=False))
    return Outcome(attempted=loader.images(), failed=loader.images() - saved_in_window,
                   end_to_end={"dump_imgs_per_s": done / window_s},
                   window_start=t0, measure=measure, checks=checks, device=device_info)


def check(config, traffic, seed, kept, device):
    """The widest gap, past float16's rounding, of the served float16 maps
    of a seeded sample of the window's images from the reference's f32
    maps."""
    chosen = harness.sample(seed, kept, traffic["check_images"])
    if not chosen:
        return {"excess_gap": None}
    got = np.stack([np.load(io.BytesIO(kept[i])) for i in chosen])
    ref = compare.reference_maps(config, seed, harness.frames_of(config, traffic, seed, chosen, device),
                                 traffic["reference_block"], device)
    return {"excess_gap": compare.excess_gap(got.reshape(ref.shape), ref)}


def control(ctx, indices):
    """The check's number with the reference in TF32, served in float16 as
    the program serves, in the program's place, on the images ``indices``."""
    config, traffic, device = ctx.cell.config, ctx.cell.traffic, ctx.device
    frames = harness.frames_of(config, traffic, ctx.seed, indices, device)
    block = traffic["reference_block"]
    low = compare.reference_maps(config, ctx.seed, frames, block, device, tf32=True)
    ref = compare.reference_maps(config, ctx.seed, frames, block, device)
    return {"excess_gap": compare.excess_gap(low.astype(np.float16), ref)}
