"""Serving one image a call: ``predict_simple``'s predictor
(``InferenceManager._predict_batch``: numpy in, the '1/1' forward, numpy
out, the sigmoid on the mask channels) at batch 1, as ``predict_arrays``
runs it without its file writes.  One closed-loop client sends the next
preprocessed image when the last answer is back; each request is timed
from the call to its numpy result.

The predictor's checkpoint is replaced by the cell's seeded weights; its
image decoding and resize, and its writes, are outside the window.

Traffic parameters: ``pool_frames``, ``keep_one_in``, ``check_images``,
``reference_block``, ``warmup_requests``, ``traced_requests``.
"""

import tempfile
import time

import numpy as np

import compare
import devtrace
import flops
import harness
from harness import Measure, Outcome


def predictor(config, manager, save_dir):
    """The program's predictor, its checkpoint replaced by ``manager``."""
    from footprints_tpu_torch.predict_simple import InferenceManager

    class Predictor(InferenceManager):
        def _load_model(self, model_name, model_load_folder, device, height, width):
            self.model_manager, self.device = manager, manager.device
            self.height, self.width = height, width

    return Predictor(None, save_dir, save_visualisations=False, height=config["height"],
                     width=config["width"], apply_sigmoid=True, batch_size=1,
                     device=str(manager.device))


def run(ctx):
    config, traffic, device = ctx.cell.config, ctx.cell.traffic, ctx.device
    frames = list(harness.seeded_frames(config, ctx.seed, traffic["pool_frames"],
                                        device).cpu().numpy())
    manager = harness.program_model(config, harness.seeded_weights(config, ctx.seed, device),
                                    device)
    keep = harness.kept_indices(ctx.seed, traffic["keep_one_in"])
    with tempfile.TemporaryDirectory() as save_dir:
        serve = predictor(config, manager, save_dir)
        for r in range(traffic["warmup_requests"]):
            serve._predict_batch([frames[r % len(frames)]])

        latencies, kept = [], {}
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        while time.perf_counter() < deadline:
            r = len(latencies)
            start = time.perf_counter()
            out = serve._predict_batch([frames[r % len(frames)]])
            latencies.append(time.perf_counter() - start)
            if r in keep:
                kept[r] = out
        window_s = time.perf_counter() - t0

        trace = None
        if ctx.trace:
            def traced():
                for r in range(traffic["traced_requests"]):
                    serve._predict_batch([frames[r % len(frames)]])

            trace = devtrace.profiled(traced, traffic["traced_requests"], device)
        device_info = harness.device_info(device, ctx.cell.chips)
        del serve, manager
    harness.free_device(device)

    chosen = harness.sample(ctx.seed, kept, traffic["check_images"])
    checks = {"max_gap": None}
    if chosen:
        ref = compare.reference_maps(config, ctx.seed,
                                     harness.frames_of(config, traffic, ctx.seed, chosen, device),
                                     traffic["reference_block"], device)
        checks["max_gap"] = compare.max_gap(np.concatenate([kept[r] for r in chosen]), ref)
    measure = Measure(cell=ctx.cell, window_s=window_s, units=len(latencies), trace=trace,
                      flops_per_unit=flops.forward_flops(harness.reference_model(config),
                                                         config["height"], config["width"],
                                                         all_heads=False))
    return Outcome(attempted=len(latencies), failed=0,
                   end_to_end={"predict_p95_ms": float(np.percentile(latencies, 95)) * 1e3},
                   window_start=t0, measure=measure, checks=checks, device=device_info)


def control(ctx, indices):
    """The check's number with the reference in TF32 in the program's place."""
    config, traffic, device = ctx.cell.config, ctx.cell.traffic, ctx.device
    frames = harness.frames_of(config, traffic, ctx.seed, indices, device)
    block = traffic["reference_block"]
    low = compare.reference_maps(config, ctx.seed, frames, block, device, tf32=True)
    ref = compare.reference_maps(config, ctx.seed, frames, block, device)
    return {"max_gap": compare.max_gap(low, ref)}
