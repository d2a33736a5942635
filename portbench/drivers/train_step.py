"""The FootprintNetwork's train step: ``train/step.py:build_train_step``
(forward with train-mode BN, the 4-scale loss, the backward through the
fused kernel's dgrad and wgrad, Adam and the StepLR schedule) on the
network and optimizer ``ModelManager`` builds, as the trainer drives it.

Set-up builds that one step, loads the seeded weights and drives it through
its first ``check_steps`` steps through the window's own call and feed: a
few seeded batches resident on the device, whose rows all differ, taken in
turn.  The window continues the same object.  The loader, validation and
logging of the trainer are outside the window.

The check follows those first steps with the plain reference: each step's
loss, the first gradient's norm by leaf (read from Adam's first moment
after one step, ``exp_avg = (1 - beta1) g``), and each state leaf's change
after the steps (parameters and BN running statistics).

Traffic parameters: ``batch``, ``batches`` (distinct batches in turn),
``check_steps``, ``steps_per_epoch`` (the StepLR's epoch), ``traced_steps``.
"""

import time

import torch

import compare
import devtrace
import flops
import harness
from harness import Measure, Outcome


def seeded_feed(config, seed, batch, batches, device):
    """``batches`` batches of ``batch`` rows: the image and the six target
    maps of the loss, drawn on ``device`` (masks as 0/1, depths in (0.1,
    80) m where valid and 0 elsewhere)."""
    gen = harness.generator(seed, "feed", device)
    h, w = config["height"], config["width"]

    def draw(p):
        return (torch.rand(batch, h, w, generator=gen, device=device) < p).float()

    def depth(p):
        return (0.1 + 79.9 * torch.rand(batch, h, w, generator=gen, device=device)) * draw(p)

    return [{"image": torch.rand(batch, h, w, 3, generator=gen, device=device),
             "visible_ground": draw(0.4), "all_ground": draw(0.5), "depth": depth(0.7),
             "ground_depth": depth(0.3), "depth_mask": draw(0.2),
             "moving_object_mask": draw(0.05)} for _ in range(batches)]


def program_step(config, traffic, seed, device):
    """(manager, step_fn): the network and Adam of ``ModelManager`` with the
    seeded weights, and the program's train step over them."""
    from footprints_tpu_torch.model_manager import ModelManager
    from footprints_tpu_torch.train import step

    manager = ModelManager(learning_rate=config["learning_rate"],
                           lr_step_size=config["scheduler_step_size"],
                           steps_per_epoch=traffic["steps_per_epoch"],
                           depth=config["encoder_depth"], device=device)
    manager.net.load_state_dict(harness.seeded_weights(config, seed, device), strict=True)
    return manager, step.build_train_step(manager.net, manager.optimizer, manager.config)


def run(ctx):
    config, traffic, device = ctx.cell.config, ctx.cell.traffic, ctx.device
    batch, n_check = traffic["batch"], traffic["check_steps"]
    feed = seeded_feed(config, ctx.seed, batch, traffic["batches"], device)
    manager, step_fn = program_step(config, traffic, ctx.seed, device)
    net, opt = manager.net, manager.optimizer
    start = {k: v.detach().clone() for k, v in net.state_dict().items()
             if v.is_floating_point()}
    beta1 = opt.param_groups[0]["betas"][0]
    losses, grads = [], None
    for s in range(n_check):
        losses.append(step_fn(s, feed[s % len(feed)])["loss"])
        if grads is None:
            # a trained leaf that Adam holds no moment of had no gradient
            grads = {n: float(opt.state[p]["exp_avg"].norm()) / (1 - beta1)
                     if p in opt.state else 0.0
                     for n, p in net.named_parameters() if p.requires_grad}
    changes = {k: float((v - start[k]).norm()) for k, v in net.state_dict().items()
               if k in start}
    program = ([float(v) for v in losses], grads, changes)
    del start
    harness.synchronize(device)
    peak_setup = harness.device_info(device, ctx.cell.chips)["memory_peak_bytes"]
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    deadline, steps = t0 + ctx.seconds, 0
    while time.perf_counter() < deadline:
        s = n_check + steps
        step_fn(s, feed[s % len(feed)])
        steps += 1
    harness.synchronize(device)
    window_s = time.perf_counter() - t0
    device_info = harness.device_info(device, ctx.cell.chips)
    peak_window = device_info["memory_peak_bytes"]
    device_info["memory_peak_bytes"] = max(peak_setup, peak_window)

    trace = None
    if ctx.trace:
        first = n_check + steps

        def traced():
            for s in range(first, first + traffic["traced_steps"]):
                step_fn(s, feed[s % len(feed)])

        trace = devtrace.profiled(traced, traffic["traced_steps"] * batch, device)
        device_info["memory_peak_bytes"] = max(
            device_info["memory_peak_bytes"],
            harness.device_info(device, ctx.cell.chips)["memory_peak_bytes"])

    del manager, net, opt, step_fn
    harness.free_device(device)
    checks = check(config, traffic, ctx.seed, feed, program, device)
    measure = Measure(cell=ctx.cell, window_s=window_s, units=steps * batch, trace=trace,
                      flops_per_unit=flops.train_flops(harness.reference_model(config),
                                                       config["height"], config["width"]),
                      peak_window_bytes=peak_window)
    return Outcome(attempted=steps * batch, failed=0,
                   end_to_end={"train_imgs_per_s": steps * batch / window_s},
                   window_start=t0, measure=measure, checks=checks, device=device_info)


def hyper(config):
    return {"learning_rate": config["learning_rate"], "betas": config["adam_betas"],
            "eps": config["adam_eps"]}


def check(config, traffic, seed, feed, program, device):
    reference = compare.train_reference(config, seed, feed, traffic["check_steps"],
                                        hyper(config), device)
    return compare.train_gaps(program, reference)


def control(ctx, indices=None):
    """The check's numbers with the reference in TF32 in the program's
    place, against the reference in f32."""
    config, traffic, device = ctx.cell.config, ctx.cell.traffic, ctx.device
    feed = seeded_feed(config, ctx.seed, traffic["batch"], traffic["batches"], device)
    low = compare.train_reference(config, ctx.seed, feed, traffic["check_steps"],
                                  hyper(config), device, tf32=True)
    return check(config, traffic, ctx.seed, feed, low, device)


def half_batch(ctx, indices=None):
    """A fault in the program's place: the reference's steps with each
    batch's second half left out (the loss and BN's statistics over the
    rest), against the reference over the whole batch."""
    config, traffic, device = ctx.cell.config, ctx.cell.traffic, ctx.device
    feed = seeded_feed(config, ctx.seed, traffic["batch"], traffic["batches"], device)
    half = [{k: v[:len(v) // 2] for k, v in b.items()} for b in feed]
    low = compare.train_reference(config, ctx.seed, half, traffic["check_steps"],
                                  hyper(config), device)
    return check(config, traffic, ctx.seed, feed, low, device)
