"""The Segmentor's train step: ``preprocessing/segmentation/trainer.py:
build_train_step`` (forward with train-mode BN, the PSP, the 4-scale seg
loss, the backward through the fused kernel's dgrad and wgrad, Adam and
the StepLR schedule) on the network, optimizer and schedule that the
segmentation ``Trainer`` builds, as the trainer drives it.

Set-up builds that one step, loads the seeded weights and drives it through
its first ``check_steps`` steps through the window's own call and feed: a
few seeded batches resident on the device, whose rows all differ, taken in
turn.  The window continues the same object.  The loader, validation and
logging of the trainer are outside the window.

The check follows those first steps with the plain reference
(``reference/segmentor_r50.py:train_steps``) and compares them as the
FootprintNetwork's train cells do (``compare.train_gaps``): the first
step's loss, the first gradient's norm by leaf (read from Adam's first
moment after one step, ``exp_avg = (1 - beta1) g``), and each state leaf's
change after the steps (parameters and BN running statistics).

Traffic parameters: ``batch``, ``batches`` (distinct batches in turn),
``check_steps``, ``steps_per_epoch`` (the StepLR's epoch), ``traced_steps``.
The configuration's ``assumed.feed_shares`` gives the share of pixels
drawn as ground and as labelled.
"""

import time

import torch

import compare
import devtrace
import flops
import harness
from harness import Measure, Outcome
from reference.segmentor_r50 import train_steps


def seeded_feed(config, seed, batch, batches, device):
    """``batches`` batches of ``batch`` rows: the image in [0, 1) and the
    loss's ground mask and labelled pixels as 0/1 draws, on ``device``."""
    gen = harness.generator(seed, "feed", device)
    h, w = config["height"], config["width"]
    shares = config["assumed"]["feed_shares"]

    def draw(p):
        return (torch.rand(batch, h, w, generator=gen, device=device) < p).float()

    return [{"image": torch.rand(batch, h, w, 3, generator=gen, device=device),
             "ground_mask": draw(shares["ground_mask"]),
             "labelled_pix": draw(shares["labelled_pix"])} for _ in range(batches)]


def program_step(config, traffic, seed, device):
    """(net, optimizer, step_fn): the Segmentor, Adam and StepLR schedule as
    the segmentation ``Trainer`` builds them, with the seeded weights, and
    the program's seg train step over them."""
    from footprints_tpu_torch.models import Segmentor
    from footprints_tpu_torch.preprocessing.segmentation import trainer
    from footprints_tpu_torch.train import step
    from footprints_tpu_torch.utils import select_device

    net = Segmentor(depth=config["encoder_depth"], use_psp=config["use_psp"],
                    device=select_device(device))
    net.load_state_dict(harness.seeded_weights(config, seed, device), strict=True)
    step_config = step.TrainStepConfig(learning_rate=config["learning_rate"],
                                       scheduler_step_epochs=config["scheduler_step_size"],
                                       scheduler_gamma=config["scheduler_gamma"],
                                       steps_per_epoch=traffic["steps_per_epoch"])
    optimizer = step.make_optimizer(net, step_config)
    return net, optimizer, trainer.build_train_step(net, optimizer,
                                                    step.make_lr_schedule(step_config))


def run(ctx):
    config, traffic, device = ctx.cell.config, ctx.cell.traffic, ctx.device
    batch, n_check = traffic["batch"], traffic["check_steps"]
    feed = seeded_feed(config, ctx.seed, batch, traffic["batches"], device)
    net, opt, step_fn = program_step(config, traffic, ctx.seed, device)
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

    del net, opt, step_fn
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


def train_reference(config, seed, feed, steps, device, tf32=False):
    """The reference's first ``steps`` steps from the seeded weights, with
    TF32 on or off."""
    harness.f32_policy(tf32)
    try:
        return train_steps(compare.reference_net(config, seed, device), feed, steps,
                           hyper(config))
    finally:
        harness.f32_policy(False)


def check(config, traffic, seed, feed, program, device):
    reference = train_reference(config, seed, feed, traffic["check_steps"], device)
    return compare.train_gaps(program, reference)


def control(ctx, indices=None):
    """The check's numbers with the reference in TF32 in the program's
    place, against the reference in f32."""
    config, traffic, device = ctx.cell.config, ctx.cell.traffic, ctx.device
    feed = seeded_feed(config, ctx.seed, traffic["batch"], traffic["batches"], device)
    low = train_reference(config, ctx.seed, feed, traffic["check_steps"], device, tf32=True)
    return check(config, traffic, ctx.seed, feed, low, device)


def half_batch(ctx, indices=None):
    """A fault in the program's place: the reference's steps with each
    batch's second half left out (the loss and BN's statistics over the
    rest), against the reference over the whole batch."""
    config, traffic, device = ctx.cell.config, ctx.cell.traffic, ctx.device
    feed = seeded_feed(config, ctx.seed, traffic["batch"], traffic["batches"], device)
    half = [{k: v[:len(v) // 2] for k, v in b.items()} for b in feed]
    low = train_reference(config, ctx.seed, half, traffic["check_steps"], device)
    return check(config, traffic, ctx.seed, feed, low, device)
