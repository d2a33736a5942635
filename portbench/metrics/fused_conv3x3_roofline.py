"""The fused kernel's share of its roofline, in %: the least time of its
work in the traced stretch (flops.fused_bound_s over the sites that
flops.sites reads from the cell's reference model: the forward at each, and
in a train step dgrad and wgrad at each) over the device time of its
launches (the weight pre-pack and the main kernel; in a train step also
dgrad's two and wgrad's two).  Nothing when no launch of it was traced."""

import flops
import harness

KERNELS = ("fused_conv3x3",)  # every device kernel of the three ops has it in its name


def read(m):
    if m.trace is None:
        return None
    busy_ns = sum(e - s for s, e, name, _ in m.trace.device if any(k in name for k in KERNELS))
    if busy_ns == 0:
        return None
    config, traffic = m.cell.config, m.cell.traffic
    batch = traffic["batch"]
    bound_s = flops.fused_bound_s(harness.reference_model(config, "meta"), batch,
                                  config["height"], config["width"], config["dtype"],
                                  backward=traffic["driver"] == "train_step")
    return 100.0 * bound_s / batch * m.trace.units / (busy_ns / 1e9)
