"""The traced stretch: ``torch.profiler`` around a callable, read from the
profiler's raw events into device intervals, the host's spans, the union
of the device's busy time, its idle gaps, and the breakdown the result line
carries.

The device is busy while at least one operation runs on it; at batch 12
cuDNN runs one conv as thousands of kernels on several streams at once, so
busy time is the union of their intervals, never their sum.
"""

import dataclasses

import torch

WINDOW_SPAN = "portbench.traced"
BREAKDOWN_ENTRIES = 10


@dataclasses.dataclass
class Trace:
    window: tuple  # (start_ns, end_ns) of the traced stretch on the trace's clock
    device: list  # (start_ns, end_ns, name, stream) of every device operation
    host: list  # (start_ns, end_ns, name) of every host-side event
    units: int  # images the stretch computed (a request is one image)

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e9

    def clipped(self, spans):
        lo, hi = self.window
        return [(max(s, lo), min(e, hi)) for s, e, *_ in spans if e > lo and s < hi]

    def busy_s(self, spans=None):
        """Seconds of the stretch in which one of ``spans`` (all device
        operations by default) ran: the union of their intervals."""
        return union_ns(self.clipped(self.device if spans is None else spans)) / 1e9

    def kernels(self):
        """The device operations that are kernels (no copies or memsets)."""
        return [d for d in self.device if not d[2].startswith(("Memcpy", "Memset"))]


def union_ns(intervals):
    """Length of the union of (start, end) intervals: overlaps count once."""
    total, reach = 0, float("-inf")
    for start, end in sorted(intervals):
        total += max(0, end - max(start, reach))
        reach = max(reach, end)
    return total


def gaps_ns(intervals, lo, hi):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, reach = [], lo
    for start, end in sorted(intervals):
        if start > reach:
            out.append((reach, min(start, hi)))
        reach = max(reach, end)
        if reach >= hi:
            break
    if reach < hi:
        out.append((reach, hi))
    return [(s, e) for s, e in out if e > s]


def profiled(fn, units, device="cuda"):
    """Run ``fn()`` once under the profiler, from one synchronise to the
    next, and return its ``Trace`` (on the CPU: the host's events alone)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            fn()
            sync()
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns(), e.end_ns(), e.name())
        if e.device_type() == DeviceType.CUDA:
            device.append(span + (e.device_resource_id(),))
        elif e.name() == WINDOW_SPAN:
            window = span[:2]
        else:
            host.append(span)
    if window is None:
        raise RuntimeError("the profiler recorded no span of the traced stretch")
    # a host span (record_function) is mirrored on the device's timeline as
    # an annotation over the kernels it launched: no operation of its own
    named_on_host = {name for _, _, name in host} | {WINDOW_SPAN}
    device = [d for d in device if d[2] not in named_on_host]
    return Trace(window=window, device=device, host=host, units=units)


def host_activity(trace, start, end):
    """What the host was doing at the middle of [start, end]: the outermost
    and the innermost of its events that cover that moment."""
    mid = (start + end) // 2
    covering = sorted((e - s, name) for s, e, name in trace.host if s <= mid <= e)
    if not covering:
        return "python, between ops"
    inner, outer = covering[0][1], covering[-1][1]
    return inner if inner == outer else f"{outer} > {inner}"


def breakdown(trace):
    """The device operations that took most time (summed by name) and the
    longest idle gaps of the stretch, each named by the host's activity."""
    by_name = {}
    for start, end, name, _ in trace.device:
        by_name[name[:120]] = by_name.get(name[:120], 0) + (end - start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    gaps = gaps_ns(trace.clipped(trace.device), *trace.window)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:BREAKDOWN_ENTRIES]
    return {"device_ops": [[name, ns / 1e9] for name, ns in ops],
            "idle_gaps": [[host_activity(trace, s, e), (e - s) / 1e9] for s, e in gaps]}


def kernel_category(name):
    """Coarse bucket of a device kernel's name (the port's smoke script's
    buckets: the fused kernel's three, cuDNN's convs by direction, BN, the
    optimizer, copies, pads, elementwise)."""
    n = name.lower()
    for kernel in ("fused_conv3x3_dgrad", "fused_conv3x3_wgrad", "fused_conv3x3"):
        if kernel in n:
            return kernel
    if "dgrad" in n or "wgrad" in n or "fft" in n or any(
            k in n for k in ("fprop", "convolve", "implicit_gemm", "xmma",
                             "pointwise_mult_and_sum")):
        return "cudnn conv"
    if any(k in n for k in ("bn_", "batch_norm", "batchnorm", "welford")):
        return "batch norm"
    if "multi_tensor_apply" in n or "adam" in n:
        return "adam (foreach)"
    if any(k in n for k in ("copy", "cat", "nhwctonchw", "nchwtonhwc", "transpose")):
        return "copies / layout"
    if any(k in n for k in ("reflection_pad", "upsample")):
        return "pads / upsample"
    return "other"


def category_spans(trace, categories):
    return [d for d in trace.device if kernel_category(d[2]) in categories]
