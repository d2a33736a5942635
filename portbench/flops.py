"""The yardstick's arithmetic: published peaks of one H100, the FLOPs of a
whole forward and train step from the reference model's shapes, and the
least time of the fused kernel's work at each of its call sites.

Everything is read from the configuration's own plain reference
(``harness.reference_model``), run on the meta device: the FLOPs from the
output shape of every conv, the fused kernel's call sites from the shapes
at the decoder blocks that the port runs on the kernel (its
``FUSED_BLOCKS``) and at each decoder's tail.  The arithmetic is copied
from the port's smoke script (``chip_smoke.py``: ``PEAK_*``, ``sites``,
``site_taps``, ``site_flops``, ``bounds``, ``bwd_bound``), where the sites
are a fixed list of ResNet-34's.  Operations are counted at the taps the
function needs: a 3x3 conv over a nearest-2x-upsampled input is, for each
of the 4 output phases, an exact 2x2 conv on the low-resolution input, so
it counts 4 taps an output, whatever an implementation computes.  f32 is
counted as 3 TF32 products a MAC on the tensor cores (the 3xTF32 split,
the fastest f32-accurate route on the card), so its peak is the TF32 peak
over 3.
"""

import torch
import torch.nn as nn

# H100 SXM, NVIDIA's data sheet, dense, at the 700 W power limit
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
TF32_PRODUCTS_PER_MAC = 3
# the peak an f32-accurate step can reach: 3xTF32 on the tensor cores
PEAK_F32_ACCURATE_FLOPS = PEAK_TF32_FLOPS / TF32_PRODUCTS_PER_MAC
PEAKS = {"float32": PEAK_F32_ACCURATE_FLOPS, "bfloat16": PEAK_BF16_FLOPS}
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}

# heads that a '1/1'-only forward (the dumps, serving) skips
SIDE_HEADS = ("outconv1.", "outconv2.", "outconv3.")


def _up_input_channels(name, conv):
    """Input channels of ``conv`` that arrive nearest-2x-upsampled: the first
    ``out_channels`` of a decoder block's post-concat conv1 (the upsampled
    pre-concat output, as wide as the block's output, concatenated before
    the skip, which may be wider), and all of the tail's conv1."""
    if name.endswith("post_concat_conv.conv1"):
        return conv.out_channels
    if name.endswith("outconv4.0.conv1"):
        return conv.in_channels
    return 0


def _hooked(model, shape, names):
    """{module name: (its input's shape, its output's shape)} for the
    modules ``names`` of ``model`` (on the meta device), in one forward of
    a ``shape`` input."""
    modules = dict(model.named_modules())
    seen = {}
    hooks = [modules[name].register_forward_hook(
        lambda m, i, o, name=name: seen.__setitem__(name, (tuple(i[0].shape),
                                                           tuple(o.shape))))
        for name in names]
    try:
        with torch.no_grad():
            model(torch.empty(shape, device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return seen


def conv_flops(model, height, width):
    """{module name: FLOPs of one image's forward} for every Conv2d of the
    reference ``model`` (built on the meta device), from the shapes a
    [1,3,height,width] input gives it; an upsampled input channel counts 4
    taps an output, every other a full kernel window."""
    convs = [name for name, m in model.named_modules() if isinstance(m, nn.Conv2d)]
    shapes = _hooked(model, (1, 3, height, width), convs)
    out = {}
    for name, m in model.named_modules():
        if name not in shapes:
            continue
        _, co, ho, wo = shapes[name][1]
        kh, kw = m.kernel_size
        up = _up_input_channels(name, m)
        per_output = (m.in_channels // m.groups - up) * kh * kw + up * 4
        out[name] = 2 * co * ho * wo * per_output
    return out


def forward_flops(model, height, width, all_heads):
    """FLOPs of one image's forward; ``all_heads`` False leaves out the side
    heads, which a '1/1'-only forward does not compute."""
    return sum(f for name, f in conv_flops(model, height, width).items()
               if all_heads or not any(h in name for h in SIDE_HEADS))


def train_flops(model, height, width):
    """FLOPs of one image's train step: the forward with every head, and in
    the backward the input gradient (dgrad) and the weight gradient (wgrad)
    of every conv, each as many as its forward, except the stem's dgrad (the
    image takes no gradient)."""
    convs = conv_flops(model, height, width)
    stem = next(iter(convs.values()))
    return 3 * sum(convs.values()) - stem


def sites(model, batch, height, width):
    """The fused kernel's call sites in one forward of the reference
    ``model`` (on the meta device) at ``batch`` x ``height`` x ``width``:
    [(name, pad_mode, input NHWC shape, Co, residual?, bias?)].

    The list is read from the model: for each decoder (a module with an
    ``outconv4``), the post-concat ConvBlock of each block that the port
    runs on the kernel (``FUSED_BLOCKS`` of
    ``footprints_tpu_torch/models/footprint.py``), as the port splits it
    (conv1's upsampled half; conv1's skip half, which adds the first as its
    residual, with the bias; conv2), then the tail ConvBlock's two convs
    (conv1 over the upsampled input).  Ci, Co and each spatial size come
    from the shapes hooked in that forward."""
    from footprints_tpu_torch.models.footprint import FUSED_BLOCKS

    decoders = [f"{name}." for name, m in model.named_modules() if hasattr(m, "outconv4")]
    shapes = _hooked(model, (batch, 3, height, width),
                     [name for name, _ in model.named_modules()
                      if name.startswith(tuple(decoders))])
    out = []
    for d in decoders:
        for i in FUSED_BLOCKS:
            block = f"{d}block{i}"
            _, (n, c_up, h, w) = shapes[f"{block}.pre_concat_conv"]
            (_, c_in, hs, ws), _ = shapes[f"{block}.post_concat_conv"]
            co1 = shapes[f"{block}.post_concat_conv.conv1"][1][1]
            co2 = shapes[f"{block}.post_concat_conv.conv2"][1][1]
            out += [
                (f"{block}.post.conv1.up_half", "up2_reflect", (n, h, w, c_up), co1, False, False),
                (f"{block}.post.conv1.skip_half", "reflect", (n, hs, ws, c_in - c_up), co1, True,
                 True),
                (f"{block}.post.conv2", "reflect", (n, hs, ws, co1), co2, False, True),
            ]
        (n, c, h, w), _ = shapes[f"{d}outconv4.0"]
        co1 = shapes[f"{d}outconv4.0.conv1"][1][1]
        co2 = shapes[f"{d}outconv4.0.conv2"][1][1]
        out += [
            (f"{d}tail.conv1", "up2_reflect", (n, h // 2, w // 2, c), co1, False, True),
            (f"{d}tail.conv2", "reflect", (n, h, w, co1), co2, False, True),
        ]
    return out


def site_taps(pad_mode):
    return 9 if pad_mode == "reflect" else 4


def site_out_hw(site):
    _, pad_mode, (_, h, w, _), _, _, _ = site
    return (h, w) if pad_mode == "reflect" else (2 * h, 2 * w)


def site_flops(site):
    _, pad_mode, (n, _, _, ci), co, _, _ = site
    ho, wo = site_out_hw(site)
    return 2 * site_taps(pad_mode) * ci * co * n * ho * wo


def _ops_seconds(flops, dtype):
    """Least time of ``flops`` in ``dtype``: f32 as 3 TF32 products a MAC on
    the tensor cores or as FMAs off them, whichever is less; bf16 one
    product on them."""
    if dtype == "float32":
        return min(flops / PEAK_F32_FLOPS,
                   TF32_PRODUCTS_PER_MAC * flops / PEAK_TF32_FLOPS)
    return flops / PEAK_BF16_FLOPS


def forward_bound_s(site, dtype):
    """Least time (s) of the site's forward: its operations, or its bytes
    (input, weight, bias, residual read once, output written once)."""
    _, _, (n, h, w, ci), co, residual, bias = site
    ho, wo = site_out_hw(site)
    es = ELEMENT_BYTES[dtype]
    nbytes = es * (n * h * w * ci + co * ci * 9 + (co if bias else 0)
                   + n * ho * wo * co * (2 if residual else 1))
    return max(_ops_seconds(site_flops(site), dtype), nbytes / PEAK_BYTES)


def backward_bound_s(site, dtype):
    """Least time (s) of one backward kernel at the site (dgrad or wgrad:
    the forward's MACs; dgrad reads gz and w and writes gx, wgrad reads gz
    and x and writes gw, each once: the same bytes for both)."""
    _, _, (n, h, w, ci), co, _, _ = site
    ho, wo = site_out_hw(site)
    nbytes = ELEMENT_BYTES[dtype] * (n * ho * wo * co + n * h * w * ci + co * ci * 9)
    return max(_ops_seconds(site_flops(site), dtype), nbytes / PEAK_BYTES)


def fused_bound_s(model, batch, height, width, dtype, backward):
    """Least time (s) of one batch's work of the fused kernel in the
    reference ``model``: the forward at each of its ``sites``, and with
    ``backward`` dgrad and wgrad at each too."""
    total = 0.0
    for site in sites(model, batch, height, width):
        total += forward_bound_s(site, dtype)
        if backward:
            total += 2 * backward_bound_s(site, dtype)
    return total
