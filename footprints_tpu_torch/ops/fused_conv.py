"""Fused pad -> 3x3 conv -> bias -> [residual] -> activation (counterpart of
footprints_tpu/ops/pallas_conv.py).

``fused_conv3x3`` is the wrapper of the hand-written CUDA kernel in
``csrc/fused_conv3x3.cu``.  On a CUDA tensor it launches the kernel (or
raises); only for a CPU tensor does it run ``fused_conv3x3_plain``, the
plain PyTorch version of the same function.  ``fused_conv3x3.launches``
counts kernel launches, so a run can show that the decoder went through the
kernel (``fused_conv3x3.bf16_launches``: those of the bf16 route).

Layout: activations are NHWC-contiguous ``[N,H,W,C]`` (the model's
channels_last NCHW tensors permuted, a view), weights are the
``nn.Conv2d`` OIHW ``[Co,Ci,3,3]``: contiguous, or an input-channel slice
of a contiguous OIHW tensor (strides ``(s, 9, 3, 1)`` with ``s >= 9 Ci``),
which the kernel reads through ``w.stride(0)``.

pad_mode:
  * ``'reflect'``      conv3x3(reflect_pad(x, 1)); output [N,H,W,Co]
  * ``'up2_reflect'``  conv3x3(reflect_pad(nearest_up_2x(x), 1)); input
    [N,Hi,Wi,Ci], output [N,2Hi,2Wi,Co].  Neither the upsampled nor the
    padded tensor is materialised: output row i, tap dy reads low-res row
    clamp(floor((i+dy-1)/2), 0, Hi-1) (the edge-pad identity of
    footprints_tpu/ops/upconv.py).
act: ``'elu'`` or ``'none'``; the optional residual [N,Ho,Wo,Co] is added
before it.  f32 and bf16 I/O; f32 accumulation (a CPU tensor may also be
f64, for f64 reference runs of the plain version).  The kernel runs on the
tensor cores: bf16 products for bf16, and for f32 the error-compensated
3xTF32 split (three TF32 products per MAC), held to the same f32 bars as a
true-f32 conv.  At ``'up2_reflect'`` it computes each of the 4 output
phases as a 2x2 conv on the edge-padded low-res input with phase-summed
weights; ``up2_phase_weights`` and ``up2_phase_conv_plain`` are the plain
PyTorch spec of that identity (no path calls them).

The kernel is a registered custom op, ``footprints::fused_conv3x3``
(``fused_conv3x3_op``), so ``torch.export`` carries it into a serving
program (export.py): its CUDA implementation launches the kernel, its CPU
implementation is the plain version, and its fake implementation gives the
output's shape to a trace.  The launch counters count at run time only.

Gradients: ``fused_conv3x3`` itself records no autograd graph.  The three
model-facing wrappers (``up_conv_fused``, ``conv_reflect_fused``,
``conv_reflect_res_fused``) call the op, whose registered autograd is the
counterpart of the JAX package's ``custom_vjp``s (pallas_conv.py:208-276):
the forward is the kernel (the plain version on a CPU tensor), the backward
is the VJP of the plain composition, as there: cuDNN's dgrad and wgrad
(``aten.convolution_backward``) on the padded input, then the adjoints of
the reflect pad and of the nearest x2 upsample.  ELU's derivative comes from
the saved output: ``min(y, 0) + 1``.  No backward kernel is hand-written,
since the TPU kernel has none either.
"""

import ctypes
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from ..nn.layers import conv2d, elu, reflect_pad, upsample_nearest

PAD_MODES = ("reflect", "up2_reflect")
ACTS = ("none", "elu")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_conv3x3_plain(x, w, b=None, residual=None, *, pad_mode, act):
    """Plain PyTorch version of the kernel: same contract, NHWC in and out."""
    xc = x.permute(0, 3, 1, 2)
    if pad_mode == "up2_reflect":
        xc = upsample_nearest(xc, 2)
    y = conv2d(reflect_pad(xc, 1), w, b)
    if residual is not None:
        y = y + residual.permute(0, 3, 1, 2)
    if act == "elu":
        y = elu(y)
    return y.permute(0, 2, 3, 1).contiguous()


def up2_phase_weights(w):
    """OIHW ``[Co,Ci,3,3]`` -> ``[2,2,Co,Ci,2,2]``: the phase-summed 2x2
    kernel of output phase (a, b), exactly as the kernel folds it: rows
    summed first, then columns (footprints_tpu/ops/upconv.py:_phase_kernels).
    Phase 0 taps low-res (-1, 0) with (w0, w1+w2), phase 1 taps (0, +1) with
    (w0+w1, w2), in each dimension."""
    rows = [torch.stack([w[:, :, 0], w[:, :, 1] + w[:, :, 2]], 2),
            torch.stack([w[:, :, 0] + w[:, :, 1], w[:, :, 2]], 2)]
    return torch.stack([torch.stack(
        [torch.stack([r[..., 0], r[..., 1] + r[..., 2]], -1),
         torch.stack([r[..., 0] + r[..., 1], r[..., 2]], -1)]) for r in rows])


def up2_phase_conv_plain(x, w, b=None):
    """conv3x3(reflect_pad(nearest_up_2x(x))) + b as 4 x (2x2 VALID conv on
    the edge-padded low-res input), phases interleaved.  x NHWC [N,H,W,Ci],
    w OIHW [Co,Ci,3,3] -> NHWC [N,2H,2W,Co]."""
    n, h, w_, _ = x.shape
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                                 mode="replicate")
    k = up2_phase_weights(w)
    out = torch.stack([torch.stack([
        conv2d(xp[:, :, a:a + h + 1, pb:pb + w_ + 1], k[a, pb], b)
        for pb in range(2)]) for a in range(2)])      # [2,2,N,Co,H,W]
    return out.permute(2, 4, 0, 5, 1, 3).reshape(n, 2 * h, 2 * w_, -1)


def _check(x, w, b, residual, pad_mode, act):
    """Raise on what the kernel does not take; returns the sizes.  Reads
    only shapes, strides, dtypes and devices, so it also runs on the fake
    tensors of a trace."""
    if pad_mode not in PAD_MODES:
        raise ValueError(f"pad_mode must be one of {PAD_MODES}, got {pad_mode!r}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if x.dtype not in _DTYPE_CODES and not (x.dtype == torch.float64
                                            and x.device.type == "cpu"):
        raise TypeError(f"fused_conv3x3 takes float32 or bfloat16 (and float64 "
                        f"on the CPU, plain version only), got {x.dtype} on {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous NHWC tensor, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    n, h, w_, ci = x.shape
    if pad_mode == "reflect" and (h < 2 or w_ < 2):
        raise ValueError(f"reflect padding needs H, W >= 2, got {h}x{w_}")
    if (w.dim() != 4 or w.shape[1:] != (ci, 3, 3) or w.stride()[1:] != (9, 3, 1)
            or w.stride(0) < 9 * ci):
        raise ValueError(f"w must be an OIHW [Co,{ci},3,3] tensor, contiguous or "
                         f"an input-channel slice of one, got shape "
                         f"{tuple(w.shape)} strides {w.stride()}")
    co = w.shape[0]
    ho, wo = (h, w_) if pad_mode == "reflect" else (2 * h, 2 * w_)
    if w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"w is {w.dtype} on {w.device}; x is {x.dtype} on {x.device}")
    named = []
    if b is not None:
        named.append(("b", b, (co,)))
    if residual is not None:
        named.append(("residual", residual, (n, ho, wo, co)))
    for name, t, shape in named:
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous with shape {shape}, got "
                             f"{tuple(t.shape)} strides {t.stride()}")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; x is "
                             f"{x.dtype} on {x.device}")
    return n, h, w_, ci, ho, wo, co


def fused_conv3x3(x, w, b=None, residual=None, *, pad_mode, act):
    """act(conv3x3(pad(x), w) + b [+ residual]), NHWC; see the module doc.
    Records no autograd graph."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b, residual)):
        raise RuntimeError("fused_conv3x3 records no autograd graph; "
                           "differentiate through up_conv_fused, "
                           "conv_reflect_fused or conv_reflect_res_fused")
    return _forward(x, w, b, residual, pad_mode, act)


fused_conv3x3.launches = 0
fused_conv3x3.bf16_launches = 0  # of them, launches of the bf16 route


# The op that torch.export carries (footprints::fused_conv3x3).  Importing
# this module registers it; a saved program that calls it loads only after
# that import.  It is defined through torch.library's low-level API, not
# torch.library.custom_op, whose generated autograd layer sends every call
# through the dispatcher into Python twice.  On real tensors the wrappers
# and the op's Autograd kernel call the device implementation directly, so
# an eager training step pays no dispatch at its launches (chip_smoke.py's
# phase times reads the host cost per call beside the bare launch's); a
# trace (fake or functional tensors, or a dispatch mode) goes through the
# op and reaches its fake implementation.  needs_exact_strides: block4's
# weight halves reach it as input-channel slice views, which the kernel
# reads through their strides.
_LIB = torch.library.Library("footprints", "DEF")
_LIB.define("fused_conv3x3(Tensor x, Tensor w, Tensor? b, Tensor? residual, "
            "str pad_mode, str act) -> Tensor", tags=(torch.Tag.needs_exact_strides,))
fused_conv3x3_op = torch.ops.footprints.fused_conv3x3.default


def _plain(x, w, b, residual, pad_mode, act):
    """The CPU implementation: the plain version."""
    _check(x, w, b, residual, pad_mode, act)
    return fused_conv3x3_plain(x, w, b, residual, pad_mode=pad_mode, act=act)


def _launch(x, w, b, residual, pad_mode, act):
    """The CUDA implementation: one launch of the kernel, or a raise."""
    n, h, w_, ci, ho, wo, co = _check(x, w, b, residual, pad_mode, act)
    from .build import load_library

    lib = load_library()
    y = torch.empty((n, ho, wo, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_conv3x3_launch(
            _DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(), w.stride(0),
            None if b is None else b.data_ptr(),
            None if residual is None else residual.data_ptr(), y.data_ptr(),
            n, h, w_, ci, ho, wo, co, PAD_MODES.index(pad_mode),
            ACTS.index(act), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fused_conv3x3 launch failed: CUDA error {err}")
    fused_conv3x3.launches += 1
    fused_conv3x3.bf16_launches += x.dtype == torch.bfloat16
    return y


def _fake(x, w, b, residual, pad_mode, act):
    """The output's shape and type, for tracing; counts nothing."""
    n, _, _, _, ho, wo, co = _check(x, w, b, residual, pad_mode, act)
    return x.new_empty((n, ho, wo, co))


def _forward(x, w, b, residual, pad_mode, act):
    """The op's forward below autograd: the device implementation itself on
    real tensors, the dispatched op (its fake implementation) in a trace."""
    if (type(x) is torch.Tensor and not torch._is_functional_tensor(x)
            and _get_current_dispatch_mode() is None):
        return (_launch if x.is_cuda else _plain)(x, w, b, residual, pad_mode, act)
    with torch._C._AutoDispatchBelowAutograd():
        return fused_conv3x3_op(x, w, b, residual, pad_mode, act)


class _FusedConv3x3(torch.autograd.Function):
    """The op's autograd: forward through the device implementation, the
    VJP of the plain composition backward."""

    @staticmethod
    def forward(ctx, x, w, b, residual, pad_mode, act):
        y = _forward(x, w, b, residual, pad_mode, act)
        ctx.pad_mode = pad_mode
        ctx.save_for_backward(x, w, y if act == "elu" else None)
        return y

    @staticmethod
    def backward(ctx, gy):
        """Gradients (x, w, b, residual) of act(conv3x3(pad(x)) + b
        [+ residual]), None where that input needs none; the residual's is
        the pre-activation gradient.  gy: NHWC [N,Ho,Wo,Co]."""
        x, w, y = ctx.saved_tensors
        need_x, need_w, need_b, need_r = ctx.needs_input_grad[:4]
        gz = gy if y is None else gy * (y.clamp(max=0) + 1)
        gx = gw = None
        if need_x or need_w:
            up = ctx.pad_mode == "up2_reflect"
            xu = x.permute(0, 3, 1, 2)
            if up:
                xu = upsample_nearest(xu, 2)
            gxp, gw, _ = torch.ops.aten.convolution_backward(
                gz.permute(0, 3, 1, 2), reflect_pad(xu, 1), w, None, (1, 1),
                (0, 0), (1, 1), False, (0, 0), 1, (need_x, need_w, False))
            if need_x:
                gx = torch.ops.aten.reflection_pad2d_backward(
                    gxp, xu, (1, 1, 1, 1)).permute(0, 2, 3, 1)
                if up:  # adjoint of pixel replication: sum each 2x2 block
                    n, h, w_, c = x.shape
                    gx = gx.reshape(n, h, 2, w_, 2, c).sum((2, 4))
        gb = gz.sum((0, 1, 2)) if need_b else None
        return gx, gw, gb, gz if need_r else None, None, None


def _fused(x, w, b, residual, pad_mode, act):
    """The op's Autograd kernel, and the wrappers' entry: records the
    Function only where a gradient is wanted."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b, residual)):
        return _FusedConv3x3.apply(x, w, b, residual, pad_mode, act)
    return _forward(x, w, b, residual, pad_mode, act)


_LIB.impl("fused_conv3x3", _plain, "CPU")
_LIB.impl("fused_conv3x3", _launch, "CUDA")
_LIB.impl("fused_conv3x3", _fused, "Autograd")
torch.library.register_fake("footprints::fused_conv3x3", _fake, lib=_LIB)


# The three wrappers mirror the JAX package's one for one
# (footprints_tpu/ops/pallas_conv.py: up_conv_s2d_fused, s2d_conv_res_fused,
# s2d_conv_fused), in plain full-resolution NHWC instead of s2d layout.
#
# ``halo`` = (above, below): on a row shard (parallel/halo.py), the rows by
# which x extends this rank's rows with its neighbours' at a seam (0 at the
# image's true edge).  The kernel runs unchanged, in its own reflect mode,
# on the extended x: output rows that read past x's ends are wrong at a
# seam (a reflection of the neighbour's row where the image goes on), and
# are dropped, 1 per halo row at 'reflect' and 2 at 'up2_reflect'; no kept
# row reads them.  At the image's edge the reflection is the image's own.

def crop_rows(y, above, below):
    """NHWC ``y`` without its first ``above`` and last ``below`` rows."""
    if above == below == 0:
        return y
    return y[:, above:y.shape[1] - below]


def up_conv_fused(x, w, b, act="elu", halo=(0, 0)):
    """act(conv3x3(reflect_pad(nearest_up_2x(x))) + b): [N,H,W,C] -> [N,2H,2W,Co]."""
    return crop_rows(_fused(x, w, b, None, "up2_reflect", act), 2 * halo[0], 2 * halo[1])


def conv_reflect_fused(x, w, b, act="elu", halo=(0, 0)):
    """act(conv3x3(reflect_pad(x)) + b)."""
    return crop_rows(_fused(x, w, b, None, "reflect", act), *halo)


def conv_reflect_res_fused(x, w, b, residual, act="elu", halo=(0, 0)):
    """act(conv3x3(reflect_pad(x)) + b + residual) (block4 post conv1); the
    residual covers x's rows, halo included."""
    return crop_rows(_fused(x, w, b, residual, "reflect", act), *halo)
