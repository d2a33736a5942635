"""Fused pad -> 3x3 conv -> bias -> [residual] -> activation (counterpart of
footprints_tpu/ops/pallas_conv.py).

``fused_conv3x3`` is the wrapper of the hand-written CUDA kernel in
``csrc/fused_conv3x3.cu``.  On a CUDA tensor it launches the kernel (or
raises); only for a CPU tensor does it run ``fused_conv3x3_plain``, the
plain PyTorch version of the same function.  ``fused_conv3x3.launches``
counts kernel launches, so a run can show that the decoder went through the
kernel (``fused_conv3x3.bf16_launches``: those of the bf16 route); the
backward's kernels count theirs on ``fused_conv3x3_dgrad`` and
``fused_conv3x3_wgrad``.

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
PyTorch spec of that identity (no path calls them).  A call is two
launches, counted once: the weights pre-packed into the kernel's
shared-memory image (``fused_conv3x3_pack``, its plain version
``fused_conv3x3_pack_plain``), then the kernel.

The kernel is a registered custom op, ``footprints::fused_conv3x3``
(``fused_conv3x3_op``), so ``torch.export`` carries it into a serving
program (export.py): its CUDA implementation launches the kernel, its CPU
implementation is the plain version, and its fake implementation gives the
output's shape to a trace.  The launch counters count at run time only.

Gradients: ``fused_conv3x3`` itself records no autograd graph.  The three
model-facing wrappers (``up_conv_fused``, ``conv_reflect_fused``,
``conv_reflect_res_fused``) call the op, whose registered autograd is the
counterpart of the JAX package's ``custom_vjp``s (pallas_conv.py:208-276),
whose backwards are XLA compositions: the forward is the kernel, the
backward two more hand-written kernels (``csrc/fused_conv3x3_dgrad.cu``,
``csrc/fused_conv3x3_wgrad.cu``), each the wrapper of a registered op
(``footprints::fused_conv3x3_dgrad`` / ``_wgrad``) with its plain version
beside it and its own launch counters:
  * ``fused_conv3x3_dgrad(gz, w)``: the gradient on x, (pad o [up2])^T of
    the transposed conv, straight to x's layout; 'reflect' in the gather
    form with the pad's border folds, 'up2_reflect' in the phase form (the
    4 output phases' 2x2 transposed convs with ``up2_phase_weights``, then
    the edge pad's adjoint), as ops/s2d.py:_edge_conv_phase_bwd does.  A
    call is two launches: the weights pre-packed into the kernel's
    shared-memory image (``fused_conv3x3_dgrad_pack``, its plain version
    ``fused_conv3x3_dgrad_pack_plain`` with the TF32 split
    ``tf32_split_plain``), then the kernel;
  * ``fused_conv3x3_wgrad(gz, x)``: the gradient on w, the reduction over
    N H W split into fixed partial sums (no atomics: the same bits every
    run); 'up2_reflect' in the phase form, folded back to 3x3 by
    ``up2_phase_weights_adjoint``.
``gz`` is the pre-activation cotangent: ELU's derivative comes from the
saved output, ``gy * (min(y, 0) + 1)`` (one pass of ``aten.elu_backward``),
in torch, as do the bias's gradient (``gz`` summed) and the residual's
(``gz``).  The backward launches dgrad only when x needs a gradient and
wgrad only when w does; on a CPU tensor it runs the plain versions (f32
sums, f64 for f64).  Neither backward op is differentiable (no double
backward).
"""

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable
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


# (phase, tap) of up2_phase_weights -> the 3x3 rows (columns) summed into it
_PHASE_TAP_ROWS = {(0, 0): (0,), (0, 1): (1, 2), (1, 0): (0, 1), (1, 1): (2,)}


def up2_phase_weights_adjoint(g):
    """The adjoint of ``up2_phase_weights``: ``[2,2,Co,Ci,2,2]`` ->
    ``[Co,Ci,3,3]``.  Each 3x3 tap takes every phase tap it was summed into
    (columns first, then rows)."""
    cols = [[0] * 3 for _ in range(2)]  # [a][dx]: [Co,Ci,2 (ty)]
    for a in range(2):
        for (b, tx), dxs in _PHASE_TAP_ROWS.items():
            for dx in dxs:
                cols[a][dx] = cols[a][dx] + g[a, b, ..., tx]
    out = [[0] * 3 for _ in range(3)]
    for (a, ty), dys in _PHASE_TAP_ROWS.items():
        for dy in dys:
            for dx in range(3):
                out[dy][dx] = out[dy][dx] + cols[a][dx][..., ty]
    return torch.stack([torch.stack(row, -1) for row in out], -2)


def _pad_adjoint(gp, mode):
    """Adjoint of the 1-pixel 'reflect' or 'edge' pad of the two spatial
    dims of NHWC ``gp`` [N,H+2,W+2,C] -> [N,H,W,C]: the border rows and
    columns fold onto the rows they were copied from (rows first)."""
    for dim in (1, 2):
        inner = gp.narrow(dim, 1, gp.shape[dim] - 2).clone()
        lo, hi = (1, -2) if mode == "reflect" else (0, -1)
        inner.select(dim, lo).add_(gp.select(dim, 0))
        inner.select(dim, hi).add_(gp.select(dim, -1))
        gp = inner
    return gp


def _pad_index(n, mode, device):
    """Source index of each of the n + 2 padded positions."""
    i = torch.arange(-1, n + 1, device=device)
    if mode == "reflect":
        return i.abs().where(i < n, 2 * n - 2 - i)
    return i.clamp(0, n - 1)


def _acc_dtype(t):
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def fused_conv3x3_dgrad_plain(gz, w, *, pad_mode):
    """Plain PyTorch version of the dgrad kernel: the gradient on x of
    conv3x3(pad(x), w) (no bias, residual or activation: ``gz`` is the
    pre-activation cotangent), NHWC [N,Ho,Wo,Co] -> [N,H,W,Ci] in gz's dtype,
    summed in f32 (f64 for f64).  'reflect': each pixel of the padded grid
    gathers its taps from the zero-padded cotangent, then the reflect pad's
    border rows and columns fold back (rows 1 and H-2 take two).
    'up2_reflect', the phase form: each output phase's cotangent through
    its 2x2 phase-summed weights onto the edge-padded low-res grid, then the
    edge pad's adjoint."""
    acc = _acc_dtype(gz)
    g, k = gz.to(acc), w.to(acc)
    n, ho, wo, _ = g.shape
    if pad_mode == "reflect":
        gp = F.pad(g, (0, 0, 2, 2, 2, 2))
        out = sum(gp[:, 2 - dy:ho + 4 - dy, 2 - dx:wo + 4 - dx] @ k[:, :, dy, dx]
                  for dy in range(3) for dx in range(3))
        return _pad_adjoint(out, "reflect").to(gz.dtype)
    h, w_ = ho // 2, wo // 2
    kp = up2_phase_weights(k)
    out = 0
    for a in range(2):
        for b in range(2):
            gp = F.pad(g[:, a::2, b::2], (0, 0, 2, 2, 2, 2))
            out = out + sum(
                gp[:, 2 - a - ty:h + 4 - a - ty, 2 - b - tx:w_ + 4 - b - tx]
                @ kp[a, b, :, :, ty, tx] for ty in range(2) for tx in range(2))
    return _pad_adjoint(out, "edge").to(gz.dtype)


def fused_conv3x3_wgrad_plain(gz, x, *, pad_mode):
    """Plain PyTorch version of the wgrad kernel: the gradient on w of
    conv3x3(pad(x), w), OIHW [Co,Ci,3,3] in x's dtype, summed in f32 (f64
    for f64): gw[co,ci,dy,dx] = sum over n, h, w of gz[n,h,w,co] *
    xpad[n,h+dy,w+dx,ci].  'up2_reflect', the phase form: the 4 phases'
    2x2 taps on the edge-padded low-res input, folded back to 3x3 by
    ``up2_phase_weights_adjoint``."""
    acc = _acc_dtype(gz)
    g, xa = gz.to(acc), x.to(acc)
    n, h, w_, _ = x.shape
    mode = "reflect" if pad_mode == "reflect" else "edge"
    xp = xa[:, _pad_index(h, mode, x.device)][:, :, _pad_index(w_, mode, x.device)]

    def taps(gp, k, oy=0, ox=0):  # [Co,Ci,k,k]: gp's pixels against xp shifted by each tap
        hh, ww = gp.shape[1:3]
        return torch.stack([torch.stack([
            torch.einsum("nhwo,nhwi->oi", gp,
                         xp[:, oy + dy:oy + dy + hh, ox + dx:ox + dx + ww])
            for dx in range(k)], -1) for dy in range(k)], -2)

    if pad_mode == "reflect":
        return taps(g, 3).to(x.dtype)
    phases = torch.stack([torch.stack([taps(g[:, a::2, b::2], 2, a, b) for b in range(2)])
                          for a in range(2)])
    return up2_phase_weights_adjoint(phases).to(x.dtype)


def tf32_round_plain(t):
    """f32 -> the TF32 value of ``cvt.rna.tf32.f32`` (round to nearest, ties
    away from zero, 10 mantissa bits) with its 13 low bits cleared, as the
    backward kernels store it: emulated on the f32 bits."""
    bits = t.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32).view(torch.float32)


def tf32_split_plain(t):
    """(hi, lo) of the kernels' 3xTF32 split: hi = tf32(t), lo = tf32(t - hi);
    hi + lo is t within 2^-21 relative."""
    hi = tf32_round_plain(t)
    return hi, tf32_round_plain(t.float() - hi)


def forward_pack_geometry(dtype, pad_mode, co):
    """(N, input channels per stage, taps) of the forward kernel's stages
    (csrc/fused_conv3x3.cu: Fw): N = 32 output channels when Co <= 32, else
    64; a stage is one chunk of input channels: one k-step (8 in f32, 16 in
    bf16), two in f32 at 'reflect' and N = 64; 9 taps, or at 'up2_reflect'
    the 16 of ``up2_phase_weights``."""
    n_tile = 32 if co <= 32 else 64
    chunk = 16 if dtype != torch.float32 or (n_tile == 64 and pad_mode == "reflect") else 8
    return n_tile, chunk, 9 if pad_mode == "reflect" else 16


def _taps(w, pad_mode):
    """OIHW ``[Co,Ci,3,3]`` -> the kernels' taps ``[Co,Ci,taps]`` in f32: the
    9 of w, or at 'up2_reflect' the 16 of ``up2_phase_weights``, tap
    ``((a*2 + b)*2 + ty)*2 + tx``."""
    co, ci = w.shape[:2]
    wf = w.float()
    if pad_mode == "reflect":
        return wf.reshape(co, ci, 9)
    return up2_phase_weights(wf).permute(2, 3, 0, 1, 4, 5).reshape(co, ci, 16)


def fused_conv3x3_pack_plain(w, *, pad_mode):
    """Plain PyTorch version of the forward kernel's weight pre-pack: OIHW
    ``[Co,Ci,3,3]`` (f32 or bf16) -> the bytes of every stage's B tiles in
    wgmma's shared-memory image, as the pre-pack kernel writes them.  The
    taps (``_taps``) in f32, split by ``tf32_split_plain`` into hi and lo in
    f32 or rounded to bf16, zero past Ci and Co, laid out
    ``[co tile][chunk][hi, lo][tap][n // 8][k // e][n % 8][e]`` with n the
    output channel in its tile, k the input channel in its chunk and e the
    elements of 16 bytes: 8 x 16-byte core matrices, K-major."""
    co, ci = w.shape[:2]
    n_tile, chunk, taps = forward_pack_geometry(w.dtype, pad_mode, co)
    e = 4 if w.dtype == torch.float32 else 8
    n_co, n_chunks = -(-co // n_tile), -(-ci // chunk)
    k = F.pad(_taps(w, pad_mode), (0, 0, 0, n_chunks * chunk - ci, 0, n_co * n_tile - co))
    halves = tf32_split_plain(k) if w.dtype == torch.float32 else (k.to(torch.bfloat16),)
    t = torch.stack(halves).reshape(len(halves), n_co, n_tile // 8, 8, n_chunks, chunk // e, e,
                                    taps)
    # [hl, co tile, nb, nr, chunk, kb, e, tap] -> the kernel's order
    t = t.permute(1, 4, 0, 7, 2, 5, 3, 6).contiguous()
    return t.view(torch.uint8).reshape(-1)


def dgrad_pack_geometry(dtype, pad_mode, ci):
    """(N, channels of Co per stage, taps per cotangent plane, planes) of the
    dgrad kernel's stages (csrc/fused_conv3x3_dgrad.cu: Dg): N = 32 input
    channels when Ci <= 32, else 64; a stage is one plane's taps times one
    chunk of output channels: one k-step (8 in f32, 16 in bf16), two in f32
    at N = 64."""
    taps, planes = (9, 1) if pad_mode == "reflect" else (4, 4)
    n_tile = 32 if ci <= 32 else 64
    chunk = 16 if dtype != torch.float32 or n_tile == 64 else 8
    return n_tile, chunk, taps, planes


def fused_conv3x3_dgrad_pack_plain(w, *, pad_mode):
    """Plain PyTorch version of the dgrad kernel's weight pre-pack: OIHW
    ``[Co,Ci,3,3]`` (f32 or bf16) -> the bytes of every stage's B tiles in
    wgmma's shared-memory image, as the pre-pack kernel writes them.  The
    taps (9, or at 'up2_reflect' the 16 of ``up2_phase_weights``, tap
    ``((a*2 + b)*2 + ty)*2 + tx``) in f32, split by ``tf32_split_plain`` into
    hi and lo in f32 or rounded to bf16, zero past Ci and Co, laid out
    ``[ci tile][plane][chunk][hi, lo][tap of the plane][n // 8][k // e][n % 8][e]``
    with n the input channel in its tile, k the output channel in its chunk
    and e the elements of 16 bytes: 8 x 16-byte core matrices, K-major."""
    co, ci = w.shape[:2]
    n_tile, chunk, taps, planes = dgrad_pack_geometry(w.dtype, pad_mode, ci)
    e = 4 if w.dtype == torch.float32 else 8
    n_ci, n_chunks = -(-ci // n_tile), -(-co // chunk)
    k = F.pad(_taps(w, pad_mode), (0, 0, 0, n_ci * n_tile - ci, 0, n_chunks * chunk - co))
    halves = tf32_split_plain(k) if w.dtype == torch.float32 else (k.to(torch.bfloat16),)
    t = torch.stack(halves).reshape(len(halves), n_chunks, chunk // e, e, n_ci, n_tile // 8, 8,
                                    planes, taps)
    # [hl, chunk, kb, e, ci tile, nb, nr, plane, tap] -> the kernel's order
    t = t.permute(4, 7, 1, 0, 8, 5, 2, 6, 3).contiguous()
    return t.view(torch.uint8).reshape(-1)


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


def _check_grad(gz, t, pad_mode, name):
    """Raise on what the dgrad (``t`` = w) or wgrad (``t`` = x) kernel does
    not take; returns (N, H, W, Ci, Ho, Wo, Co).  Shapes, strides, dtypes
    and devices only, as ``_check``."""
    if pad_mode not in PAD_MODES:
        raise ValueError(f"pad_mode must be one of {PAD_MODES}, got {pad_mode!r}")
    if gz.dtype not in _DTYPE_CODES and not (gz.dtype == torch.float64
                                             and gz.device.type == "cpu"):
        raise TypeError(f"{name} takes float32 or bfloat16 (and float64 on the CPU, "
                        f"plain version only), got {gz.dtype} on {gz.device}")
    if gz.dim() != 4 or not gz.is_contiguous():
        raise ValueError(f"gz must be a contiguous NHWC tensor, got shape "
                         f"{tuple(gz.shape)} strides {gz.stride()}")
    if t.dtype != gz.dtype or t.device != gz.device:
        raise ValueError(f"{name}: {t.dtype} on {t.device} against gz {gz.dtype} "
                         f"on {gz.device}")
    n, ho, wo, co = gz.shape
    up = pad_mode == "up2_reflect"
    if up and (ho % 2 or wo % 2):
        raise ValueError(f"up2_reflect's output is even in H and W, got {ho}x{wo}")
    h, w_ = (ho // 2, wo // 2) if up else (ho, wo)
    if not up and (h < 2 or w_ < 2):
        raise ValueError(f"reflect padding needs H, W >= 2, got {h}x{w_}")
    if name.endswith("dgrad"):
        if (t.dim() != 4 or t.shape[0] != co or t.shape[2:] != (3, 3)
                or t.stride()[1:] != (9, 3, 1) or t.stride(0) < 9 * t.shape[1]):
            raise ValueError(f"w must be an OIHW [{co},Ci,3,3] tensor, contiguous or an "
                             f"input-channel slice of one, got shape {tuple(t.shape)} "
                             f"strides {t.stride()}")
        ci = t.shape[1]
    else:
        if t.dim() != 4 or t.shape[:3] != (n, h, w_) or not t.is_contiguous():
            raise ValueError(f"x must be a contiguous NHWC [{n},{h},{w_},Ci] tensor, got "
                             f"shape {tuple(t.shape)} strides {t.stride()}")
        ci = t.shape[3]
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


def run_forward(lib, x, w, b, residual, pad_mode, act):
    """The forward kernel's two launches (the weight pre-pack into scratch,
    then the main kernel) through ``lib``'s C interface, or a raise: y NHWC
    in x's dtype.  Counts nothing."""
    n, h, w_, ci, ho, wo, co = _check(x, w, b, residual, pad_mode, act)
    code, mode = _DTYPE_CODES[x.dtype], PAD_MODES.index(pad_mode)
    y = torch.empty((n, ho, wo, co), dtype=x.dtype, device=x.device)
    packed = torch.empty(max(lib.fused_conv3x3_scratch(code, ci, co, mode), 16),
                         dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_conv3x3_launch(
            code, x.data_ptr(), w.data_ptr(), w.stride(0),
            None if b is None else b.data_ptr(),
            None if residual is None else residual.data_ptr(), packed.data_ptr(),
            packed.numel(), y.data_ptr(), n, h, w_, ci, ho, wo, co, mode,
            ACTS.index(act), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fused_conv3x3 launch failed: CUDA error {err}")
    return y


def _launch(x, w, b, residual, pad_mode, act):
    """The CUDA implementation: one call of the kernel, or a raise; counted
    once."""
    from .build import load_library

    y = run_forward(load_library(), x, w, b, residual, pad_mode, act)
    fused_conv3x3.launches += 1
    fused_conv3x3.bf16_launches += x.dtype == torch.bfloat16
    return y


def _fake(x, w, b, residual, pad_mode, act):
    """The output's shape and type, for tracing; counts nothing."""
    n, _, _, _, ho, wo, co = _check(x, w, b, residual, pad_mode, act)
    return x.new_empty((n, ho, wo, co))


def _real(t):
    """A plain tensor outside any trace: the wrappers call the device
    implementation directly, without the dispatcher."""
    return (type(t) is torch.Tensor and not torch._is_functional_tensor(t)
            and _get_current_dispatch_mode() is None)


def _forward(x, w, b, residual, pad_mode, act):
    """The op's forward below autograd: the device implementation itself on
    real tensors, the dispatched op (its fake implementation) in a trace."""
    if _real(x):
        return (_launch if x.is_cuda else _plain)(x, w, b, residual, pad_mode, act)
    with torch._C._AutoDispatchBelowAutograd():
        return fused_conv3x3_op(x, w, b, residual, pad_mode, act)


# The backward's two kernels, each its own op (schema, CPU = plain, CUDA =
# kernel, fake), so that a trace of the forward op's registered autograd
# (opcheck, export's fake tensors) reaches fake implementations.  Neither
# is differentiable: their Autograd kernels run below autograd, and the
# Function's backward is once_differentiable.
_LIB.define("fused_conv3x3_dgrad(Tensor gz, Tensor w, str pad_mode) -> Tensor",
            tags=(torch.Tag.needs_exact_strides,))
_LIB.define("fused_conv3x3_wgrad(Tensor gz, Tensor x, str pad_mode) -> Tensor")
fused_conv3x3_dgrad_op = torch.ops.footprints.fused_conv3x3_dgrad.default
fused_conv3x3_wgrad_op = torch.ops.footprints.fused_conv3x3_wgrad.default


def _dgrad_plain(gz, w, pad_mode):
    _check_grad(gz, w, pad_mode, "fused_conv3x3_dgrad")
    return fused_conv3x3_dgrad_plain(gz, w, pad_mode=pad_mode)


def _wgrad_plain(gz, x, pad_mode):
    _check_grad(gz, x, pad_mode, "fused_conv3x3_wgrad")
    return fused_conv3x3_wgrad_plain(gz, x, pad_mode=pad_mode)


def run_dgrad(lib, gz, w, pad_mode):
    """The dgrad kernel's two launches (the weight pre-pack into scratch,
    then the main kernel) through ``lib``'s C interface, or a raise: gx NHWC
    in gz's dtype.  Counts nothing."""
    n, h, w_, ci, ho, wo, co = _check_grad(gz, w, pad_mode, "fused_conv3x3_dgrad")
    code, mode = _DTYPE_CODES[gz.dtype], PAD_MODES.index(pad_mode)
    gx = torch.empty((n, h, w_, ci), dtype=gz.dtype, device=gz.device)
    packed = torch.empty(max(lib.fused_conv3x3_dgrad_scratch(code, ci, co, mode), 16),
                         dtype=torch.uint8, device=gz.device)
    with torch.cuda.device(gz.device):
        stream = torch.cuda.current_stream(gz.device).cuda_stream
        err = lib.fused_conv3x3_dgrad_launch(
            code, gz.data_ptr(), w.data_ptr(), w.stride(0), packed.data_ptr(), packed.numel(),
            gx.data_ptr(), n, h, w_, ci, ho, wo, co, mode, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fused_conv3x3_dgrad launch failed: CUDA error {err}")
    return gx


def _launch_dgrad(gz, w, pad_mode):
    """One call of the dgrad kernel (its pre-pack, then the kernel), or a
    raise; counted once."""
    from .build import load_library

    gx = run_dgrad(load_library(), gz, w, pad_mode)
    fused_conv3x3_dgrad.launches += 1
    fused_conv3x3_dgrad.bf16_launches += gz.dtype == torch.bfloat16
    return gx


def _pack_on_card(kind, w, pad_mode):
    """A weight pre-pack alone, on the card: ``kind`` '' (the forward's) or
    '_dgrad'.  Raises off the card.  Counts nothing."""
    name = f"fused_conv3x3{kind}_pack"
    if (not w.is_cuda or w.dtype not in _DTYPE_CODES or w.dim() != 4
            or w.stride()[1:] != (9, 3, 1)):
        raise ValueError(f"{name} takes an OIHW f32 or bf16 CUDA tensor (an input-channel "
                         f"slice view allowed), got {w.dtype} on {w.device} strides "
                         f"{w.stride()}")
    from .build import load_library

    lib = load_library()
    co, ci = w.shape[:2]
    code, mode = _DTYPE_CODES[w.dtype], PAD_MODES.index(pad_mode)
    packed = torch.empty(getattr(lib, f"fused_conv3x3{kind}_scratch")(code, ci, co, mode),
                         dtype=torch.uint8, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = getattr(lib, name)(code, w.data_ptr(), w.stride(0), ci, co, mode,
                                 packed.data_ptr(), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return packed


def fused_conv3x3_pack(w, *, pad_mode):
    """The forward kernel's weight pre-pack alone, on the card (the first of
    its two launches): the bytes ``fused_conv3x3_pack_plain`` gives.  Raises
    off the card.  Counts nothing."""
    return _pack_on_card("", w, pad_mode)


def fused_conv3x3_dgrad_pack(w, *, pad_mode):
    """The dgrad kernel's weight pre-pack alone, on the card (the first of
    its two launches): the bytes ``fused_conv3x3_dgrad_pack_plain`` gives.
    Raises off the card.  Counts nothing."""
    return _pack_on_card("_dgrad", w, pad_mode)


def run_wgrad(lib, gz, x, pad_mode):
    """The wgrad kernel's two launches (its partial sums, then their
    fixed-order sum) through ``lib``'s C interface, or a raise: gw OIHW
    [Co,Ci,3,3], contiguous, in x's dtype.  Counts nothing."""
    n, h, w_, ci, ho, wo, co = _check_grad(gz, x, pad_mode, "fused_conv3x3_wgrad")
    code, mode = _DTYPE_CODES[x.dtype], PAD_MODES.index(pad_mode)
    gw = torch.empty((co, ci, 3, 3), dtype=x.dtype, device=x.device)
    floats = lib.fused_conv3x3_wgrad_scratch(code, n, h, w_, ci, co, mode)
    scratch = torch.empty(max(floats, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_conv3x3_wgrad_launch(
            code, gz.data_ptr(), x.data_ptr(), scratch.data_ptr(), scratch.numel(),
            gw.data_ptr(), n, h, w_, ci, ho, wo, co, mode, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fused_conv3x3_wgrad launch failed: CUDA error {err}")
    return gw


def _launch_wgrad(gz, x, pad_mode):
    """One call of the wgrad kernel (its partial sums, then their
    fixed-order sum), or a raise; counted once."""
    from .build import load_library

    gw = run_wgrad(load_library(), gz, x, pad_mode)
    fused_conv3x3_wgrad.launches += 1
    fused_conv3x3_wgrad.bf16_launches += x.dtype == torch.bfloat16
    return gw


def _dgrad_fake(gz, w, pad_mode):
    n, h, w_, ci, _, _, _ = _check_grad(gz, w, pad_mode, "fused_conv3x3_dgrad")
    return gz.new_empty((n, h, w_, ci))


def _wgrad_fake(gz, x, pad_mode):
    _, _, _, ci, _, _, co = _check_grad(gz, x, pad_mode, "fused_conv3x3_wgrad")
    return x.new_empty((co, ci, 3, 3))


def fused_conv3x3_dgrad(gz, w, *, pad_mode):
    """The gradient on x of conv3x3(pad(x), w), NHWC: the dgrad kernel on a
    CUDA tensor (or a raise), the plain version on a CPU tensor, the op
    (its fake implementation) in a trace.  Records no graph."""
    if _real(gz):
        return (_launch_dgrad if gz.is_cuda else _dgrad_plain)(gz, w, pad_mode)
    with torch._C._AutoDispatchBelowAutograd():
        return fused_conv3x3_dgrad_op(gz, w, pad_mode)


def fused_conv3x3_wgrad(gz, x, *, pad_mode):
    """The gradient on w of conv3x3(pad(x), w), OIHW: the wgrad kernel on a
    CUDA tensor (or a raise), the plain version on a CPU tensor, the op in
    a trace.  Records no graph."""
    if _real(gz):
        return (_launch_wgrad if gz.is_cuda else _wgrad_plain)(gz, x, pad_mode)
    with torch._C._AutoDispatchBelowAutograd():
        return fused_conv3x3_wgrad_op(gz, x, pad_mode)


fused_conv3x3_dgrad.launches = fused_conv3x3_dgrad.bf16_launches = 0
fused_conv3x3_wgrad.launches = fused_conv3x3_wgrad.bf16_launches = 0

_LIB.impl("fused_conv3x3_dgrad", _dgrad_plain, "CPU")
_LIB.impl("fused_conv3x3_dgrad", _launch_dgrad, "CUDA")
_LIB.impl("fused_conv3x3_dgrad",
          lambda gz, w, pad_mode: fused_conv3x3_dgrad(gz, w, pad_mode=pad_mode), "Autograd")
torch.library.register_fake("footprints::fused_conv3x3_dgrad", _dgrad_fake, lib=_LIB)
_LIB.impl("fused_conv3x3_wgrad", _wgrad_plain, "CPU")
_LIB.impl("fused_conv3x3_wgrad", _launch_wgrad, "CUDA")
_LIB.impl("fused_conv3x3_wgrad",
          lambda gz, x, pad_mode: fused_conv3x3_wgrad(gz, x, pad_mode=pad_mode), "Autograd")
torch.library.register_fake("footprints::fused_conv3x3_wgrad", _wgrad_fake, lib=_LIB)


class _FusedConv3x3(torch.autograd.Function):
    """The op's autograd: the forward kernel forward, the dgrad and wgrad
    kernels backward (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, x, w, b, residual, pad_mode, act):
        y = _forward(x, w, b, residual, pad_mode, act)
        ctx.pad_mode = pad_mode
        ctx.save_for_backward(x, w, y if act == "elu" else None)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        """Gradients (x, w, b, residual) of act(conv3x3(pad(x)) + b
        [+ residual]), None where that input needs none; the residual's is
        the pre-activation gradient.  gy: NHWC [N,Ho,Wo,Co]."""
        x, w, y = ctx.saved_tensors
        need_x, need_w, need_b, need_r = ctx.needs_input_grad[:4]
        # ELU's derivative from the saved output, gy * (min(y, 0) + 1), in
        # one pass (three for the same ops written out; the same f32 bits)
        gz = (gy if y is None else torch.ops.aten.elu_backward(
            gy, 1.0, 1.0, 1.0, True, y)).contiguous()
        gx = fused_conv3x3_dgrad(gz, w, pad_mode=ctx.pad_mode) if need_x else None
        gw = fused_conv3x3_wgrad(gz, x, pad_mode=ctx.pad_mode) if need_w else None
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
