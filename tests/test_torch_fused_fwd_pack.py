"""The forward kernel's weight pre-pack, its plain version on the CPU
(footprints_tpu_torch/ops/fused_conv.py: fused_conv3x3_pack_plain,
forward_pack_geometry).

The pre-pack kernel (csrc/fused_conv3x3.cu: fused_conv3x3_pack_kernel) is
held against this plain version byte for byte on the card
(tests/test_torch_cuda.py); here the plain version is held against what it
must hold: every tap of every (ci, co) once, zeros past Ci and Co, the 16
phase taps of footprints_tpu/ops/upconv.py:_phase_kernels at 'up2_reflect'
(on weights drawn with numpy from a seed), and the TF32 halves of
tf32_split_plain bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from footprints_tpu_torch.ops import fused_conv as fc


def _unpack(packed, dtype, pad_mode, ci, co):
    """fused_conv3x3_pack_plain's bytes -> [hi, lo] (f32) or [bf16] taps
    [Co, Ci, taps], undoing its documented layout."""
    n_tile, chunk, taps = fc.forward_pack_geometry(dtype, pad_mode, co)
    e = 4 if dtype == torch.float32 else 8
    n_co, n_chunks = -(-co // n_tile), -(-ci // chunk)
    halves = 2 if dtype == torch.float32 else 1
    t = packed.view(dtype).reshape(n_co, n_chunks, halves, taps, n_tile // 8, chunk // e, 8, e)
    # back to [hl, co tile, nb, nr, chunk, kb, e, tap]
    t = t.permute(2, 0, 4, 6, 1, 5, 7, 3).reshape(halves, n_co * n_tile, n_chunks * chunk, taps)
    return t[:, :co, :ci]


def _weights(co, ci_lo, ci_hi, dtype, seed):
    """An OIHW input-channel slice view [co, ci_hi - ci_lo, 3, 3] of a
    contiguous [co, 128, 3, 3] weight, as block4 passes its halves."""
    rng = np.random.RandomState(seed)
    full = torch.from_numpy(rng.randn(co, 128, 3, 3).astype(np.float32)).to(dtype)
    return full[:, ci_lo:ci_hi]


@pytest.mark.parametrize("pad_mode,co,f32_chunk", [("reflect", 64, 16), ("reflect", 32, 8),
                                                   ("reflect", 70, 16), ("up2_reflect", 64, 8),
                                                   ("up2_reflect", 32, 8)])
def test_pack_geometry(pad_mode, co, f32_chunk):
    """N covers Co up to 64 (32 when Co <= 32); a stage is 16 input channels
    in bf16, 8 in f32 but 16 at 'reflect' with N = 64; 9 or 16 taps; the
    plain pack's size follows."""
    n_tile = 32 if co <= 32 else 64
    taps = 9 if pad_mode == "reflect" else 16
    assert fc.forward_pack_geometry(torch.float32, pad_mode, co) == (n_tile, f32_chunk, taps)
    assert fc.forward_pack_geometry(torch.bfloat16, pad_mode, co) == (n_tile, 16, taps)
    ci = 40
    for dtype, chunk, size in ((torch.float32, f32_chunk, 8), (torch.bfloat16, 16, 2)):
        packed = fc.fused_conv3x3_pack_plain(torch.zeros(co, ci, 3, 3, dtype=dtype),
                                             pad_mode=pad_mode)
        assert packed.dtype == torch.uint8
        assert packed.numel() == -(-co // n_tile) * n_tile * -(-ci // chunk) * chunk * taps * size


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode", ["reflect", "up2_reflect"])
@pytest.mark.parametrize("ci_lo,ci_hi,co", [(0, 3, 5), (5, 38, 17), (64, 128, 64), (0, 64, 70),
                                            (3, 67, 32)])
def test_pack_plain_layout_holds_every_tap_once(dtype, pad_mode, ci_lo, ci_hi, co):
    """Undoing the documented layout gives back the taps (the 9 of w, or
    up2_phase_weights' 16), from an input-channel slice view at a Ci offset
    too, and every padded byte is zero: the pack is a permutation of the
    taps and zeros."""
    w = _weights(co, ci_lo, ci_hi, dtype, seed=ci_hi + co)
    ci = ci_hi - ci_lo
    packed = fc.fused_conv3x3_pack_plain(w, pad_mode=pad_mode)
    got = _unpack(packed, dtype, pad_mode, ci, co)
    wf = w.float()
    taps = (wf.reshape(co, ci, 9) if pad_mode == "reflect" else
            fc.up2_phase_weights(wf).permute(2, 3, 0, 1, 4, 5).reshape(co, ci, 16))
    if dtype == torch.float32:
        torch.testing.assert_close(got[0].double() + got[1].double(), taps.double(),
                                   atol=0, rtol=2.0 ** -21)
    else:
        assert torch.equal(got[0], taps.to(torch.bfloat16))
    nonzero = int((packed.view(dtype) != 0).sum())
    assert nonzero == int((got != 0).sum())
    # the slice view packs as its contiguous copy does
    assert torch.equal(packed, fc.fused_conv3x3_pack_plain(w.contiguous(), pad_mode=pad_mode))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("ci,co", [(8, 4), (33, 40), (64, 32)])
def test_pack_plain_folds_as_jax_phase_kernels(seed, ci, co):
    """At 'up2_reflect' the pack's 16 taps are the JAX package's phase
    kernels (footprints_tpu/ops/upconv.py:_phase_kernels, rows summed
    first): hi + lo within 2^-21 relative of them in f32 (1e-6 and
    tighter), and the bf16 pack equal to them rounded to bf16."""
    from footprints_tpu.ops.upconv import _phase_kernels

    rng = np.random.RandomState(70 + seed)
    w_hwio = rng.randn(3, 3, ci, co).astype(np.float32)
    kernels = _phase_kernels(jnp.asarray(w_hwio))
    # [a][b] of [ty, tx, ci, co] -> [co, ci, ((a*2 + b)*2 + ty)*2 + tx]
    ref = np.stack([np.asarray(kernels[a][b]) for a in range(2) for b in range(2)])
    ref = torch.from_numpy(ref.reshape(4, 2, 2, ci, co).transpose(4, 3, 0, 1, 2)
                           .reshape(co, ci, 16).copy())
    w = torch.from_numpy(np.ascontiguousarray(np.transpose(w_hwio, (3, 2, 0, 1))))
    hi, lo = _unpack(fc.fused_conv3x3_pack_plain(w, pad_mode="up2_reflect"),
                     torch.float32, "up2_reflect", ci, co)
    err = (hi.double() + lo.double() - ref.double()).abs()
    assert bool((err <= 2.0 ** -21 * ref.double().abs()).all())
    assert bool((err <= 1e-6 * ref.double().abs().max()).all())
    (b16,) = _unpack(fc.fused_conv3x3_pack_plain(w.to(torch.bfloat16), pad_mode="up2_reflect"),
                     torch.bfloat16, "up2_reflect", ci, co)
    ref16 = fc.up2_phase_weights(w.to(torch.bfloat16).float())
    ref16 = ref16.permute(2, 3, 0, 1, 4, 5).reshape(co, ci, 16).to(torch.bfloat16)
    assert torch.equal(b16, ref16)


@pytest.mark.parametrize("pad_mode", ["reflect", "up2_reflect"])
@pytest.mark.parametrize("ci,co,scale", [(64, 64, 1.0), (20, 6, 1e-3), (64, 32, 3e4)])
def test_pack_plain_halves_are_tf32_split_plain_bit_for_bit(pad_mode, ci, co, scale):
    """The f32 pack's hi and lo planes hold tf32_split_plain's halves of the
    taps, bit for bit (each with its 13 low bits clear): the kernel's
    split_tf32_bits emulated on the f32 bits."""
    rng = np.random.RandomState(ci * co)
    w = torch.from_numpy((rng.randn(co, ci, 3, 3) * scale).astype(np.float32))
    hi, lo = _unpack(fc.fused_conv3x3_pack_plain(w, pad_mode=pad_mode), torch.float32,
                     pad_mode, ci, co)
    want_hi, want_lo = fc.tf32_split_plain(fc._taps(w, pad_mode))
    assert torch.equal(hi.contiguous().view(torch.int32), want_hi.view(torch.int32))
    assert torch.equal(lo.contiguous().view(torch.int32), want_lo.view(torch.int32))
    for part in (hi, lo):
        assert int((part.contiguous().view(torch.int32) & 0x1FFF).abs().max()) == 0
