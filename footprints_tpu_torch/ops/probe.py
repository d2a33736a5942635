"""The clock64() probe of the backward's dgrad and wgrad kernels: where a
block's time goes.

``probe_backward(kind, gz, t, pad_mode)`` runs the kernel once from the probe
library (``build.build_probe``: the same sources under
``-DFOOTPRINTS_PROBE``; no other path loads it) with a stamp buffer set.
Thread 0 of every block of the main kernel (dgrad's, or wgrad's partial
sums) stamps the cycles since its last stamp, charged to one of: waiting
(on its copies, the weight ring's mbarrier and the block's barriers),
staging (issuing the next copies, the f32 split), the MMAs (issue to the
last wait on them), the epilogue; then its SM and its start and end on the
global nanosecond timer.  The summary gives each one's share of the
block's cycles and its mean per block, and the blocks resident on an SM at
once (the most intervals that overlap on one SM).  The launch counters do
not move.
"""

import torch

from . import fused_conv as fc
from .build import load_probe_library

FIELDS = 7  # csrc/fused_conv3x3_common.cuh: PROBE_FIELDS
PARTS = ("wait", "stage", "mma", "epilogue")  # the cycle counters, in the stamps' order


def _blocks(kind, lib, gz, t, pad_mode):
    """The main kernel's blocks for these shapes, as its launch computes
    them (the probe library's ``*_probe_blocks`` query)."""
    n, h, w_, ci, _, _, co = fc._check_grad(gz, t, pad_mode, f"fused_conv3x3_{kind}")
    dtype, mode = fc._DTYPE_CODES[gz.dtype], fc.PAD_MODES.index(pad_mode)
    if kind == "dgrad":
        blocks = lib.fused_conv3x3_dgrad_probe_blocks(dtype, n, h, w_, ci, mode)
    else:
        blocks = lib.fused_conv3x3_wgrad_probe_blocks(dtype, n, h, w_, ci, co, mode)
    if blocks <= 0:
        raise RuntimeError(f"probe: fused_conv3x3_{kind} has no probed kernel for these "
                           f"shapes ({blocks})")
    return blocks


def most_overlapping(intervals):
    """The most of (start, end) intervals that hold one instant."""
    events = sorted([(s, 1) for s, _ in intervals] + [(e, -1) for _, e in intervals])
    best = now = 0
    for _, step in events:
        now += step
        best = max(best, now)
    return best


def probe_backward(kind, gz, t, pad_mode):
    """One probed call of the dgrad (``t`` = w) or wgrad (``t`` = x) kernel
    on the card: {"blocks", "blocks_per_sm_resident", "sms", "wait_share",
    "mma_share", "epilogue_share", the mean cycles of each a block,
    "span_ms"}.  Raises off the card."""
    lib = load_probe_library()
    blocks = _blocks(kind, lib, gz, t, pad_mode)
    buf = torch.zeros(blocks * FIELDS, dtype=torch.int64, device=gz.device)
    setter = getattr(lib, f"fused_conv3x3_{kind}_probe_set")
    run = fc.run_dgrad if kind == "dgrad" else fc.run_wgrad
    torch.cuda.synchronize(gz.device)
    if setter(buf.data_ptr(), blocks) != 0:
        raise RuntimeError(f"fused_conv3x3_{kind}_probe_set failed")
    try:
        run(lib, gz, t, pad_mode)
        torch.cuda.synchronize(gz.device)
    finally:
        setter(None, 0)
    rows = buf.view(blocks, FIELDS).cpu()
    rows = rows[rows[:, 6] != 0]  # the blocks that ran
    blocks = len(rows)
    if blocks == 0:
        raise RuntimeError(f"probe: no block of fused_conv3x3_{kind} wrote its stamps")
    parts = {name: rows[:, i].double() for i, name in enumerate(PARTS)}
    total = float(sum(v.sum() for v in parts.values()))
    per_sm = {}
    for sm, start, end in rows[:, 4:7].tolist():
        per_sm.setdefault(sm, []).append((start, end))
    return {"blocks": blocks, "sms": len(per_sm),
            "blocks_per_sm_resident": max(most_overlapping(v) for v in per_sm.values()),
            **{f"{k}_share": float(v.sum()) / total for k, v in parts.items()},
            **{f"{k}_cycles_per_block": float(v.mean()) for k, v in parts.items()},
            "span_ms": float(rows[:, 6].max() - rows[:, 5].min()) / 1e6}
