"""The clock64() probe of the fused conv's kernels: where a block's time goes.

``probe_forward(x, w, b, r, pad_mode, act)`` and ``probe_backward(kind, gz,
t, pad_mode)`` run one kernel call from the probe library
(``build.build_probe``: the same sources under ``-DFOOTPRINTS_PROBE``; no
other path loads it) with a stamp buffer set.  Thread 0 of every block of
the main kernel (the forward's, dgrad's, or wgrad's partial sums) stamps
the cycles since its last stamp, charged to one of: waiting (on its
copies, the ring's mbarriers and the block's barriers), staging (issuing
the next copies, the f32 split, the forward's border fill), the MMAs (issue
to the last wait on them), the epilogue; then its SM and its start and end
on the global nanosecond timer.  The summary gives each one's share of the
block's cycles and its mean per block, and the blocks resident on an SM at
once (the most intervals that overlap on one SM).  The launch counters do
not move.
"""

import torch

from . import fused_conv as fc
from .build import load_probe_library

FIELDS = 7  # csrc/fused_conv3x3_common.cuh: PROBE_FIELDS
PARTS = ("wait", "stage", "mma", "epilogue")  # the cycle counters, in the stamps' order


def most_overlapping(intervals):
    """The most of (start, end) intervals that hold one instant."""
    events = sorted([(s, 1) for s, _ in intervals] + [(e, -1) for _, e in intervals])
    best = now = 0
    for _, step in events:
        now += step
        best = max(best, now)
    return best


def _probed(name, lib, blocks, run, device):
    """Run ``run()`` once with the stamp buffer of ``name``'s main kernel
    set (room for ``blocks`` blocks) and summarise the stamps."""
    if blocks <= 0:
        raise RuntimeError(f"probe: {name} has no probed kernel for these shapes ({blocks})")
    buf = torch.zeros(blocks * FIELDS, dtype=torch.int64, device=device)
    setter = getattr(lib, f"{name}_probe_set")
    torch.cuda.synchronize(device)
    if setter(buf.data_ptr(), blocks) != 0:
        raise RuntimeError(f"{name}_probe_set failed")
    try:
        run()
        torch.cuda.synchronize(device)
    finally:
        setter(None, 0)
    rows = buf.view(blocks, FIELDS).cpu()
    rows = rows[rows[:, 6] != 0]  # the blocks that ran
    if len(rows) == 0:
        raise RuntimeError(f"probe: no block of {name} wrote its stamps")
    parts = {part: rows[:, i].double() for i, part in enumerate(PARTS)}
    total = float(sum(v.sum() for v in parts.values()))
    per_sm = {}
    for sm, start, end in rows[:, 4:7].tolist():
        per_sm.setdefault(sm, []).append((start, end))
    return {"blocks": len(rows), "sms": len(per_sm),
            "blocks_per_sm_resident": max(most_overlapping(v) for v in per_sm.values()),
            **{f"{k}_share": float(v.sum()) / total for k, v in parts.items()},
            **{f"{k}_cycles_per_block": float(v.mean()) for k, v in parts.items()},
            "span_ms": float(rows[:, 6].max() - rows[:, 5].min()) / 1e6}


def probe_forward(x, w, b, r, pad_mode, act):
    """One probed call of the forward kernel on the card: {"blocks",
    "blocks_per_sm_resident", "sms", "wait_share", "stage_share",
    "mma_share", "epilogue_share", the mean cycles of each a block,
    "span_ms"}.  Raises off the card."""
    lib = load_probe_library()
    n, h, w_, ci, _, _, co = fc._check(x, w, b, r, pad_mode, act)
    blocks = lib.fused_conv3x3_probe_blocks(fc._DTYPE_CODES[x.dtype], n, h, w_, ci, co,
                                            fc.PAD_MODES.index(pad_mode))
    return _probed("fused_conv3x3", lib, blocks,
                   lambda: fc.run_forward(lib, x, w, b, r, pad_mode, act), x.device)


def probe_backward(kind, gz, t, pad_mode):
    """One probed call of the dgrad (``t`` = w) or wgrad (``t`` = x) kernel
    on the card, summarised as ``probe_forward``'s.  Raises off the card."""
    lib = load_probe_library()
    n, h, w_, ci, _, _, co = fc._check_grad(gz, t, pad_mode, f"fused_conv3x3_{kind}")
    dtype, mode = fc._DTYPE_CODES[gz.dtype], fc.PAD_MODES.index(pad_mode)
    if kind == "dgrad":
        blocks = lib.fused_conv3x3_dgrad_probe_blocks(dtype, n, h, w_, ci, mode)
    else:
        blocks = lib.fused_conv3x3_wgrad_probe_blocks(dtype, n, h, w_, ci, co, mode)
    run = fc.run_dgrad if kind == "dgrad" else fc.run_wgrad
    return _probed(f"fused_conv3x3_{kind}", lib, blocks, lambda: run(lib, gz, t, pad_mode),
                   gz.device)
