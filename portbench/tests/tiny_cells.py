"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: the
same configuration at 64x96, batch 2, a pool of 4 frames, every check and
limit as the cell has them, and every answer of the window kept and
checked, so that a fault in any row shows however few batches a loaded
machine completes.  The harness and the program take the CPU path (the
fused kernel's plain version)."""

import dataclasses

import harness

SMALL = {"batch": 2, "pool_frames": 4, "check_images": 64, "warmup_batches": 1,
         "traced_batches": 1, "batches": 3, "warmup_requests": 2, "traced_requests": 2,
         "keep_one_in": 1, "traced_steps": 1}


def tiny(name):
    cell = harness.cell(name)
    traffic = {k: SMALL.get(k, v) for k, v in cell.traffic.items()}
    return dataclasses.replace(cell, config=dict(cell.config, height=64, width=96),
                               traffic=traffic)


def run(name, seed=123456789012345, seconds=1.0, trace=0, cell=None, device="cpu"):
    """One run of the tiny cell (or of ``cell``) on ``device``: the result
    line's dict."""
    run_py = harness.load_module(f"{harness.HERE}/run.py", "portbench_run")
    return run_py.run_cell(cell or tiny(name), seed, seconds, trace, device, 0.0)


CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
