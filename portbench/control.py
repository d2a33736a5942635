#!/usr/bin/env python3
"""The readings that a cell's check limits are set from, in one process on
the card: the program's compared numbers over many seeds (each a short
window of the cell's own load, at its own sizes), the control's over a few
(the reference in TF32, the nearest precision below the configurations'
f32, in the program's place), and for a train cell the half-batch fault
(the reference's loss and gradients over half of each batch, in the
program's place).  The benchmark's own runs never run this.

    python3 portbench/control.py --workload <cell> --seeds 11,12,... \\
        --control-seeds 21,22,23 [--seconds 3] [--out <file.json>]

Prints one JSON line per reading and, with ``--out``, writes them all.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
for path in (os.path.dirname(HERE), HERE):
    if path not in sys.path:
        sys.path.insert(0, path)


def readings(cell, seeds, control_seeds, seconds, device="cuda"):
    """[{kind, seed, checks, ...}] for the program on ``seeds``, then the
    control (and a train cell's half-batch fault) on ``control_seeds``."""
    import harness

    drv = harness.driver(cell.traffic["driver"])
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = harness.Context(cell=cell, seed=seed, seconds=seconds, trace=False, device=device)
        res = drv.run(ctx)
        row = {"kind": "program", "seed": seed, "checks": res.checks,
               "end_to_end": res.end_to_end, "setup_s": res.window_start - t0,
               "attempted": res.attempted, "failed": res.failed}
        out.append(row)
        print(json.dumps(row), flush=True)
    indices = list(range(cell.traffic.get("check_images", 0)))
    for seed in control_seeds:
        ctx = harness.Context(cell=cell, seed=seed, seconds=seconds, trace=False, device=device)
        kinds = [("control", drv.control)]
        if hasattr(drv, "half_batch"):
            kinds.append(("half_batch", drv.half_batch))
        for kind, fn in kinds:
            row = {"kind": kind, "seed": seed, "checks": fn(ctx, indices)}
            out.append(row)
            print(json.dumps(row), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    import harness

    if not torch.cuda.is_available():
        print("control readings are taken on a CUDA card", file=sys.stderr)
        return 2
    split = lambda s: [int(v) for v in s.split(",") if v]  # noqa: E731
    rows = readings(harness.cell(args.workload), split(args.seeds),
                    split(args.control_seeds), args.seconds)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
