#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The cell is an entry of ``BENCHMARK.json``'s ``workloads``
(``harness.py`` says which files make it up).  A run builds the program's
model from seeded weights, warms the cell's own shapes, measures for
``--seconds``, checks the window's outputs against the plain reference
(``compare.py``), and prints one JSON line last on standard output:
``--trace 0`` gives the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a traced stretch after the window.  The compared
numbers and their limits are the last lines on standard error, and the
last key of the result.  It exits with another code than 0, and prints no
result, without a CUDA card (or fewer than the cell asks for), or if JAX
or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for path in (ROOT, HERE):
    if path not in sys.path:
        sys.path.insert(0, path)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def finite(value):
    return value if isinstance(value, (int, float)) and math.isfinite(value) else None


def run_cell(cell, seed, seconds, trace, device, t_start):
    """One run of ``cell``: the result line's dict."""
    import devtrace
    import harness

    ctx = harness.Context(cell=cell, seed=seed, seconds=seconds, trace=bool(trace),
                          device=device)
    out = harness.driver(cell.traffic["driver"]).run(ctx)
    rows, ok = harness.verdict(out.checks, cell.limits)
    ok = ok and out.attempted > 0 and out.failed == 0
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = harness.metric_reader(m["name"]).read(out.measure)
            if value is not None:
                metrics[m["name"]] = {"value": finite(value), "unit": m["unit"]}
    else:
        values = {**out.end_to_end, "setup_s": out.window_start - t_start}
        metrics = {m["name"]: {"value": finite(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": bool(ok), "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": out.device}
    tr = out.measure.trace
    if trace and tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = devtrace.breakdown(tr)
    result["checks"] = {name: {"value": finite(value), "limit": limit}
                        for name, value, limit in rows}
    return result


def card_line():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30)
        return proc.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None):
    args = parse(argv)
    import torch

    import harness

    cell = harness.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, args.trace, "cuda", T_START)
    forbidden = harness.loaded_forbidden()
    if forbidden:
        print(f"a run loaded {', '.join(forbidden)}: no result", file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
