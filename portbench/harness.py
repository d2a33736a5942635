"""What every cell shares: the files a cell is made of, found by name, the
seeded inputs, the program's models built from a seeded state dict, the
check's verdict, and the device's description.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  It names a
configuration, ``configs/<config>.json`` (the model and its sizes), and a
traffic mix, ``traffic/<traffic>.json`` (the driver, ``drivers/<driver>.py``,
and its parameters).  The limits of its check are ``limits/<cell>.json``.  A
per-layer metric is read by ``metrics/<name>.py``, or, where that file does
not exist, by ``metrics/<name up to its first dot>.py``.  Adding a cell of an
existing kind takes a traffic file, a limits file and an entry in
``BENCHMARK.json``.

Adding a configuration takes, as new files alone:

- ``configs/<config>.json``, whose ``"reference": "<module>:<function>"``
  names its plain reference;
- ``reference/<module>.py``, whose ``<function>(config)`` returns that
  reference as a plain ``nn.Module`` (state-dict keys as the program's; it
  may build on ``reference/models.py``'s decoders);
- ``limits/<cell>.json`` for each of its cells;
- its entries in ``BENCHMARK.json``: the configuration and its cells.

The FLOPs (``flops.py``) and the fused kernel's sites are read from that
reference's own shapes.
"""

import dataclasses
import hashlib
import importlib.util
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that no run may load: JAX and the JAX package (the
# port's own name begins with the latter's, so names are compared whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "footprints_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark(root=ROOT):
    return load_json(root, "BENCHMARK.json")


def driver(name):
    return load_module(os.path.join(HERE, "drivers", f"{name}.py"), f"portbench_driver_{name}")


def metric_reader(name):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py`` if it
    exists, else ``metrics/<name up to its first dot>.py``."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.exists(path):
            return load_module(path, "portbench_metric_" + stem.replace(".", "_"))
    raise FileNotFoundError(f"no reader for metric {name} under {HERE}/metrics")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list  # the end-to-end metrics it reports (entries of BENCHMARK.json)
    per_layer: list  # its per-layer metrics


def reports(metric, cell_name, e2e_names=None):
    """Whether a metric entry of BENCHMARK.json is reported by the cell: it
    lists the cell, or it lists none and (per-layer) moves one of the
    cell's end-to-end metrics."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def cell(name, bench=None):
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    names = {m["name"] for m in e2e}
    return Cell(name=name,
                config=load_json(HERE, "configs", f"{entry['config']}.json"),
                traffic=load_json(HERE, "traffic", f"{entry['traffic']}.json"),
                limits=load_json(HERE, "limits", f"{name}.json"),
                chips=entry["chips"], end_to_end=e2e,
                per_layer=[m for m in bench["per_layer"] if reports(m, name, names)])


def subseed(seed, tag):
    """A 63-bit seed for one stream of the run (weights, frames, sample...),
    so that the streams of one ``--seed`` are independent of each other."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed, tag, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(subseed(seed, tag))
    return gen


def rng(seed, tag):
    return np.random.default_rng(subseed(seed, tag))


def reference_model(config, device="meta", reference_dir=os.path.join(HERE, "reference")):
    """The plain reference of the configuration, built on ``device``: the
    function that its ``"reference": "<module>:<function>"`` names in
    ``reference_dir/<module>.py``, called with the configuration."""
    if "reference" not in config:
        raise KeyError(f"configs/{config.get('name')}.json names no plain reference: "
                       'give it "reference": "<module>:<function>"')
    module, function = config["reference"].split(":")
    build = getattr(load_module(os.path.join(reference_dir, f"{module}.py"),
                                f"portbench_reference_{module}"), function)
    with torch.device(device):
        return build(config)


def seeded_weights(config, seed, device):
    from weights import seeded_state_dict

    return seeded_state_dict(reference_model(config), subseed(seed, "weights"), device)


def seeded_frames(config, seed, count, device):
    """``count`` frames [count,H,W,3] in [0,1), f32, drawn on ``device``."""
    gen = generator(seed, "frames", device)
    return torch.rand(count, config["height"], config["width"], 3, generator=gen,
                      device=device)


def frames_of(config, traffic, seed, indices, device):
    """The frames of the images (or requests) ``indices``: image i is frame
    i mod ``pool_frames`` of the seeded pool."""
    frames = seeded_frames(config, seed, traffic["pool_frames"], device)
    return frames[torch.tensor([i % traffic["pool_frames"] for i in indices], device=device)]


def kept_indices(seed, keep_one_in, bound=1 << 20):
    """The images (or requests) whose answers a run keeps for its check: a
    seeded draw of one in ``keep_one_in``, fixed before the window."""
    draw = rng(seed, "keep").random(bound)
    return set(np.nonzero(draw < 1.0 / keep_one_in)[0].tolist())


def f32_policy(tf32):
    """TF32 on or off for cuDNN and matmuls (the port's entry points set it
    off: f32 is true f32; the check's control turns it on)."""
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def program_model(config, state_dict, device):
    """The program's network for the configuration, built as its entry
    points build it, with the seeded weights loaded: the FootprintNetwork
    through ``ModelManager`` (serving, the dump, training), the Segmentor
    as the segmentation Tester builds it."""
    if config["model"] == "FootprintNetwork":
        from footprints_tpu_torch.model_manager import ModelManager

        manager = ModelManager(is_inference=True, depth=config["encoder_depth"],
                               device=device)
        manager.net.load_state_dict(state_dict, strict=True)
        return manager
    from footprints_tpu_torch.models import Segmentor
    from footprints_tpu_torch.utils import select_device

    net = Segmentor(depth=config["encoder_depth"], use_psp=config["use_psp"],
                    device=select_device(device)).eval()
    net.load_state_dict(state_dict, strict=True)
    return net


def sample(seed, candidates, count):
    """A seeded sample of ``count`` of ``candidates`` (all if fewer), sorted."""
    candidates = sorted(candidates)
    if len(candidates) <= count:
        return candidates
    pick = rng(seed, "check").choice(len(candidates), count, replace=False)
    return sorted(candidates[i] for i in pick)


def verdict(checks, limits):
    """[(name, value, limit)] for each compared number, and whether all are
    within their limits (a number that is missing or not finite is not)."""
    rows = [(name, value, limits[name]) for name, value in checks.items()]
    ok = bool(rows) and all(value is not None and np.isfinite(value) and value <= limit
                            for _, value, limit in rows)
    return rows, ok


def device_info(device, count):
    torch_device = torch.device(device)
    if torch_device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(torch_device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(torch_device))}


def loaded_forbidden():
    """Top-level names of loaded modules that no run may load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


@dataclasses.dataclass
class Context:
    """One run of a cell, as a driver is given it."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"


@dataclasses.dataclass
class Measure:
    """What a per-layer metric's reader reads: the window's counts, the
    traced stretch, and the work of one unit (an image, a request, one
    image of a train step)."""
    cell: Cell
    window_s: float
    units: int  # images completed (train: images stepped) in the window
    trace: object  # devtrace.Trace of the traced run, else None
    flops_per_unit: float
    peak_window_bytes: int = 0


@dataclasses.dataclass
class Outcome:
    """What a driver's run gives back to ``run.py``."""
    attempted: int
    failed: int
    end_to_end: dict  # end-to-end metric -> value (setup_s apart)
    window_start: float  # host clock at the window's start: set-up ends there
    measure: Measure
    checks: dict  # compared number -> value
    device: dict


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free_device(device):
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
