"""Serving export: trace the forward once, save it, serve it with no model
code (counterpart of footprints_tpu/export.py).

The JAX package lowers its serving forward to a StableHLO artifact.  Here
the forward is traced by ``torch.export.export`` at a static input shape,
with the weights in the program, and written by ``torch.export.save``: a
serialized ATen graph that ``load_serving`` reloads and runs eagerly,
without the model's classes, without the checkpoint and without tracing
again.  The decoder's CUDA kernel is in the graph as the custom op
``footprints::fused_conv3x3`` (ops/fused_conv.py): importing that module
registers it, and a program that calls it loads only after that import.
On a CUDA device the op launches the kernel; on the CPU it runs the plain
version.

Platforms: the program is traced on the first platform's device (cuda by
default; it raises without CUDA, as every entry point does), then its
weights are moved to the CPU and it is saved so.  ``load_serving`` moves it
to the device it is asked for, which the metadata's ``platforms`` must
name.  So one artifact runs on the card and on the CPU, the CPU leg being a
numerics check of the card's, as the JAX artifact's ``('tpu', 'cpu')``.

Artifact layout (two files next to each other):
  * ``<out>``       the saved ``ExportedProgram`` (a zip archive);
  * ``<out>.json``  metadata: resolution, batch, dtype, platforms, the
    output channel contract, the file's size and the torch version.

Input contract:  float32 ``[batch, height, width, 3]`` RGB in [0, 1].
Output contract: float32 ``[batch, 4, height, width]`` for the
FootprintNetwork (ch0 visible-ground logit, ch1 hidden-ground logit, ch2
visible depth, ch3 hidden-ground depth, as sigmoid disparities); float16
``[batch, height, width]`` ground probability for the Segmentor (the
ground_seg dump's map).  bfloat16 casts the weights, the BN statistics and
the activations; float32 keeps checkpoint-parity numerics.

Usage:
  python -m footprints_tpu_torch.export --model_path /path/to/weights \\
      --height 192 --width 640 --batch 16 --dtype bfloat16 \\
      --out serving/footprints_192x640.pt2
"""

import argparse
import copy
import json
import os

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

from .ops import fused_conv  # noqa: F401  (registers footprints::fused_conv3x3)
from .utils import select_device

FORMAT_VERSION = 1

CHANNEL_CONTRACT = [
    "visible_ground_logit",
    "hidden_ground_logit",
    "visible_depth_sigmoid_disp",
    "hidden_depth_sigmoid_disp",
]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
PLATFORMS = ("cuda", "cpu")


def _serving_copy(net, dtype):
    """An eval-mode copy of ``net`` in ``dtype`` (parameters and BN
    statistics), needing no gradient."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be bfloat16 or float32, got {dtype!r}")
    return copy.deepcopy(net).eval().requires_grad_(False).to(DTYPES[dtype])


class _FootprintServing(torch.nn.Module):
    """f32 ``[B,H,W,3]`` -> f32 channels-first ``[B,4,H,W]``: the '1/1' head
    of the FootprintNetwork computed in ``dtype``."""

    def __init__(self, net, dtype):
        super().__init__()
        self.net = _serving_copy(net, dtype)
        self.dtype = DTYPES[dtype]

    def forward(self, images):
        out = self.net(images.to(self.dtype), scales=("1/1",))["1/1"]
        return out.permute(0, 3, 1, 2).to(torch.float32,
                                           memory_format=torch.contiguous_format)


class _SegmentorServing(torch.nn.Module):
    """f32 ``[B,H,W,3]`` -> f16 ``[B,H,W]``: sigmoid of the Segmentor's
    full-scale logit computed in ``dtype``, the map the seg Tester writes
    (preprocessing/segmentation/inference.py)."""

    def __init__(self, net, dtype):
        super().__init__()
        self.net = _serving_copy(net, dtype)
        self.dtype = DTYPES[dtype]

    def forward(self, images):
        logits = self.net(images.to(self.dtype), scales=("1/1",))[0]
        return torch.sigmoid(logits[..., 0]).to(torch.float16)


def build_serving_forward(net, dtype="bfloat16"):
    """The FootprintNetwork serving forward as a module of the batch; ``net``
    is left as it is."""
    return _FootprintServing(net, dtype)


def build_segmentor_forward(net, dtype="bfloat16"):
    """The ground-Segmentor serving forward as a module of the batch."""
    return _SegmentorServing(net, dtype)


def export_serving(weights_path, out_path, *, height, width, batch=16,
                   dtype="bfloat16", platforms=PLATFORMS, depth=34,
                   network="footprint", use_psp=True):
    """Load weights, trace the serving forward, write the artifact.

    network 'footprint' (the main 4-channel model; weights_path a directory
    with checkpoint.npz or model.pth) or 'segmentor' (the ground-seg
    preprocessing model; weights_path an epoch_<n>.pth, a checkpoint.npz or
    a directory holding one).  Traces on ``platforms[0]``.  Returns the
    metadata dict (also written to ``<out>.json``)."""
    platforms = list(platforms)
    if not platforms or any(p not in PLATFORMS for p in platforms):
        raise ValueError(f"platforms must be a non-empty subset of {PLATFORMS}, "
                         f"got {platforms}")
    device = select_device(platforms[0])
    if network == "footprint":
        from .model_manager import ModelManager

        mm = ModelManager(is_inference=True, depth=depth, device=device)
        mm.load_model(weights_path)
        module = build_serving_forward(mm.net, dtype)
        model_meta = {
            "model": "FootprintNetwork",
            "output": "float32 [batch, 4, height, width]",
            "channels": CHANNEL_CONTRACT,
        }
    elif network == "segmentor":
        from .models import Segmentor
        from .preprocessing.segmentation.inference import load_segmentor_weights

        net = Segmentor(depth=depth, use_psp=use_psp, device=device)
        load_segmentor_weights(net, weights_path)
        module = build_segmentor_forward(net, dtype)
        model_meta = {
            "model": "Segmentor",
            "use_psp": use_psp,
            "output": "float16 [batch, height, width] ground probability",
        }
    else:
        raise ValueError(f"network must be footprint or segmentor, "
                         f"got {network!r}")

    example = torch.zeros(batch, height, width, 3, device=device)
    program = torch.export.export(module, (example,))
    # saved with its weights on the CPU (load_serving moves it), and
    # without the example batch, which the program would otherwise carry
    program.example_inputs = None
    program = move_to_device_pass(program, "cpu")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.export.save(program, out_path)

    meta = {
        "format_version": FORMAT_VERSION,
        "encoder_depth": depth,
        "height": height,
        "width": width,
        "batch": batch,
        "dtype": dtype,
        "platforms": platforms,
        "input": "float32 [batch, height, width, 3] RGB in [0, 1]",
        "bytes": os.path.getsize(out_path),
        "torch_version": torch.__version__,
        **model_meta,
    }
    with open(out_path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def _user_io(program):
    """(input shape, output shape, output torch dtype) of the program's one
    user input and one output, from the traced graph."""
    sig = program.graph_signature
    (name,) = sig.user_inputs
    (node,) = [n for n in program.graph.nodes if n.name == name]
    (out,) = program.graph.output_node().args[0]
    return tuple(node.meta["val"].shape), tuple(out.meta["val"].shape), out.meta["val"].dtype


class ServingModel:
    """A reloaded serving artifact.  ``call(images)`` takes numpy f32
    ``[N,H,W,3]`` and returns numpy (``[N,4,H,W]`` f32, or ``[N,H,W]`` f16
    for a Segmentor), padding and splitting N onto the traced batch.
    ``module`` runs one traced batch on tensors already on ``device``."""

    def __init__(self, program, meta, device):
        self.module = program.module()
        self.meta = meta
        self.device = device
        self.batch = meta["batch"]
        self.height, self.width = meta["height"], meta["width"]
        _, out_shape, out_dtype = _user_io(program)
        self._empty = torch.empty((0,) + out_shape[1:], dtype=out_dtype).numpy()

    def call(self, images):
        images = np.asarray(images, np.float32)
        expected = (self.height, self.width, 3)
        if images.ndim != 4 or images.shape[1:] != expected:
            raise ValueError(
                f"expected [N,{self.height},{self.width},3] float32, "
                f"got {images.shape}")
        outs = []
        with torch.inference_mode():
            for start in range(0, len(images), self.batch):
                chunk = images[start:start + self.batch]
                n = len(chunk)
                if n < self.batch:
                    chunk = np.concatenate(
                        [chunk, np.zeros((self.batch - n,) + expected, np.float32)])
                x = torch.from_numpy(chunk).to(self.device)
                outs.append(self.module(x)[:n].cpu().numpy())
        return np.concatenate(outs) if outs else self._empty


def load_serving(path, device="cuda"):
    """Load an artifact (and its .json sidecar) onto ``device`` (cuda by
    default: it raises without CUDA), which the sidecar's ``platforms``
    must name.  Needs no model code."""
    device = select_device(device)
    program = torch.export.load(path)
    meta_path = path + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    else:
        # fall back to the shapes recorded in the program itself
        shape, _, _ = _user_io(program)
        meta = {"batch": shape[0], "height": shape[1], "width": shape[2],
                "dtype": "unknown", "channels": CHANNEL_CONTRACT}
    if device.type not in meta.get("platforms", PLATFORMS):
        raise ValueError(f"{path} was exported for {meta['platforms']}, "
                         f"not {device.type}")
    if device.type != "cpu":
        program = move_to_device_pass(program, device)
    return ServingModel(program, meta, device)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Export the serving forward as a torch.export artifact.")
    parser.add_argument("--model_path", type=str, required=True,
                        help="directory with checkpoint.npz or model.pth "
                             "(segmentor: also an epoch_<n>.pth or .npz file)")
    parser.add_argument("--out", type=str, required=True,
                        help="output artifact path (e.g. model.pt2)")
    parser.add_argument("--height", type=int, default=192)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=sorted(DTYPES))
    parser.add_argument("--platforms", type=str, default="cuda,cpu",
                        help="comma-separated devices the artifact may be "
                             "loaded on; it is traced on the first")
    parser.add_argument("--encoder_depth", type=int, default=34,
                        choices=[18, 34, 50])
    parser.add_argument("--network", type=str, default="footprint",
                        choices=["footprint", "segmentor"],
                        help="which model to export (segmentor = the "
                             "ground-seg preprocessing net)")
    parser.add_argument("--no_PSP", action="store_true",
                        help="segmentor only: model was trained without the "
                             "PSP bottleneck")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    meta = export_serving(
        args.model_path, args.out,
        height=args.height, width=args.width, batch=args.batch,
        dtype=args.dtype, platforms=tuple(args.platforms.split(",")),
        depth=args.encoder_depth, network=args.network,
        use_psp=not args.no_PSP)
    print(f"exported {meta['bytes'] / 1e6:.1f} MB artifact to {args.out} "
          f"({meta['dtype']}, platforms {meta['platforms']})")


if __name__ == "__main__":
    main()
