"""Offline checkpoint conversion (counterpart of footprints_tpu/convert/cli.py):

    python -m footprints_tpu_torch.convert.cli --input models/kitti/model.pth \\
        --output models/kitti_native --model footprint

Reads a reference PyTorch checkpoint (``torch.load(weights_only=True)``) and
writes ``<output>/checkpoint.npz`` in the JAX package's layout (params, BN
state, no optimizer state, step 0), which both packages load.
"""

import argparse
import os

import numpy as np

from ..checkpoint import save_checkpoint
from .bridge import (jax_params_from_state_dict, ravel_params,
                     segmentor_jax_params_from_state_dict)
from .torchvision_resnet import load_state_dict_file


def main(argv=None):
    parser = argparse.ArgumentParser(description="Convert .pth -> checkpoint.npz")
    parser.add_argument("--input", required=True, help="path to model.pth")
    parser.add_argument("--output", required=True,
                        help="output directory for checkpoint.npz")
    parser.add_argument("--model", choices=["footprint", "segmentor"],
                        default="footprint")
    parser.add_argument("--encoder_depth", type=int, default=34, choices=[18, 34, 50])
    parser.add_argument("--no_psp", action="store_true",
                        help="segmentor without the PSP bottleneck")
    args = parser.parse_args(argv)

    sd = load_state_dict_file(args.input)
    if args.model == "footprint":
        params, state = jax_params_from_state_dict(sd, args.encoder_depth)
    else:
        params, state = segmentor_jax_params_from_state_dict(
            sd, args.encoder_depth, use_psp=not args.no_psp)
    dest = os.path.join(args.output, "checkpoint.npz")
    save_checkpoint(dest, {"params": params, "state": state, "opt_state": None,
                           "step": np.zeros((), np.int32)})
    print(f"wrote {dest} ({ravel_params(params).size / 1e6:.1f}M params)")
    return dest


if __name__ == "__main__":
    main()
