"""Inference-only model loading (counterpart of
footprints_tpu/model_manager.py).

Two checkpoint formats load from a weights directory:

  * ``checkpoint.npz`` — the JAX package's flat train state, read by
    ``checkpoint.load_checkpoint`` and mapped across by
    ``convert.state_dict_from_jax_params``;
  * ``model.pth`` — a reference PyTorch state_dict, via ``torch.load``.

Both load strictly.  The optimiser and LR schedule arrive with the training
slice.
"""

import os

import torch

from .checkpoint import load_checkpoint
from .convert import state_dict_from_jax_params
from .models import FootprintNetwork
from .utils import select_device

CHECKPOINT_NAME = "checkpoint.npz"


class ModelManager:
    def __init__(self, depth=34, device="cuda"):
        self.device = select_device(device)
        self.depth = depth
        # load_model overwrites every parameter, so the init is never seen
        self.net = FootprintNetwork(depth, device=self.device).eval()

    def load_model(self, weights_path):
        """Load from a directory holding checkpoint.npz or model.pth."""
        native = os.path.join(weights_path, CHECKPOINT_NAME)
        torch_ckpt = os.path.join(weights_path, "model.pth")
        if os.path.exists(native):
            print(f"loading native checkpoint from {native}...")
            loaded = load_checkpoint(native)
            sd = state_dict_from_jax_params(loaded["params"], loaded["state"],
                                            depth=self.depth)
        elif os.path.exists(torch_ckpt):
            print(f"loading torch checkpoint from {torch_ckpt}...")
            sd = torch.load(torch_ckpt, map_location="cpu", weights_only=True)
        else:
            raise FileNotFoundError(
                f"no checkpoint found in {weights_path} "
                f"(looked for {CHECKPOINT_NAME} and model.pth)")
        self.net.load_state_dict(sd, strict=True)
        print("successfully loaded weights!")
