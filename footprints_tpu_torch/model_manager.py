"""Model lifecycle: network, optimizer, LR schedule, save and load
(counterpart of footprints_tpu/model_manager.py).

Two checkpoint formats load from a weights directory:

  * ``checkpoint.npz`` — the JAX package's flat train state (params, BN
    state, optax Adam state, step), read by ``checkpoint.load_checkpoint``
    and mapped across by ``convert``.  ``save_model`` writes the same
    format, so a checkpoint resumes in either package, Adam moments
    included;
  * ``model.pth`` — a reference PyTorch state_dict (weights only).

The optimizer state travels in optax's layout: ``((count, mu, nu),
(count,))``, the ``ScaleByAdamState`` of ``optax.flatten(optax.adam)`` and
its ``ScaleByScheduleState``, with ``mu``/``nu`` one flat f32 vector each in
``ravel_pytree`` order (convert/bridge.py).
"""

import os

import numpy as np
import torch

from .checkpoint import load_checkpoint, save_checkpoint
from .convert import (flat_from_named, init_encoder_from, jax_params_from_state_dict,
                      named_from_flat, state_dict_from_jax_params)
from .models import FootprintNetwork
from .train.step import TrainStepConfig, make_optimizer
from .utils import select_device

CHECKPOINT_NAME = "checkpoint.npz"


class ModelManager:
    def __init__(self, save_folder=None, is_inference=False, learning_rate=1e-4,
                 lr_step_size=10, steps_per_epoch=1, depth=34, seed=10,
                 pretrained_encoder=None, device="cuda"):
        self.save_folder = save_folder
        self.device = select_device(device)
        self.depth = depth
        self.net = FootprintNetwork(
            depth, device=self.device,
            generator=torch.Generator().manual_seed(seed)).eval()
        if pretrained_encoder is not None:
            # the reference trains from an ImageNet-pretrained encoder; the
            # decoders keep their seeded init
            print(f"initializing encoder from {pretrained_encoder}...")
            init_encoder_from(self.net, pretrained_encoder)
        self.step = 0
        self.config = TrainStepConfig(learning_rate=learning_rate,
                                      scheduler_step_epochs=lr_step_size,
                                      steps_per_epoch=steps_per_epoch)
        self.optimizer = None if is_inference else make_optimizer(self.net, self.config)

    # -- the JAX-layout train state ------------------------------------------

    def _trainable(self):
        return {n: p for n, p in self.net.named_parameters() if p.requires_grad}

    def train_state(self):
        """{params, state, opt_state, step} as numpy pytrees in the JAX
        package's layout (what ``save_checkpoint`` writes)."""
        sd = self.net.state_dict()
        params, state = jax_params_from_state_dict(sd, self.depth)
        opt_state = None
        if self.optimizer is not None:
            moments = {}
            count = 0
            for name, p in self._trainable().items():
                st = self.optimizer.state.get(p)
                if st:
                    moments.setdefault("mu", {})[name] = st["exp_avg"]
                    moments.setdefault("nu", {})[name] = st["exp_avg_sq"]
                    count = int(st["step"])
            mu = flat_from_named(moments.get("mu", {}), sd, self.depth)
            nu = flat_from_named(moments.get("nu", {}), sd, self.depth)
            count = np.asarray(count, np.int32)
            opt_state = ((count, mu, nu), (count,))
        return {"params": params, "state": state, "opt_state": opt_state,
                "step": np.asarray(self.step, np.int32)}

    def set_train_state(self, ts):
        """Load a JAX-layout train state (e.g. from ``load_checkpoint``)."""
        self._load_params(ts["params"], ts["state"])
        self.step = int(np.asarray(ts["step"]))
        if self.optimizer is not None and ts.get("opt_state") is not None:
            self._load_opt_state(ts["opt_state"])

    def _load_params(self, params, state):
        self.net.load_state_dict(
            state_dict_from_jax_params(params, state, depth=self.depth), strict=True)

    def _load_opt_state(self, opt_state):
        (count, mu, nu), _ = opt_state
        sd = self.net.state_dict()
        mu = named_from_flat(mu, sd, self.depth)
        nu = named_from_flat(nu, sd, self.depth)
        self.optimizer.state.clear()
        for name, p in self._trainable().items():
            self.optimizer.state[p] = {
                "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
                "exp_avg": mu[name].to(p.device),
                "exp_avg_sq": nu[name].to(p.device),
            }

    # -- persistence ---------------------------------------------------------

    def load_model(self, weights_path, load_optimiser=False):
        """Load from a directory holding checkpoint.npz or model.pth."""
        native = os.path.join(weights_path, CHECKPOINT_NAME)
        torch_ckpt = os.path.join(weights_path, "model.pth")
        if os.path.exists(native):
            print(f"loading native checkpoint from {native}...")
            loaded = load_checkpoint(native)
            self._load_params(loaded["params"], loaded["state"])
            self.step = int(np.asarray(loaded["step"]))
            if load_optimiser and self.optimizer is not None:
                self._load_opt_state(loaded["opt_state"])
        elif os.path.exists(torch_ckpt):
            print(f"loading torch checkpoint from {torch_ckpt}...")
            sd = torch.load(torch_ckpt, map_location="cpu", weights_only=True)
            self.net.load_state_dict(sd, strict=True)
            if load_optimiser:
                print("note: torch optimiser state is not imported; "
                      "optimizer restarts fresh")
        else:
            raise FileNotFoundError(
                f"no checkpoint found in {weights_path} "
                f"(looked for {CHECKPOINT_NAME} and model.pth)")
        print("successfully loaded weights!")

    def save_model(self, folder_name):
        save_path = os.path.join(self.save_folder, folder_name)
        dest = os.path.join(save_path, CHECKPOINT_NAME)
        print(f"saving checkpoint to {dest}...")
        save_checkpoint(dest, self.train_state())
        print("success!")
