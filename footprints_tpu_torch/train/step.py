"""Training and evaluation steps (counterpart of footprints_tpu/train/step.py).

One train step is forward (train-mode BN), the 4-scale loss, backward and
the optimizer update, on one device.  Loss scalars stay on the device; the
trainer fetches them at its log cadence.

Optimizer contract (reference model_manager.py:27-28): Adam at lr 1e-4 with
StepLR every 10 epochs, gamma 0.1, as a step schedule
``lr * gamma ** (step // max(10 * steps_per_epoch, 1))`` evaluated at the
step count *before* the update, as optax's ScaleBySchedule does.
``torch.optim.Adam`` computes optax.adam's update: bias-corrected moments,
``eps`` added to the corrected root.
"""

import dataclasses

import torch

from .losses import LossConfig, compute_losses

_F32 = (None, "float32", "f32")
_MIXED = ("bfloat16", "bf16")


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    learning_rate: float = 1e-4
    scheduler_step_epochs: int = 10
    scheduler_gamma: float = 0.1
    steps_per_epoch: int = 1  # converts the epoch-based StepLR to steps
    loss: LossConfig = LossConfig()
    # None/'float32': full f32, TF32 off (reference parity)
    compute_dtype: str | None = None

    def __post_init__(self):
        if self.compute_dtype in _MIXED:
            raise NotImplementedError(
                "bfloat16 mixed-precision training is not ported yet; it "
                "arrives with the mixed-precision slice (with the s2d/p4 heads)")
        if self.compute_dtype not in _F32:
            raise ValueError(f"compute_dtype={self.compute_dtype!r} not "
                             f"supported; one of {_F32 + _MIXED}")


def make_lr_schedule(config: TrainStepConfig):
    """StepLR as a step-indexed schedule: lr * gamma^(step // boundary)."""
    boundary = max(config.scheduler_step_epochs * config.steps_per_epoch, 1)

    def schedule(step):
        return config.learning_rate * config.scheduler_gamma ** (step // boundary)

    return schedule


def make_optimizer(net, config: TrainStepConfig):
    """Adam over the parameters of the JAX pytree: the decoders' unused BN
    modules are frozen and left out.  foreach: a few multi-tensor kernels
    per step instead of several per parameter."""
    return torch.optim.Adam([p for p in net.parameters() if p.requires_grad],
                            lr=config.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            foreach=True)


def build_train_step(net, optimizer, config: TrainStepConfig):
    """Returns step_fn(step, batch) -> metrics, which runs one update.

    ``step`` is the count of updates so far (it picks the learning rate);
    the caller advances it.  ``batch``: {'image': [N,H,W,3], 'depth',
    'visible_ground', 'all_ground', 'ground_depth', 'depth_mask',
    'moving_object_mask': [N,H,W]} on the net's device.  ``metrics`` holds
    the detached device loss scalars and 'lr' (a float).
    """
    schedule = make_lr_schedule(config)

    def step_fn(step, batch):
        lr = schedule(step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        net.train()
        outputs = net(batch["image"])
        losses = compute_losses(outputs, batch, config.loss)
        optimizer.zero_grad(set_to_none=True)
        losses["loss"].backward()
        optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["lr"] = lr
        return metrics

    return step_fn


def build_eval_step(net, config: TrainStepConfig):
    """Returns eval_fn(batch) -> losses dict: eval-mode BN, no gradient."""

    def eval_fn(batch):
        net.eval()
        with torch.no_grad():
            outputs = net(batch["image"])
            return compute_losses(outputs, batch, config.loss)

    return eval_fn
