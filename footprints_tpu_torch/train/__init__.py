"""Training: losses, steps, checkpoint-compatible state, trainer
(counterpart of footprints_tpu/train/).  ``trainer`` is imported by name
(``from footprints_tpu_torch.train.trainer import TrainManager``)."""

from .losses import LossConfig, compute_losses
from .step import (TrainStepConfig, build_eval_step, build_train_step,
                   make_lr_schedule, make_optimizer)

__all__ = ["LossConfig", "TrainStepConfig", "build_eval_step",
           "build_train_step", "compute_losses", "make_lr_schedule",
           "make_optimizer"]
