"""Training and evaluation steps (counterpart of footprints_tpu/train/step.py).

One train step is forward (train-mode BN), the 4-scale loss, backward and
the optimizer update, on one device; with a data-parallel mesh
(parallel/mesh.py) each rank runs it on its shard, BN over the global
batch, and the gradients are averaged over the ranks before the update.
On a spatial mesh (``make_mesh(spatial=k)``) each rank computes its rows of
every activation (parallel/halo.py), in the train step as in the eval step:
the backward runs the halo exchanges' adjoints, which add each halo row's
gradient to the rank that owns the row, so the ranks' gradients sum to the
gradient of the sum of their losses, and their mean is the global loss's
(every rank's loss is a mean over an equal shard).
Loss scalars stay on the device; the trainer fetches them at its log
cadence.  With ``compute_dtype`` bfloat16 the forward runs on bf16 compute
copies of the f32 masters (``forward_in``); the loss, the gradients of the masters and Adam's state
stay f32.  The eval step runs in the same dtype and with the same heads.

Optimizer contract (reference model_manager.py:27-28): Adam at lr 1e-4 with
StepLR every 10 epochs, gamma 0.1, as a step schedule
``lr * gamma ** (step // max(10 * steps_per_epoch, 1))`` evaluated at the
step count *before* the update, as optax's ScaleBySchedule does.
``torch.optim.Adam`` computes optax.adam's update: bias-corrected moments,
``eps`` added to the corrected root.
"""

import dataclasses

import torch

from ..parallel.halo import shard_rows
from ..parallel.mesh import all_reduce_gradients, mean_over_ranks
from ..telemetry import span
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
    # None/'float32': full f32, TF32 off (reference parity); 'bfloat16':
    # mixed precision on f32 masters
    compute_dtype: str | None = None
    # the packed '1/1_s2d' and '1/2_s2d2' heads (models/footprint.py),
    # scored against packed targets (train/losses.py)
    s2d_head: bool = False
    p4_head: bool = False

    def __post_init__(self):
        resolve_compute_dtype(self.compute_dtype)  # raises on an unknown name

    @property
    def dtype(self):
        return resolve_compute_dtype(self.compute_dtype)

    @property
    def heads(self):
        """The head flags as keyword arguments of FootprintNetwork.forward."""
        return {"s2d_head": self.s2d_head, "p4_head": self.p4_head}


def resolve_compute_dtype(name):
    """The torch dtype of a ``compute_dtype`` option: float32 for
    None/'float32'/'f32', bfloat16 for 'bfloat16'/'bf16'."""
    if name in _F32:
        return torch.float32
    if name in _MIXED:
        return torch.bfloat16
    raise ValueError(f"compute_dtype={name!r} not supported; one of {_F32 + _MIXED}")


def forward_in(net, image, dtype, kwargs=None):
    """``net(image, **kwargs)`` computed in ``dtype``.  float32 calls the net
    as it is.  bfloat16 is mixed precision with f32 master parameters: the
    forward runs on bf16 compute copies of every parameter (``p.to(bf16)``,
    through ``torch.func.functional_call``) and on the image cast to bf16,
    so gradients flow back through the casts to the f32 masters.  Buffers
    (BN's running statistics) stay the module's f32 tensors, which
    train-mode BN updates in f32 (nn/layers.py:batch_norm).  No autocast:
    every op runs in its inputs' dtype, as in the JAX package's mixed step
    (footprints_tpu/train/step.py, preprocessing/segmentation/trainer.py).
    ``kwargs`` (e.g. the head flags) go to the net's forward."""
    kwargs = kwargs or {}
    if dtype == torch.float32:
        return net(image, **kwargs)
    copies = {n: p.to(dtype) for n, p in net.named_parameters()}
    return torch.func.functional_call(net, copies, (image.to(dtype),), kwargs)


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


def build_train_step(net, optimizer, config: TrainStepConfig, mesh=None):
    """Returns step_fn(step, batch) -> metrics, which runs one update.

    ``step`` is the count of updates so far (it picks the learning rate);
    the caller advances it.  ``batch``: {'image': [N,H,W,3], 'depth',
    'visible_ground', 'all_ground', 'ground_depth', 'depth_mask',
    'moving_object_mask': [N,H,W]} on the net's device, f32, and with the
    packed heads optionally their '@s2d'/'@s2d2' packs.  ``metrics`` holds
    the detached device loss scalars and 'lr' (a float).

    With a distributed ``mesh`` the batch is this rank's shard, on a
    spatial mesh its rows of every image, on which the forward runs
    row-sharded; the gradients are averaged over the ranks after backward
    (the metrics stay this rank's: the trainer averages them at its log
    cadence).

    Its spans (telemetry.py), each with ``step`` as its unit and timed on
    the card while tracing: ``step.forward``, ``step.loss``,
    ``step.backward`` and ``step.optimizer``, with ``all_reduce_gradients``
    between the last two.
    """
    schedule = make_lr_schedule(config)
    dtype, heads = config.dtype, config.heads
    params = [p for p in net.parameters() if p.requires_grad]

    def step_fn(step, batch):
        lr = schedule(step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        net.train()
        device = batch["image"].device
        with shard_rows(net, mesh):
            with span("step.forward", device=device, unit=step):
                outputs = forward_in(net, batch["image"], dtype, heads)
            with span("step.loss", device=device, unit=step):
                losses = compute_losses(outputs, batch, config.loss)
        with span("step.backward", device=device, unit=step):
            optimizer.zero_grad(set_to_none=True)
            losses["loss"].backward()
        if mesh is not None:
            all_reduce_gradients(mesh, params)
        with span("step.optimizer", device=device, unit=step):
            optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["lr"] = lr
        return metrics

    return step_fn


def build_eval_step(net, config: TrainStepConfig, mesh=None):
    """Returns eval_fn(batch) -> losses dict: eval-mode BN, no gradient, in
    the training dtype and with its heads (the loss stays f32).

    With a ``mesh`` the batch is this rank's shard (parallel/mesh.py:
    shard_batch), on a spatial mesh its rows of every image, on which the
    forward runs row-sharded; the losses are the global batch's, the same
    on every rank (each term is a mean over equal shards, so the mean of
    the ranks' terms), as JAX's ``build_eval_step(..., mesh)`` returns them
    replicated."""
    dtype, heads = config.dtype, config.heads

    def eval_fn(batch):
        net.eval()
        with torch.no_grad(), shard_rows(net, mesh):
            outputs = forward_in(net, batch["image"], dtype, heads)
            losses = compute_losses(outputs, batch, config.loss)
        return losses if mesh is None else mean_over_ranks(mesh, losses)

    return eval_fn
