"""Segmentation Trainer (counterpart of
footprints_tpu/preprocessing/segmentation/trainer.py).

One card, or one card per process under torchrun (data parallelism, as
train/trainer.py): each step is the Segmentor's forward (train-mode BN,
over the global batch under torchrun), the seg loss, backward and Adam on
the device, with the loss scalars kept there until the log cadence.
Defaults are the JAX package's: datasets [ADE20K, cityscapes]
concatenated (the Matterport train list cut to its first 5,000 lines), 20
epochs, Adam at 1e-4 with StepLR every 10 epochs (a
step schedule read before the update, train/step.py), a checkpoint per
epoch (``epoch_<n>/checkpoint.npz``: params and BN state in the JAX
layout, no optimizer state), and ``epoch_interrupt`` after the step in
flight when SIGTERM arrives.

``--compute_dtype bfloat16`` runs the train step's forward on bf16 copies
of the f32 master params (train/step.py:forward_in), with an f32 loss;
validation applies the f32 params to the f32 image whatever the train
dtype.  The loss is logged, and validated, at every step divisible by
``log_freq``, step 0 included.  The input pipeline is the threaded loader,
the compact host->device encoding ('exact': u8 image and masks, bitwise
lossless) and the device prefetcher.
"""

import os
import signal
import time

import numpy as np
import torch

from ...checkpoint import save_checkpoint
from ...convert import init_encoder_from, segmentor_jax_params_from_state_dict
from ...core.config import load_config, readlines
from ...data.compact import BatchCompactor, decompact_on_device
from ...data.loader import DataLoader, DevicePrefetcher
from ...models import Segmentor
from ...ops.fused_conv import (fused_conv3x3, fused_conv3x3_dgrad,
                               fused_conv3x3_wgrad)
from ...parallel import (all_reduce_gradients, any_rank, barrier, initialize, make_mesh,
                         mean_over_ranks, rank_seed, replicate_tree, sync_batch_norm)
from ...parallel.halo import shard_rows, spatial_mesh
from ...telemetry import span
from ...train.evaluator import Evaluator
from ...train.step import (TrainStepConfig, forward_in, make_lr_schedule,
                           make_optimizer, resolve_compute_dtype)
from .datasets import ConcatDataset, get_dataset_class
from .inference import load_segmentor_weights
from .losses import compute_seg_losses

SEED = 10
MATTERPORT_TRAIN_CAP = 5000


def build_train_step(net, optimizer, schedule, dtype=torch.float32, mesh=None):
    """Returns step_fn(step, batch) -> metrics: one update of ``net``.

    ``step`` is the count of updates so far (it picks the learning rate);
    ``batch``: {'image': [N,H,W,3], 'ground_mask', 'labelled_pix': [N,H,W]}
    on the net's device, f32.  The forward runs in ``dtype``
    (``forward_in``).  ``metrics`` holds the detached device loss scalars
    and 'lr' (a float).  With a distributed ``mesh`` the batch is this
    rank's shard and the gradients are averaged over the ranks
    (train/step.py:build_train_step); on a spatial mesh the forward and the
    loss run row-sharded, as in ``build_eval_step``.

    Its spans are train/step.py's (telemetry.py), each with ``step`` as its
    unit and timed on the card while tracing: ``step.forward``,
    ``step.loss``, ``step.backward`` and ``step.optimizer``, with
    ``all_reduce_gradients`` between the last two."""
    params = [p for p in net.parameters() if p.requires_grad]
    rows = spatial_mesh(mesh)

    def step_fn(step, batch):
        lr = schedule(step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        net.train()
        device = batch["image"].device
        with shard_rows(net, mesh):
            with span("step.forward", device=device, unit=step):
                outputs = forward_in(net, batch["image"], dtype)
            with span("step.loss", device=device, unit=step):
                losses = compute_seg_losses(outputs, batch["ground_mask"],
                                            batch["labelled_pix"], rows)
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


def build_eval_step(net, mesh=None):
    """Returns eval_fn(batch) -> losses: eval-mode BN, no gradient, f32.
    With a ``mesh``, the batch is this rank's shard and the losses the
    global batch's, on a spatial mesh computed row-sharded (train/step.py:
    build_eval_step), as the JAX trainer's ``_build_eval_step``."""
    rows = spatial_mesh(mesh)

    def eval_fn(batch):
        net.eval()
        with torch.no_grad(), shard_rows(net, mesh):
            losses = compute_seg_losses(net(batch["image"]), batch["ground_mask"],
                                        batch["labelled_pix"], rows)
        return losses if mesh is None else mean_over_ranks(mesh, losses)

    return eval_fn


class Trainer:
    def __init__(self, options):
        print("setting up...")
        self.opt = options
        device = getattr(options, "device", "cuda")
        initialize(device=device)
        self.mesh = make_mesh(device)
        self.device = self.mesh.device
        if self.mesh.distributed:
            print(f"data parallel: {self.mesh}")
        if self.opt.batch_size % self.mesh.world_size:
            raise ValueError(f"batch_size {self.opt.batch_size} must divide over "
                             f"{self.mesh.world_size} devices")
        self.compute_dtype = resolve_compute_dtype(getattr(options, "compute_dtype", None))

        self.net = Segmentor(depth=getattr(self.opt, "encoder_depth", 34),
                             use_psp=not self.opt.no_PSP, device=self.device,
                             generator=torch.Generator().manual_seed(SEED))
        pretrained = getattr(self.opt, "pretrained_encoder", None)
        if pretrained is not None:
            print(f"initializing encoder from {pretrained}...")
            init_encoder_from(self.net, pretrained)
        if self.opt.load_path is not None:
            load_segmentor_weights(self.net, self.opt.load_path)
        sync_batch_norm(self.net, self.mesh)
        replicate_tree(self.mesh, self.net)

        self.train_loader, self.val_loader = self.create_dataloaders(self.mesh.shard)
        steps_per_epoch = max(len(self.train_loader), 1)
        print(f"training images: {len(self.train_loader.dataset)}; "
              f"validation images: {len(self.val_loader.dataset)}")

        step_config = TrainStepConfig(learning_rate=self.opt.lr,
                                      steps_per_epoch=steps_per_epoch)
        self.schedule = make_lr_schedule(step_config)
        self.optimizer = make_optimizer(self.net, step_config)
        self.train_step = build_train_step(self.net, self.optimizer, self.schedule,
                                           self.compute_dtype, self.mesh)
        self.eval_step = build_eval_step(self.net)

        self.evaluator = Evaluator(self.mesh)
        self.logged = []  # (mode, step, averaged losses) at each log event
        self.train_writer = self.val_writer = None
        if self.mesh.rank == 0:  # rank 0 alone writes tensorboard
            try:
                from tensorboardX import SummaryWriter

                root = os.path.join(self.opt.log_path, self.opt.model_name)
                self.train_writer = SummaryWriter(os.path.join(root, "train"))
                self.val_writer = SummaryWriter(os.path.join(root, "val"))
            except ImportError:
                pass
        self.step = 0
        self.val_iter = iter(self.val_loader)
        self._compactor = BatchCompactor(getattr(self.opt, "host_batch_compact", "exact"))

    def create_dataloaders(self, shard=(0, 1)):
        """The train and val loaders of this rank's ``shard`` (rank, world)."""
        self.config = load_config(self.opt.config_path)
        train_sets, val_sets = [], []
        seed = rank_seed(SEED, shard)  # each rank draws its own augmentations
        split_root = getattr(self.opt, "split_root", "splits")
        for name in self.opt.training_datasets:
            dataset_path = self.config[name]["dataset"]
            train_files = readlines(os.path.join(split_root, name, "train.txt"))
            val_files = readlines(os.path.join(split_root, name, "val.txt"))
            if name == "matterport":
                train_files = train_files[:MATTERPORT_TRAIN_CAP]
            cls = get_dataset_class(name)
            train_sets.append(cls(dataset_path, train_files, self.opt.height,
                                  self.opt.width, is_train=True, seed=seed))
            val_sets.append(cls(dataset_path, val_files, self.opt.height,
                                self.opt.width, is_train=False, seed=seed))
        train_loader = DataLoader(ConcatDataset(train_sets), self.opt.batch_size,
                                  shuffle=True, num_workers=self.opt.num_workers,
                                  seed=SEED, shard=shard)
        val_loader = DataLoader(ConcatDataset(val_sets), self.opt.batch_size,
                                shuffle=True, drop_last=True,
                                num_workers=min(2, self.opt.num_workers), seed=SEED,
                                shard=shard)
        return train_loader, val_loader

    # ------------------------------------------------------------------

    def train(self):
        print("training")
        self.start_time = time.time()
        self._preempt_requested = False
        # SIGTERM (preemption): checkpoint at the end of the step in flight
        try:
            prev_handler = signal.signal(signal.SIGTERM, self._on_preempt)
        except ValueError:  # not the main thread
            prev_handler = None
        try:
            for self.epoch in range(self.opt.epochs):
                if self.run_epoch():
                    print("training preempted — resume from epoch_interrupt")
                    return
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
            self.train_seconds = time.time() - self.start_time
        print(f"training complete! rank {self.mesh.rank}: {fused_conv3x3.launches} "
              f"fused_conv3x3 launches in this process, {fused_conv3x3.bf16_launches} bf16; "
              f"backward: {fused_conv3x3_dgrad.launches} fused_conv3x3_dgrad, "
              f"{fused_conv3x3_wgrad.launches} fused_conv3x3_wgrad")

    def _on_preempt(self, signum, frame):
        print("SIGTERM received: will checkpoint after the current step...")
        self._preempt_requested = True

    def _decode(self, batch):
        # the scheme is read after the compactor has locked it on this batch
        return decompact_on_device(batch, self._compactor.scheme)

    def _put(self, host_batch):
        """Compact, copy to the device and decode one host batch."""
        compact = self._compactor(host_batch)
        return self._decode({k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                             for k, v in compact.items()})

    def run_epoch(self):
        device_iter = DevicePrefetcher(map(self._compactor, self.train_loader),
                                       self.device, depth=2, decode=self._decode)
        for batch in device_iter:
            metrics = self.train_step(self.step, batch)
            self.lr = metrics.pop("lr")
            self.evaluator.accumulate(metrics, mode="train")

            if self.step % self.opt.log_freq == 0:
                tracked = self.evaluator.get_averaged_losses("train", reset=True)
                self.logged.append(("train", self.step, tracked))
                self._log(self.train_writer, tracked, batch)
                val_losses = self.run_validation()
                print(f"Epoch {self.epoch} -- Step {self.step} -- "
                      f"Train Loss {tracked.get('loss', float('nan')):.4f} -- "
                      f"Val Loss {val_losses.get('loss', float('nan')):.4f}")
            self.step += 1
            if any_rank(self.mesh, self._preempt_requested):
                self.save_model(tag="interrupt")
                print(f"preemption checkpoint saved at step {self.step}")
                return True
        self.save_model()
        return False

    def run_validation(self, batches=None):
        batches = batches or self.opt.val_batches
        batch = None
        for _ in range(batches):
            try:
                host_batch = next(self.val_iter)
            except StopIteration:
                self.val_iter = iter(self.val_loader)
                host_batch = next(self.val_iter)
            batch = self._put(host_batch)
            self.evaluator.accumulate(self.eval_step(batch), mode="val")
        tracked = self.evaluator.get_averaged_losses("val", reset=True)
        self.logged.append(("val", self.step, tracked))
        self._log(self.val_writer, tracked, batch)
        return tracked

    def _log(self, writer, losses, batch=None, num_outputs=10):
        if writer is None:
            return
        writer.add_scalar("lr", self.lr, self.step)
        for k, v in losses.items():
            writer.add_scalar(k, float(v), self.step)
        if batch is not None and getattr(self.opt, "log_images", False):
            # [image | gt mask | sigmoid prediction] panels
            import matplotlib.pyplot as plt

            was_training = self.net.training
            self.net.eval()
            with torch.no_grad():
                logits = self.net(batch["image"], scales=("1/1",))[0][..., 0]
            self.net.train(was_training)
            pred = torch.sigmoid(logits).cpu().numpy()
            n = min(num_outputs, pred.shape[0])
            images = batch["image"][:n].cpu().numpy()
            gts = batch["ground_mask"][:n].cpu().numpy()
            cm = plt.get_cmap("plasma")
            for i in range(n):
                strip = np.concatenate([images[i], cm(gts[i])[..., :3],
                                        cm(pred[i])[..., :3]], axis=1)
                writer.add_image(f"panel/{i}", np.transpose(strip, (2, 0, 1)), self.step)

    def save_model(self, tag=None):
        """``<log_path>/<model_name>/models/epoch_<n|tag>/checkpoint.npz``:
        params and BN state in the JAX package's layout.  Rank 0 writes it;
        the other ranks wait for it."""
        if self.mesh.rank != 0:
            barrier(self.mesh)
            return
        save_path = os.path.join(self.opt.log_path, self.opt.model_name, "models")
        params, state = segmentor_jax_params_from_state_dict(
            self.net.state_dict(), self.net.depth, self.net.use_psp)
        dest = os.path.join(save_path, f"epoch_{self.epoch if tag is None else tag}",
                            "checkpoint.npz")
        save_checkpoint(dest, {"params": params, "state": state})
        print(f"saved {dest}")
        barrier(self.mesh)
