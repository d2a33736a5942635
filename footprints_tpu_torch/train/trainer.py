"""TrainManager, the training orchestrator (counterpart of
footprints_tpu/train/trainer.py; reference training/train.py:42-227).

One card, or one card per process under torchrun (data parallelism,
parallel/): each step is forward (train-mode BN), loss, backward and Adam
on the device, with the loss scalars kept there until the log cadence.
Under torchrun each rank loads only its rows of every global batch of
``--batch_size``, BN takes its statistics over the global batch, the
gradients are averaged over the ranks, and the logged losses are the
ranks' mean; rank 0 alone writes checkpoints and tensorboard, and a SIGTERM
to any rank stops every rank after the same step.  The input pipeline is
the threaded loader, the compact host->device encoding
(``--host_batch_compact``, 'exact' by default) and a device prefetcher that
copies two batches ahead on a side CUDA stream.  Checkpoints are the JAX
package's ``checkpoint.npz``, with the Adam state and the step counter, so
``--load_path`` resumes the LR schedule.  ``--compute_dtype bfloat16``
trains on bf16 compute copies of the f32 masters (train/step.py), and by
default with the packed '1/1_s2d' and '1/2_s2d2' heads, whose targets the
device decode packs (``--s2d_head``/``--p4_head``, see ``resolve_head``).

Cadences match the reference: console log every 100 steps; tensorboard and
validation at steps divisible by both 100 and ``log_freq`` (see
``log_cadence``); a checkpoint per epoch; and a ``weights_interrupt``
checkpoint after the step in flight when SIGTERM arrives.
"""

import itertools
import os
import signal
import time

import numpy as np
import torch

from ..core.config import load_config, readlines
from ..data import DataLoader, DevicePrefetcher, get_dataset_class
from ..data.compact import BatchCompactor, decompact_on_device
from ..model_manager import ModelManager
from ..ops.fused_conv import (fused_conv3x3, fused_conv3x3_dgrad,
                              fused_conv3x3_wgrad)
from ..parallel import (any_rank, barrier, initialize, make_mesh, rank_seed,
                        replicate_tree, sync_batch_norm)
from ..telemetry import span, totals
from ..utils import sec_to_hm_str
from .evaluator import Evaluator
from .logger import log
from .losses import LossConfig
from .losses import TARGET_KEYS
from .step import (TrainStepConfig, build_eval_step, build_train_step,
                   resolve_compute_dtype)

SEED = 10
PROFILE_STEPS = (10, 15)  # --profile_dir traces steps [10, 15)


def resolve_head(flag, compute_dtype):
    """An ``--s2d_head``/``--p4_head`` value -> bool: 'auto' turns the packed
    head on with bfloat16 compute and off with float32, as the JAX trainer
    does (footprints_tpu/train/trainer.py); 'on' and 'off' force it."""
    if flag == "auto":
        return resolve_compute_dtype(compute_dtype) == torch.bfloat16
    return flag == "on"


def log_cadence(step, log_freq):
    """(console, tb_and_val) firing decisions for a train step.

    The reference (training/train.py:161-185) nests the tensorboard and
    validation test inside the every-100-steps console branch, so they fire
    only at steps divisible by both 100 and ``log_freq``."""
    console = step % 100 == 0
    return console, console and step % log_freq == 0


class TrainManager:
    def __init__(self, options):
        print("---------------\nsetting up...")
        self.opt = options
        device = getattr(options, "device", "cuda")
        initialize(device=device)
        self.mesh = make_mesh(device)
        self.device = self.mesh.device
        if self.mesh.distributed:
            print(f"data parallel: {self.mesh}")
        n_dev = self.mesh.world_size
        if self.opt.batch_size % n_dev:
            raise ValueError(f"batch_size {self.opt.batch_size} must divide over "
                             f"{n_dev} devices")
        if getattr(options, "debug_nans", False):
            torch.autograd.set_detect_anomaly(True)
        self.train_loader, self.val_loader = self.create_dataloaders(self.mesh.shard)
        steps_per_epoch = max(len(self.train_loader), 1)
        print(f"datasets done! train size - {len(self.train_loader.dataset)} images; "
              f"validation size - {len(self.val_loader.dataset)} images")

        compute_dtype = getattr(self.opt, "compute_dtype", None)
        self.step_config = TrainStepConfig(
            learning_rate=self.opt.lr,
            steps_per_epoch=steps_per_epoch,
            loss=LossConfig(min_depth=self.opt.depth_range[0],
                            max_depth=self.opt.depth_range[1],
                            footprint_prior_weight=self.opt.footprint_prior),
            compute_dtype=compute_dtype,
            s2d_head=resolve_head(getattr(self.opt, "s2d_head", "auto"), compute_dtype),
            p4_head=resolve_head(getattr(self.opt, "p4_head", "auto"), compute_dtype),
        )
        self.model_manager = ModelManager(
            save_folder=os.path.join(self.opt.log_path, self.opt.model_name, "models"),
            learning_rate=self.opt.lr,
            lr_step_size=10,
            steps_per_epoch=steps_per_epoch,
            depth=getattr(self.opt, "encoder_depth", 34),
            seed=SEED,
            pretrained_encoder=getattr(self.opt, "pretrained_encoder", None),
            device=self.device,
        )
        if self.opt.load_path is not None:
            self.model_manager.load_model(weights_path=self.opt.load_path,
                                          load_optimiser=True)
        net = self.model_manager.net
        sync_batch_norm(net, self.mesh)
        replicate_tree(self.mesh, net)
        replicate_tree(self.mesh, self.model_manager.optimizer)
        print("models done!")

        self._compactor = BatchCompactor(getattr(self.opt, "host_batch_compact", "exact"))
        self.train_step = build_train_step(net, self.model_manager.optimizer,
                                           self.step_config, self.mesh)
        self.eval_step = build_eval_step(net, self.step_config)

        self.evaluator = Evaluator(self.mesh)
        self.logged = []  # (mode, step, averaged losses) at each log event
        self.train_writer = self.val_writer = None
        if self.mesh.rank == 0:
            self._open_writers()

        self.step = self.model_manager.step
        self.num_total_steps = steps_per_epoch * self.opt.epochs
        self.val_iter = iter(self.val_loader)
        self._profiler = None
        print("training setup complete!\n---------------")

    def _open_writers(self):
        try:
            from tensorboardX import SummaryWriter

            root = os.path.join(self.opt.log_path, self.opt.model_name)
            self.train_writer = SummaryWriter(os.path.join(root, "train"))
            self.val_writer = SummaryWriter(os.path.join(root, "val"))
        except ImportError:
            pass

    # ------------------------------------------------------------------

    def create_dataloaders(self, shard=(0, 1)):
        """The train and val loaders of this rank's ``shard`` (rank, world)."""
        dataset = self.opt.training_dataset
        dataset_class = get_dataset_class(dataset)
        self.config = load_config(self.opt.config_path)
        raw_data_path = self.config[dataset]["dataset"]
        training_data_path = self.config[dataset]["training_data"]
        split_root = getattr(self.opt, "split_root", "splits")
        train_files = readlines(os.path.join(split_root, dataset, "train.txt"))
        val_files = readlines(os.path.join(split_root, dataset, "val.txt"))

        common = dict(
            height=self.opt.height, width=self.opt.width,
            no_depth_mask=self.opt.no_depth_mask,
            moving_objects_method=self.opt.moving_objects_method,
            project_down_baseline=self.opt.project_down_baseline,
        )
        # each rank draws its own augmentations (world 1 keeps SEED's draws)
        seed = rank_seed(SEED, shard)
        train_dataset = dataset_class(raw_data_path, training_data_path, train_files,
                                      is_train=True, seed=seed, **common)
        val_dataset = dataset_class(raw_data_path, training_data_path, val_files,
                                    is_train=False, seed=seed, **common)
        train_loader = DataLoader(train_dataset, self.opt.batch_size, shuffle=True,
                                  num_workers=self.opt.num_workers, seed=SEED, shard=shard)
        val_loader = DataLoader(val_dataset, self.opt.batch_size, shuffle=True,
                                num_workers=min(2, self.opt.num_workers),
                                drop_last=True, seed=SEED, shard=shard)
        return train_loader, val_loader

    # ------------------------------------------------------------------

    def train(self):
        print("training...")
        self.start_time = time.time()
        self._preempt_requested = False
        # SIGTERM (preemption): checkpoint at the end of the step in flight
        # instead of losing the epoch
        try:
            prev_handler = signal.signal(signal.SIGTERM, self._on_preempt)
        except ValueError:  # not the main thread (e.g. driven from a test)
            prev_handler = None
        try:
            for self.epoch in range(self.opt.epochs):
                if self.run_epoch():
                    print("training preempted — resume with "
                          "--load_path .../weights_interrupt")
                    return
        finally:
            self._stop_profiler()
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

    def run_epoch(self):
        device_iter = iter(DevicePrefetcher(map(self._compactor, self.train_loader),
                                            self.device, depth=2, decode=self._decode))
        for batch_idx in itertools.count():
            self._profile_at(self.step)
            with span("trainer.loader_wait", unit=self.step):
                batch = next(device_iter, None)
            if batch is None:
                break
            with span("trainer.step", unit=self.step):
                metrics = self.train_step(self.step, batch)
                self.evaluator.accumulate(
                    {k: v for k, v in metrics.items() if k != "lr"}, mode="train")
            self.lr = metrics["lr"]

            console, tb_and_val = log_cadence(self.step, self.opt.log_freq)
            if console:
                losses = self.evaluator.get_averaged_losses("train", reset=False)
                self.logged.append(("train", self.step, losses))
                print(f"Epoch {self.epoch} -- Batch {batch_idx} -- "
                      f"Loss {losses.get('loss', float('nan')):.4f}")
                for name, total in sorted(totals().items()):
                    if name.startswith("trainer."):
                        print(f"  {name}: {total.seconds:.1f}s")
                elapsed = time.time() - self.start_time
                left = ((self.num_total_steps / self.step - 1.0) * elapsed
                        if self.step else 0)
                print(f"time elapsed/left: {sec_to_hm_str(elapsed)}/"
                      f"{sec_to_hm_str(left)}")

                if tb_and_val:
                    losses = self.evaluator.get_averaged_losses("train", reset=True)
                    self._log(self.train_writer, batch, losses)
                    self.val()
            self.step += 1
            self.model_manager.step = self.step
            if any_rank(self.mesh, self._preempt_requested):
                self.save_model("weights_interrupt")
                print(f"preemption checkpoint saved at step {self.step}")
                return True

        print(f"Epoch {self.epoch} complete!")
        self.save_model(f"weights_{self.epoch}")
        return False

    def save_model(self, folder_name):
        """Rank 0 writes the checkpoint; the other ranks wait for it."""
        if self.mesh.rank == 0:
            self.model_manager.save_model(folder_name=folder_name)
        barrier(self.mesh)

    def val(self):
        with span("trainer.val", unit=self.step):
            print("validating...")
            batch = None
            for _ in range(self.opt.val_batches):
                try:
                    host_batch = next(self.val_iter)
                except StopIteration:
                    self.val_iter = iter(self.val_loader)
                    host_batch = next(self.val_iter)
                batch = self._put(host_batch)
                self.evaluator.accumulate(self.eval_step(batch), mode="val")
            print("validation complete!")
        losses = self.evaluator.get_averaged_losses("val", reset=True)
        self.logged.append(("val", self.step, losses))
        self._log(self.val_writer, batch, losses)

    # ------------------------------------------------------------------

    def _decode(self, batch):
        # the scheme is read after the compactor has locked it on this
        # batch; the packed heads' targets are packed here, off the step
        config = self.step_config
        return decompact_on_device(batch, self._compactor.scheme,
                                   TARGET_KEYS if config.s2d_head else (),
                                   TARGET_KEYS if config.p4_head else ())

    def _put(self, host_batch):
        """Compact, copy to the device and decode one host batch (in line:
        validation's few batches do not need the prefetcher)."""
        compact = self._compactor(host_batch)
        return self._decode({k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                             for k, v in compact.items()})

    def _log(self, writer, batch, losses):
        if writer is None:
            return
        with span("trainer.log", unit=self.step):
            inputs = outputs = None
            if getattr(self.opt, "log_images", False) and batch is not None:
                net = self.model_manager.net
                was_training = net.training
                net.eval()
                with torch.no_grad():
                    outputs = net(batch["image"][:4], scales=("1/1",))["1/1"].cpu().numpy()
                net.train(was_training)
                # the logger reads the full-resolution maps, not their packs
                inputs = {k: v[:4].cpu().numpy() for k, v in batch.items() if "@s2d" not in k}
            log(writer, inputs, outputs, losses, float(self.lr), self.step)

    def _profile_at(self, step):
        """--profile_dir: a torch.profiler trace of steps 10 to 14, their
        loader waits included, with the spans of every layer (telemetry.py)."""
        profile_dir = getattr(self.opt, "profile_dir", None)
        if not profile_dir:
            return
        if step == PROFILE_STEPS[0] and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.start()
        elif step == PROFILE_STEPS[1]:
            self._stop_profiler()

    def _stop_profiler(self):
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        os.makedirs(self.opt.profile_dir, exist_ok=True)
        self._profiler.export_chrome_trace(
            os.path.join(self.opt.profile_dir, f"train_steps_{PROFILE_STEPS[0]}"
                                               f"_{PROFILE_STEPS[1]}.json"))
        self._profiler = None
