"""TrainManager, the training orchestrator (counterpart of
footprints_tpu/train/trainer.py; reference training/train.py:42-227).

One card: each step is forward (train-mode BN), loss, backward and Adam on
the device, with the loss scalars kept there until the log cadence.  The
input pipeline is the threaded loader, the compact host->device encoding
(``--host_batch_compact``, 'exact' by default) and a device prefetcher that
copies two batches ahead on a side CUDA stream.  Checkpoints are the JAX
package's ``checkpoint.npz``, with the Adam state and the step counter, so
``--load_path`` resumes the LR schedule.

Cadences match the reference: console log every 100 steps; tensorboard and
validation at steps divisible by both 100 and ``log_freq`` (see
``log_cadence``); a checkpoint per epoch; and a ``weights_interrupt``
checkpoint after the step in flight when SIGTERM arrives.
"""

import os
import signal
import time

import numpy as np
import torch

from ..core.config import load_config, readlines
from ..data import DataLoader, DevicePrefetcher, get_dataset_class
from ..data.compact import BatchCompactor, decompact_on_device
from ..model_manager import ModelManager
from ..utils import sec_to_hm_str, select_device
from .evaluator import Evaluator
from .logger import TimeLogger, Timer, log
from .losses import LossConfig
from .step import TrainStepConfig, build_eval_step, build_train_step

SEED = 10
PROFILE_STEPS = (10, 15)  # --profile_dir traces steps [10, 15)


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
        self.device = select_device(getattr(options, "device", "cuda"))
        if getattr(options, "debug_nans", False):
            torch.autograd.set_detect_anomaly(True)
        for flag in ("s2d_head", "p4_head"):
            if getattr(options, flag, "auto") == "on":
                raise NotImplementedError(
                    f"--{flag} on: the packed training heads are not ported yet")
        self.train_loader, self.val_loader = self.create_dataloaders()
        steps_per_epoch = max(len(self.train_loader), 1)
        print(f"datasets done! train size - {len(self.train_loader.dataset)} images; "
              f"validation size - {len(self.val_loader.dataset)} images")

        self.step_config = TrainStepConfig(
            learning_rate=self.opt.lr,
            steps_per_epoch=steps_per_epoch,
            loss=LossConfig(min_depth=self.opt.depth_range[0],
                            max_depth=self.opt.depth_range[1],
                            footprint_prior_weight=self.opt.footprint_prior),
            compute_dtype=getattr(self.opt, "compute_dtype", None),
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
        print("models done!")

        self._compactor = BatchCompactor(getattr(self.opt, "host_batch_compact", "exact"))
        net = self.model_manager.net
        self.train_step = build_train_step(net, self.model_manager.optimizer,
                                           self.step_config)
        self.eval_step = build_eval_step(net, self.step_config)

        self.evaluator = Evaluator()
        self.logged = []  # (mode, step, averaged losses) at each log event
        try:
            from tensorboardX import SummaryWriter

            root = os.path.join(self.opt.log_path, self.opt.model_name)
            self.train_writer = SummaryWriter(os.path.join(root, "train"))
            self.val_writer = SummaryWriter(os.path.join(root, "val"))
        except ImportError:
            self.train_writer = self.val_writer = None
        self.timer = TimeLogger()

        self.step = self.model_manager.step
        self.num_total_steps = steps_per_epoch * self.opt.epochs
        self.val_iter = iter(self.val_loader)
        self._profiler = None
        print("training setup complete!\n---------------")

    # ------------------------------------------------------------------

    def create_dataloaders(self):
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
        train_dataset = dataset_class(raw_data_path, training_data_path, train_files,
                                      is_train=True, seed=SEED, **common)
        val_dataset = dataset_class(raw_data_path, training_data_path, val_files,
                                    is_train=False, seed=SEED, **common)
        train_loader = DataLoader(train_dataset, self.opt.batch_size, shuffle=True,
                                  num_workers=self.opt.num_workers, seed=SEED)
        val_loader = DataLoader(val_dataset, self.opt.batch_size, shuffle=True,
                                num_workers=min(2, self.opt.num_workers),
                                drop_last=True, seed=SEED)
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
        print("training complete!")

    def _on_preempt(self, signum, frame):
        print("SIGTERM received: will checkpoint after the current step...")
        self._preempt_requested = True

    def run_epoch(self):
        device_iter = DevicePrefetcher(map(self._compactor, self.train_loader),
                                       self.device, depth=2, decode=self._decode)
        for batch_idx, batch in enumerate(device_iter):
            self._profile_at(self.step)
            before = time.time()
            metrics = self.train_step(self.step, batch)
            self.evaluator.accumulate(
                {k: v for k, v in metrics.items() if k != "lr"}, mode="train")
            self.lr = metrics["lr"]
            self.timer.add_time("train_network_time", time.time() - before)

            console, tb_and_val = log_cadence(self.step, self.opt.log_freq)
            if console:
                losses = self.evaluator.get_averaged_losses("train", reset=False)
                self.logged.append(("train", self.step, losses))
                print(f"Epoch {self.epoch} -- Batch {batch_idx} -- "
                      f"Loss {losses.get('loss', float('nan')):.4f}")
                self.timer.print_time()
                elapsed = time.time() - self.start_time
                left = ((self.num_total_steps / self.step - 1.0) * elapsed
                        if self.step else 0)
                print(f"time elapsed/left: {sec_to_hm_str(elapsed)}/"
                      f"{sec_to_hm_str(left)}")

                if tb_and_val:
                    losses = self.evaluator.get_averaged_losses("train", reset=True)
                    with Timer(self.timer, "log_time"):
                        self._log(self.train_writer, batch, losses)
                    self.val()
            self.step += 1
            self.model_manager.step = self.step
            if self._preempt_requested:
                self.model_manager.save_model(folder_name="weights_interrupt")
                print(f"preemption checkpoint saved at step {self.step}")
                return True

        print(f"Epoch {self.epoch} complete!")
        self.model_manager.save_model(folder_name=f"weights_{self.epoch}")
        return False

    def val(self):
        with Timer(self.timer, "val_time"):
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
        with Timer(self.timer, "log_time"):
            self._log(self.val_writer, batch, losses)

    # ------------------------------------------------------------------

    def _decode(self, batch):
        # the scheme is read after the compactor has locked it on this batch
        return decompact_on_device(batch, self._compactor.scheme)

    def _put(self, host_batch):
        """Compact, copy to the device and decode one host batch (in line:
        validation's few batches do not need the prefetcher)."""
        compact = self._compactor(host_batch)
        return self._decode({k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                             for k, v in compact.items()})

    def _log(self, writer, batch, losses):
        if writer is None:
            return
        inputs = outputs = None
        if getattr(self.opt, "log_images", False) and batch is not None:
            net = self.model_manager.net
            was_training = net.training
            net.eval()
            with torch.no_grad():
                outputs = net(batch["image"][:4], scales=("1/1",))["1/1"].cpu().numpy()
            net.train(was_training)
            inputs = {k: v[:4].cpu().numpy() for k, v in batch.items()}
        log(writer, inputs, outputs, losses, float(self.lr), self.step)

    def _profile_at(self, step):
        """--profile_dir: a torch.profiler trace of steps 10 to 14."""
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
