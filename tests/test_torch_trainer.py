"""The port's trainer end to end on the CPU: ``main --mode train --device
cpu`` over a synthetic KITTI tree (FootprintNetwork-18 at 64x64, batch 8,
one epoch of one step): losses finite, a checkpoint per epoch, resume from
it, the SIGTERM interrupt checkpoint, and the log cadence of the JAX
trainer."""

import os
import signal

import numpy as np
import pytest
import torch

from footprints_tpu.train.trainer import log_cadence as jax_log_cadence
from footprints_tpu_torch import main as port_main
from footprints_tpu_torch.checkpoint import load_checkpoint
from footprints_tpu_torch.options import Options
from footprints_tpu_torch.ops import fused_conv as fc
from footprints_tpu_torch.train.trainer import TrainManager, log_cadence

from .test_trainer_e2e import _make_kitti_tree


def _argv(root, config, *extra):
    return ["--mode", "train", "--training_dataset", "kitti",
            "--height", "64", "--width", "64",
            "--batch_size", "8", "--epochs", "1", "--num_workers", "2",
            "--val_batches", "1", "--log_freq", "1000000",
            "--config_path", str(config), "--log_path", str(root / "logs"),
            "--split_root", str(root / "splits"),
            "--encoder_depth", "18", "--model_name", "tiny", "--device", "cpu",
            *extra]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    return root, _make_kitti_tree(root)


def test_main_trains_checkpoints_and_resumes(tree, capsys):
    root, config = tree
    argv = _argv(root, config, "--model_name", "main")
    manager = port_main.main(argv)
    out = capsys.readouterr().out
    assert "Epoch 0 -- Batch 0 -- Loss" in out and "validating..." in out
    # step 0 logs to the console and validates (0 % log_freq == 0)
    assert [(mode, step) for mode, step, _ in manager.logged] == [("train", 0), ("val", 0)]
    for _, _, losses in manager.logged:
        assert len(losses) == 21 and all(np.isfinite(v) for v in losses.values())
    weights = root / "logs" / "main" / "models" / "weights_0"
    ckpt = load_checkpoint(str(weights / "checkpoint.npz"))
    assert int(ckpt["step"]) == 1
    assert int(ckpt["opt_state"][0][0]) == 1
    assert np.isfinite(ckpt["opt_state"][0][1]).all()
    assert np.abs(ckpt["opt_state"][0][1]).max() > 0

    tm = TrainManager(Options().parse(argv + ["--load_path", str(weights)]))
    assert tm.step == 1
    assert len(tm.model_manager.optimizer.state) == sum(
        p.requires_grad for p in tm.model_manager.net.parameters())
    # the CPU run uses the plain versions: no kernel launch
    assert fc.fused_conv3x3.launches == 0


def test_sigterm_writes_the_interrupt_checkpoint(tree):
    root, config = tree
    argv = _argv(root, config, "--model_name", "preempt", "--epochs", "2")
    tm = TrainManager(Options().parse(argv))
    orig_step, fired = tm.train_step, []

    def step_then_sigterm(step, batch):
        out = orig_step(step, batch)
        if not fired:
            fired.append(1)
            os.kill(os.getpid(), signal.SIGTERM)  # handled in this thread
        return out

    tm.train_step = step_then_sigterm
    tm.train()
    models = root / "logs" / "preempt" / "models"
    assert (models / "weights_interrupt" / "checkpoint.npz").exists()
    assert not (models / "weights_0").exists()
    assert tm._preempt_requested
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    tm2 = TrainManager(Options().parse(argv + ["--load_path",
                                               str(models / "weights_interrupt")]))
    assert tm2.step == 1


def test_profile_dir_writes_a_trace_of_steps_10_to_15(tree, tmp_path):
    root, config = tree
    argv = _argv(root, config, "--model_name", "profiled", "--batch_size", "1",
                 "--epochs", "2", "--profile_dir", str(tmp_path / "trace"))
    manager = port_main.main(argv)
    assert manager.step == 16
    assert (tmp_path / "trace" / "train_steps_10_15.json").stat().st_size > 0


def test_log_cadence_matches_jax():
    for log_freq in (1, 3, 100, 250, 333):
        for step in range(1001):
            assert log_cadence(step, log_freq) == jax_log_cadence(step, log_freq)


@pytest.mark.parametrize("extra,exc,match", [
    (("--mode", "inference"), NotImplementedError, "batch-dump"),
    (("--compute_dtype", "bfloat16"), NotImplementedError, "mixed-precision"),
    (("--s2d_head", "on"), NotImplementedError, "packed"),
    (("--training_dataset", "matterport"), NotImplementedError, "not ported yet"),
    (("--pretrained_encoder", "download"), NotImplementedError, "not ported yet"),
])
def test_paths_not_ported_yet_raise(tree, extra, exc, match):
    root, config = tree
    with pytest.raises(exc, match=match):
        port_main.main(_argv(root, config, *extra))


def test_default_device_is_cuda(tree):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device would run")
    root, config = tree
    argv = [a for a in _argv(root, config) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main.main(argv)
