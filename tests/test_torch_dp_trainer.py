"""Both trainers under torchrun on the CPU: ``python -m
torch.distributed.run --standalone --nproc_per_node 2 -m
footprints_tpu_torch.main --mode train --device cpu`` (and the same for
``preprocessing.segmentation.main``) over the tiny trees of
tests/test_torch_trainer.py and tests/test_torch_seg_train.py: finite
logged losses, equal on both ranks (they are the ranks' mean), one
checkpoint written by rank 0 and resumed by a world of one; a SIGTERM to
one rank stops both after the same step with one interrupt checkpoint;
and ``dryrun_multichip(2, device="cpu")`` at a small size.  Every subprocess has a
timeout."""

import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from footprints_tpu_torch.checkpoint import load_checkpoint
from footprints_tpu_torch.options import Options
from footprints_tpu_torch.parallel.dryrun import dryrun_multichip, free_port
from footprints_tpu_torch.preprocessing.segmentation.options import Options as SegOptions
from footprints_tpu_torch.preprocessing.segmentation.trainer import Trainer
from footprints_tpu_torch.train.trainer import TrainManager

from .test_torch_seg_train import _argv as seg_argv
from .test_torch_seg_train import _make_trees
from .test_torch_trainer import _argv
from .test_trainer_e2e import _make_kitti_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
# a float and no more: where the other rank's message follows with no
# newline between, its "Epoch" must not be read as an exponent
NUMBER = r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?|nan|inf"


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    # unbuffered: the ranks share one pipe, and a print is then one write
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    return env


def _torchrun(module, argv, cwd):
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", module, *argv],
        cwd=cwd, env=_env(), capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return proc.stdout


def test_main_trains_under_torchrun_and_resumes_at_world_1(tmp_path):
    config = _make_kitti_tree(tmp_path, n_train=16)
    argv = _argv(tmp_path, config, "--model_name", "dp", "--log_freq", "1")
    out = _torchrun("footprints_tpu_torch.main", argv, tmp_path)
    losses = re.findall(rf"Epoch 0 -- Batch 0 -- Loss ({NUMBER})", out)
    assert len(losses) == 2 and losses[0] == losses[1] and np.isfinite(float(losses[0]))
    # each rank's message, wherever it lands: the two ranks share the pipe,
    # and a message and its newline are two writes
    ranks = re.findall(r"data parallel: (rank \d+ of \d+ on \S+ over (?:gloo|nccl))", out)
    assert sorted(ranks) == [
        "rank 0 of 2 on cpu over gloo", "rank 1 of 2 on cpu over gloo"]
    assert out.count("validating...") == 2
    assert out.count("saving checkpoint to") == 1
    assert sorted(re.findall(r"rank (\d): ", out)) == ["0", "1"]
    weights = tmp_path / "logs" / "dp" / "models" / "weights_0"
    ckpt = load_checkpoint(str(weights / "checkpoint.npz"))
    assert int(ckpt["step"]) == 2 and int(ckpt["opt_state"][0][0]) == 2
    tm = TrainManager(Options().parse(argv + ["--load_path", str(weights)]))
    assert tm.mesh.world_size == 1 and tm.step == 2
    assert len(tm.model_manager.optimizer.state) == sum(
        p.requires_grad for p in tm.model_manager.net.parameters())


def test_segmentation_main_trains_under_torchrun_and_resumes(tmp_path):
    _, config = _make_trees(tmp_path)
    argv = seg_argv(tmp_path, str(config), "--device", "cpu", "--model_name", "dp",
                    "--log_freq", "1")
    out = _torchrun("footprints_tpu_torch.preprocessing.segmentation.main", argv, tmp_path)
    # each rank's message, wherever it lands: the two ranks share the pipe,
    # and a message and its newline are two writes
    ranks = re.findall(r"data parallel: (rank \d+ of \d+ on \S+ over (?:gloo|nccl))", out)
    assert sorted(ranks) == [
        "rank 0 of 2 on cpu over gloo", "rank 1 of 2 on cpu over gloo"]
    train = re.findall(rf"Epoch 0 -- Step (\d+) -- Train Loss ({NUMBER}) -- Val Loss ({NUMBER})",
                       out)
    # 8 training images (5 ADE20K, 3 Cityscapes) at a global batch of 2: 4
    # steps, each logged by both ranks
    assert len(train) == 8 and all(np.isfinite(float(v)) for t in train for v in t[1:])
    for step in ("0", "1", "2", "3"):
        lines = [t for t in train if t[0] == step]
        assert len(lines) == 2 and lines[0] == lines[1]
    assert out.count("saved ") == 1
    ckpt = tmp_path / "logs" / "dp" / "models" / "epoch_0"
    trainer = Trainer(SegOptions().parse(argv + ["--load_path", str(ckpt)]))
    assert trainer.mesh.world_size == 1
    params = load_checkpoint(str(ckpt / "checkpoint.npz"))["params"]
    np.testing.assert_array_equal(
        trainer.net.encoder.layer0[0].weight.detach().numpy().transpose(2, 3, 1, 0),
        params["encoder"]["stem_conv"]["w"])


def test_sigterm_to_one_rank_stops_both_at_one_step(tmp_path):
    """Two ranks started with torchrun's environment; SIGTERM to rank 1
    once rank 0 has written epoch 0's checkpoint."""
    config = _make_kitti_tree(tmp_path)
    argv = _argv(tmp_path, config, "--model_name", "preempt", "--epochs", "1000",
                 "--batch_size", "4")
    port = str(free_port())
    procs = []
    for rank in range(2):
        env = _env()
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "footprints_tpu_torch.main", *argv], cwd=tmp_path,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    models = tmp_path / "logs" / "preempt" / "models"
    try:
        deadline = time.monotonic() + TIMEOUT
        while not (models / "weights_0" / "checkpoint.npz").exists():
            assert time.monotonic() < deadline and all(p.poll() is None for p in procs)
            time.sleep(0.2)
        procs[1].send_signal(signal.SIGTERM)
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert [p.returncode for p in procs] == [0, 0], outs
    steps = [re.findall(r"preemption checkpoint saved at step (\d+)", o) for o in outs]
    assert len(steps[0]) == 1 and steps[0] == steps[1], outs
    assert "SIGTERM received" in outs[1] and "SIGTERM received" not in outs[0]
    assert sum(o.count("weights_interrupt/checkpoint.npz...") for o in outs) == 1
    ckpt = load_checkpoint(str(models / "weights_interrupt" / "checkpoint.npz"))
    assert int(ckpt["step"]) == int(steps[0][0]) >= 2


def test_dryrun_multichip_small():
    results = dryrun_multichip(2, device="cpu", height=64, width=96, depth=18)
    assert len(results) == 2
    for kind in ("f32", "bf16"):
        assert len({r[kind]["digest"] for r in results}) == 1
        assert len({r[kind]["loss"] for r in results}) == 1
        assert np.isfinite(results[0][kind]["loss"])
        # the CPU runs the plain version: no kernel launch
        assert all(r[kind]["launches"] == 0 for r in results)
