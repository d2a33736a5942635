"""Whole runs of every cell on the CPU at a tiny size (the fused kernel's
plain version, the same harness, check and limits): the program agrees
with the plain reference, and each fault the cell can have, planted under
the timed path, turns ``correct`` false."""

import json
import os
import subprocess
import sys

import pytest
import torch

import harness
import tiny_cells

from footprints_tpu_torch import predict_simple
from footprints_tpu_torch.eval import inference
from footprints_tpu_torch.preprocessing.segmentation import inference as seg_inference
from footprints_tpu_torch.train import step as train_step


# At 64x96 and batch 2, train-mode BN takes its statistics over few pixels
# and its backward cancels more than at 192x640 and batch 12: on the CPU
# the worst leaf's gradient gap reads 3e-4 to 3.6e-3 over seeds (1.8e-3 at
# 128x192), where the cell's card readings stay under 7.6e-4.  So the tiny
# run of the train cell is held to this bar; the faults below are held to
# the cell's own limits.
TINY_TRAIN_LIMITS = {"first_loss_gap": 1e-6, "grad_gap": 1e-2, "change_gap": 0.2}


@pytest.mark.parametrize("name", tiny_cells.CELLS)
def test_sound_run_is_correct(name):
    cell = tiny_cells.tiny(name)
    if cell.traffic["driver"] == "train_step":
        cell.limits = TINY_TRAIN_LIMITS
    result = tiny_cells.run(name, cell=cell)
    assert result["correct"], result
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert {m["name"] for m in harness.cell(name).end_to_end} == set(result["metrics"])
    for row in result["checks"].values():
        assert 0 <= row["value"] <= row["limit"]


def test_traced_run_on_the_cpu():
    result = tiny_cells.run("fp-kitti.predict.b1", trace=1)
    assert result["correct"]
    assert set(result["metrics"]) <= {m["name"] for m in harness.cell(
        "fp-kitti.predict.b1").per_layer}
    assert result["device"]["window_s"] > 0 and "breakdown" in result


def altered(output):
    """An answer altered where it is produced: one pixel of every map."""
    output = output.clone() if torch.is_tensor(output) else output.copy()
    output[:, 0, 0] += 0.1
    return output


def answer_altered(forward):
    return lambda self, x: altered(forward(self, x))


def half_rows(forward):
    """Half of each batch computed; its other rows copies of the first."""
    def broken(self, images):
        out = forward(self, images[:len(images) // 2])
        return torch.cat([out, out])
    return broken


def step_wrapped(wrap):
    """``build_train_step`` replaced by one whose step is ``wrap(step)``."""
    return lambda build: lambda net, opt, config, mesh=None: wrap(build(net, opt, config,
                                                                        mesh))


def state_unchanged(build):
    """The step computes its loss and returns the state as it found it."""
    return lambda net, opt, config, mesh=None: (
        lambda step, batch: train_step.build_eval_step(net, config)(batch))


def half_batch_step(step_fn):
    return lambda step, batch: step_fn(step, {k: v[:len(v) // 2] for k, v in batch.items()})


def loss_altered(step_fn):
    """The step's loss altered where the step returns it."""
    return lambda step, batch: {**(m := step_fn(step, batch)), "loss": m["loss"] * 1.001}


FAULTS = {
    "fp-kitti.dump.b12": {
        "answer_altered": (inference.InferenceManager, "forward", answer_altered),
        "half_batch": (inference.InferenceManager, "forward", half_rows)},
    "seg-kitti.dump.b12": {
        "answer_altered": (seg_inference.Tester, "forward", answer_altered),
        "half_batch": (seg_inference.Tester, "forward", half_rows)},
    "fp-kitti.predict.b1": {
        "answer_altered": (predict_simple.InferenceManager, "_forward", answer_altered)},
    "fp-kitti.train.b12": {
        "state_unchanged": (train_step, "build_train_step", state_unchanged),
        "half_batch": (train_step, "build_train_step", step_wrapped(half_batch_step)),
        "answer_altered": (train_step, "build_train_step", step_wrapped(loss_altered))},
}


@pytest.mark.parametrize("name,fault", [(c, f) for c, faults in FAULTS.items() for f in faults])
def test_fault_turns_correct_false(monkeypatch, name, fault):
    owner, attr, breaker = FAULTS[name][fault]
    monkeypatch.setattr(owner, attr, breaker(getattr(owner, attr)))
    result = tiny_cells.run(name)
    assert not result["correct"], result["checks"]


def test_every_cell_has_its_faults():
    assert set(FAULTS) == set(tiny_cells.CELLS)


def test_no_jax_in_a_run():
    """A run in a fresh process loads the port and neither JAX nor the JAX
    package (top-level names compared whole)."""
    code = ("import tiny_cells, harness, sys\n"
            "r = tiny_cells.run('seg-kitti.dump.b12')\n"
            "print('LOADED', 'footprints_tpu_torch' in sys.modules, "
            "harness.loaded_forbidden(), r['correct'])\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(__file__), harness.HERE, harness.ROOT]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "LOADED True [] True"


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "footprints_tpu_torch_extra", sys)
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "footprints_tpu.ops", sys)
    assert harness.loaded_forbidden() == ["footprints_tpu"]


def test_run_refuses_without_a_card(tmp_path):
    """Without CUDA, run.py exits with another code than 0 and prints no
    result; also from a directory that holds only the benchmark."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: run.py measures instead")
    for root in (harness.ROOT, tmp_path):
        if root == tmp_path:
            subprocess.run(["cp", "-r", harness.HERE, str(tmp_path)], check=True)
            subprocess.run(["cp", os.path.join(harness.ROOT, "BENCHMARK.json"),
                            str(tmp_path)], check=True)
        proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                               "fp-kitti.predict.b1", "--seed", str(2**31 + 7),
                               "--seconds", "1", "--trace", "0"], cwd=root,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and proc.stdout.strip() == ""
        with pytest.raises(json.JSONDecodeError):
            json.loads(proc.stdout or "x")
