"""The two cells added with FootprintNetwork-50: ``fp50-kitti.train.b12``
and ``fp-kitti.dump.b16``.  The R50 reference's FLOPs and the fused
kernel's sites pinned; the readers of the encoder-stage and post-concat
spans on synthetic stores; each fault of the new cells turning ``correct``
false on the CPU; and, on the card, the half-batch fault failing one of
the R50 train cell's limits.  The helpers are the existing tests' own."""

import math
import sys

import pytest

import flops
import harness
import test_portbench_card as card
import test_portbench_cpu_run as cpu_run
import tiny_cells
from footprints_tpu_torch import telemetry
from test_portbench_flops import config_model, site_bound_s
from test_portbench_spans import measure, read, span

TRAIN_CELLS = ["fp-kitti.train.b12", "fp50-kitti.train.b12"]


def test_resnet50_footprint_network():
    """FootprintNetwork-50 from its own reference: the Bottleneck encoder's
    FLOPs, and the kernel's 16 sites with block2's skip half at the 1/8
    feature's 512 channels (128 under ResNet-34)."""
    fp50 = config_model("footprints-r50-kitti")
    assert flops.forward_flops(fp50, 192, 640, False) == 64_939_622_400
    assert flops.forward_flops(fp50, 192, 640, True) == 65_134_264_320
    assert flops.train_flops(fp50, 192, 640) == 194_824_765_440
    sites = {s[0]: s[1:] for s in flops.sites(fp50, 12, 192, 640)}
    assert len(sites) == 16
    for d in ("mask_decoder", "depth_decoder"):
        assert sites[f"{d}.block2.post.conv1.skip_half"] == (
            "reflect", (12, 24, 80, 512), 128, True, True)
        assert sites[f"{d}.block2.post.conv1.up_half"] == (
            "up2_reflect", (12, 12, 40, 128), 128, False, False)
        # block4's skip is the stem's 64 channels under either encoder
        assert sites[f"{d}.block4.post.conv1.skip_half"] == (
            "reflect", (12, 96, 320, 64), 64, True, True)
    skip = ("", *sites["mask_decoder.block2.post.conv1.skip_half"])
    assert flops.site_flops(skip) == 2 * 9 * 512 * 128 * 12 * 24 * 80
    assert math.isclose(flops.forward_bound_s(skip, "float32"),
                        site_bound_s(12, 24, 80, 512, 128, False, True, True))


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_encoder_stage_and_post_concat_readers(cell, monkeypatch):
    spans = [span("encoder.layer1", 1000, 1010, 1.0), span("encoder.layer2", 1010, 1020, 2.0),
             span("encoder.layer3", 1020, 1030, 3.0), span("encoder.layer4", 1030, 1040, 4.0),
             span("encoder", 1000, 1040, 11.0), span("decoder.post_concat", 1040, 1050, 0.5),
             span("decoder.post_concat", 1050, 1060, 1.5),
             # outside the stretch
             span("encoder.layer1", 100, 200, 9.0), span("decoder.post_concat", 2100, 2200, 9.0)]
    m = measure(cell, spans, monkeypatch, units=12)
    assert math.isclose(read("encoder_stages_ms_per_img.train", m), 10.0 / 12)
    assert math.isclose(read("post_concat_ms_per_img.train", m), 2.0 / 12)
    spans[2] = span("encoder.layer3", 1020, 1030, None)  # one stage not timed
    assert read("encoder_stages_ms_per_img.train", measure(cell, spans, monkeypatch)) is None


NEW = ["encoder_stages_ms_per_img.train", "post_concat_ms_per_img.train"]


@pytest.mark.parametrize("name", NEW)
def test_nothing_recorded_reads_nothing(name, monkeypatch):
    monkeypatch.setattr(telemetry, "totals", lambda: {})
    m = measure("fp-kitti.train.b12", [], monkeypatch)
    assert read(name, m) is None
    m.trace = None
    assert read(name, m) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_telemetry_reads_nothing(name, monkeypatch):
    m = measure("fp-kitti.train.b12", [span("encoder.layer1", 1010, 1090, 3.0),
                                       span("decoder.post_concat", 1100, 1200, 1.0)],
                monkeypatch)
    monkeypatch.setitem(sys.modules, "footprints_tpu_torch.telemetry", None)
    assert read(name, m) is None


@pytest.mark.parametrize("name", NEW)
def test_entries_read_the_program_spans(name):
    entry = next(m for m in harness.benchmark()["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span" and entry["workloads"] == TRAIN_CELLS
    for cell in entry["workloads"]:
        assert entry in harness.cell(cell).per_layer


TRAIN_FAULTS = {
    "state_unchanged": (cpu_run.train_step, "build_train_step", cpu_run.state_unchanged),
    "half_batch": (cpu_run.train_step, "build_train_step",
                   cpu_run.step_wrapped(cpu_run.half_batch_step)),
    "answer_altered": (cpu_run.train_step, "build_train_step",
                       cpu_run.step_wrapped(cpu_run.loss_altered))}
DUMP_FAULTS = {
    "answer_altered": (cpu_run.inference.InferenceManager, "forward", cpu_run.answer_altered),
    "half_batch": (cpu_run.inference.InferenceManager, "forward", cpu_run.half_rows)}
FAULTS = {"fp-kitti.dump.b16": DUMP_FAULTS, "fp50-kitti.train.b12": TRAIN_FAULTS}
# The new cells' faults join the registry that
# test_portbench_cpu_run.py::test_every_cell_has_its_faults holds against
# every cell of BENCHMARK.json; they are run below.
cpu_run.FAULTS.update(FAULTS)


@pytest.mark.parametrize("name,fault", [(c, f) for c, faults in FAULTS.items() for f in faults])
def test_fault_turns_correct_false(monkeypatch, name, fault):
    owner, attr, breaker = FAULTS[name][fault]
    monkeypatch.setattr(owner, attr, breaker(getattr(owner, attr)))
    result = tiny_cells.run(name)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", card.SEEDS)
def test_half_batch_fails_a_limit_on_the_card(seed):
    cell, drv = card.cell_on_card("fp50-kitti.train.b12")
    checks = drv.half_batch(card.context(cell, seed))
    assert any(value > cell.limits[key] for key, value in checks.items()), checks

