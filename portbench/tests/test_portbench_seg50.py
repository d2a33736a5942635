"""The cell added with Segmentor-50: ``seg50-ade.train.b12``.  The
reference's FLOPs pinned; the readers of the pre-concat and PSP spans on
synthetic stores; each fault of the seg train step turning ``correct``
false on the CPU; and, on the card, the half-batch fault failing one of
the cell's limits.  The helpers are the existing tests' own."""

import math
import sys

import pytest

import flops
import harness
import test_portbench_card as card
import test_portbench_cpu_run as cpu_run
import test_portbench_r50_and_b16 as r50
import tiny_cells
from footprints_tpu_torch import telemetry
from footprints_tpu_torch.preprocessing.segmentation import trainer as seg_trainer
from test_portbench_flops import config_model
from test_portbench_spans import measure, read, span

CELL = "seg50-ade.train.b12"
TRAIN_CELLS = ["fp-kitti.train.b12", "fp50-kitti.train.b12", CELL]
# The cell reports the encoder-stage and post-concat metrics too: their
# entries now list it, which test_portbench_r50_and_b16.py reads from its
# TRAIN_CELLS when it runs.
r50.TRAIN_CELLS.append(CELL)


def test_resnet50_segmentor():
    """Segmentor-50 from its own reference: the forward with every head and
    the train step's FLOPs, the PSP's and block1's 4096-wide entry conv's
    share, and the kernel's sites as flops.sites reads them (8: the
    post-concat blocks of FUSED_BLOCKS and the tail), block2's skip half
    at the 1/8 feature's 512 channels."""
    seg50 = config_model("segmentor-r50-psp-ade")
    assert sum(p.numel() for p in seg50.parameters()) == 43_148_068
    assert flops.forward_flops(seg50, 192, 640, True) == 43_709_005_824
    assert flops.train_flops(seg50, 192, 640) == 130_548_989_952
    counts = flops.conv_flops(seg50, 192, 640)
    # a 1x1 reduce, 2048 -> 512, on each pool's 1, 4, 16 and 36 cells
    assert sum(v for k, v in counts.items() if ".PSP." in k) == 2 * 2048 * 512 * (
        1 + 4 + 16 + 36)
    assert counts["decoder.block1.pre_concat_conv.conv1"] == 2 * 9 * 4096 * 256 * 6 * 20
    sites = {s[0]: s[1:] for s in flops.sites(seg50, 12, 192, 640)}
    assert len(sites) == 8
    assert sites["decoder.block2.post.conv1.skip_half"] == (
        "reflect", (12, 24, 80, 512), 128, True, True)


def test_pre_concat_and_psp_readers(monkeypatch):
    spans = [span("decoder.psp", 1000, 1010, 0.25), span("decoder.pre_concat", 1010, 1020, 1.0),
             span("decoder.post_concat", 1020, 1030, 5.0),
             span("decoder.pre_concat", 1030, 1040, 2.0),
             # outside the stretch
             span("decoder.pre_concat", 100, 200, 9.0), span("decoder.psp", 2100, 2200, 9.0)]
    for cell in TRAIN_CELLS:
        m = measure(cell, spans, monkeypatch, units=12)
        assert math.isclose(read("pre_concat_ms_per_img.train", m), 3.0 / 12)
        assert math.isclose(read("psp_ms_per_img.train", m), 0.25 / 12)
    spans[3] = span("decoder.pre_concat", 1030, 1040, None)  # one block not timed
    assert read("pre_concat_ms_per_img.train", measure(CELL, spans, monkeypatch)) is None
    # the FootprintNetwork has no PSP
    assert read("psp_ms_per_img.train", measure(CELL, spans[1:4], monkeypatch)) is None


NEW = ["pre_concat_ms_per_img.train", "psp_ms_per_img.train"]


@pytest.mark.parametrize("name", NEW)
def test_nothing_recorded_reads_nothing(name, monkeypatch):
    monkeypatch.setattr(telemetry, "totals", lambda: {})
    m = measure(CELL, [], monkeypatch)
    assert read(name, m) is None
    m.trace = None
    assert read(name, m) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_telemetry_reads_nothing(name, monkeypatch):
    m = measure(CELL, [span("decoder.psp", 1010, 1090, 3.0),
                       span("decoder.pre_concat", 1100, 1200, 1.0)], monkeypatch)
    monkeypatch.setitem(sys.modules, "footprints_tpu_torch.telemetry", None)
    assert read(name, m) is None


@pytest.mark.parametrize("name,cells", [("pre_concat_ms_per_img.train", TRAIN_CELLS),
                                        ("psp_ms_per_img.train", [CELL])])
def test_entries_read_the_program_spans(name, cells):
    entry = next(m for m in harness.benchmark()["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span" and entry["workloads"] == cells
    assert entry["layer"] == "decoders" and entry["moves"] == "train_imgs_per_s"
    for cell in entry["workloads"]:
        assert entry in harness.cell(cell).per_layer


def test_the_cell_reports_the_train_metrics_but_the_kernels_roofline():
    """Every train metric of the other train cells, and the two new ones,
    but ``fused_conv3x3_roofline.train``, whose reader counts the kernel's
    backward only for the FootprintNetwork's driver."""
    names = {m["name"] for m in harness.cell(CELL).per_layer}
    fp50 = {m["name"] for m in harness.cell("fp50-kitti.train.b12").per_layer}
    assert names == (fp50 - {"fused_conv3x3_roofline.train"}) | set(NEW)
    assert {m["name"] for m in harness.cell(CELL).end_to_end} == {"train_imgs_per_s",
                                                                  "setup_s"}


def seg_step_wrapped(wrap):
    """The seg ``build_train_step`` replaced by one whose step is
    ``wrap(step)``."""
    return lambda build: lambda net, opt, schedule, dtype=None, mesh=None: wrap(
        build(net, opt, schedule, *(() if dtype is None else (dtype,)), mesh=mesh))


def seg_state_unchanged(build):
    """The step computes its loss and returns the state as it found it."""
    return lambda net, opt, schedule, dtype=None, mesh=None: (
        lambda step, batch: seg_trainer.build_eval_step(net)(batch))


SEG_FAULTS = {
    "state_unchanged": (seg_trainer, "build_train_step", seg_state_unchanged),
    "half_batch": (seg_trainer, "build_train_step",
                   seg_step_wrapped(cpu_run.half_batch_step)),
    "answer_altered": (seg_trainer, "build_train_step", seg_step_wrapped(cpu_run.loss_altered))}
FAULTS = {CELL: SEG_FAULTS}
# The cell's faults join the registry that
# test_portbench_cpu_run.py::test_every_cell_has_its_faults holds against
# every cell of BENCHMARK.json; they are run below.
cpu_run.FAULTS.update(FAULTS)


@pytest.mark.parametrize("fault", list(SEG_FAULTS))
def test_fault_turns_correct_false(monkeypatch, fault):
    owner, attr, breaker = SEG_FAULTS[fault]
    monkeypatch.setattr(owner, attr, breaker(getattr(owner, attr)))
    result = tiny_cells.run(CELL)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", card.SEEDS)
def test_half_batch_fails_a_limit_on_the_card(seed):
    cell, drv = card.cell_on_card(CELL)
    checks = drv.half_batch(card.context(cell, seed))
    assert any(value > cell.limits[key] for key, value in checks.items()), checks
