"""The readers of the program's spans on synthetic stores and traces: they
keep the spans inside the traced stretch, do their arithmetic, read the
process's totals, and give nothing where the program recorded nothing or
has no telemetry module (an older checkout)."""

import math
import sys

import pytest

import devtrace
import harness
from footprints_tpu_torch import telemetry

Span = telemetry.Span


def span(name, start, end, device_ms=None, unit=None):
    return Span(name=name, id=start, parent=None, thread=1, unit=unit, start_ns=start,
                end_ns=end, device_ms=device_ms)


def measure(cell, spans, monkeypatch, window=(1000, 2000), units=4):
    monkeypatch.setattr(telemetry, "spans", lambda: list(spans))
    trace = devtrace.Trace(window=window, device=[], host=[], units=units)
    return harness.Measure(cell=harness.cell(cell), window_s=1.0, units=units, trace=trace,
                           flops_per_unit=1.0)


def read(name, m):
    return harness.metric_reader(name).read(m)


def test_dump_readers(monkeypatch):
    spans = [span("dump.submit", 1000, 1100), span("dump.save", 1100, 1150),
             span("dump.wait", 1150, 1900), span("dump.submit", 1200, 1300),
             span("writer.write", 1150, 1250), span("writer.write", 1200, 1400),
             span("writer.write", 1500, 1600),
             span("decoder", 1010, 1090, 3.0), span("decoder", 1210, 1290, 5.0),
             # outside the stretch: the window's and set-up's spans
             span("dump.submit", 500, 900), span("decoder", 2100, 2200, 7.0),
             span("writer.write", 1900, 2100)]
    for cell in ("fp-kitti.dump.b12", "seg-kitti.dump.b12"):
        m = measure(cell, spans, monkeypatch)
        assert math.isclose(read("dump_host_ms_per_img.dump", m), 250e-6 / 4)
        # the union of 1150-1400 and 1500-1600 over the 1000-ns stretch
        assert math.isclose(read("writer_busy_pct.dump", m), 100 * 350 / 1000)
        assert math.isclose(read("decoder_ms_per_img.dump", m), 8.0 / 4)


def test_device_time_is_read_only_when_every_span_was_timed(monkeypatch):
    spans = [span("decoder", 1010, 1090, 3.0), span("decoder", 1210, 1290, None)]
    assert read("decoder_ms_per_img.dump", measure("fp-kitti.dump.b12", spans,
                                                   monkeypatch)) is None
    spans = [span("step.backward", 1100, 1500, 20.0, unit=7),
             span("step.backward", 1500, 1900, 22.0, unit=8),
             span("step.forward", 1000, 1100, 9.0, unit=7)]
    m = measure("fp-kitti.train.b12", spans, monkeypatch, units=24)
    assert math.isclose(read("backward_ms_per_img.train", m), 42.0 / 24)


def test_predict_issue_is_the_mean_forward(monkeypatch):
    spans = [span("predict.forward", 1000, 1300, unit=0), span("predict.fetch", 1300, 1400),
             span("predict.forward", 1400, 1500, unit=1), span("predict.forward", 10, 20)]
    m = measure("fp-kitti.predict.b1", spans, monkeypatch, units=2)
    assert math.isclose(read("predict_issue_ms.predict", m), 200e-6)


def test_model_build_reads_the_process_totals(monkeypatch):
    m = measure("fp-kitti.predict.b1", [], monkeypatch)
    monkeypatch.setattr(telemetry, "totals",
                        lambda: {"model.build": telemetry.Total(4.5, 1)})
    assert read("model_build_s", m) == 4.5
    monkeypatch.setattr(telemetry, "totals", lambda: {})
    assert read("model_build_s", m) is None


NEW = ["model_build_s", "dump_host_ms_per_img.dump", "writer_busy_pct.dump",
       "predict_issue_ms.predict", "decoder_ms_per_img.dump", "backward_ms_per_img.train"]


@pytest.mark.parametrize("name", NEW)
def test_nothing_recorded_reads_nothing(name, monkeypatch):
    monkeypatch.setattr(telemetry, "totals", lambda: {})
    m = measure("fp-kitti.train.b12", [], monkeypatch)
    assert read(name, m) is None
    m.trace = None
    assert read(name, m) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_telemetry_reads_nothing(name, monkeypatch):
    m = measure("fp-kitti.dump.b12", [span("decoder", 1010, 1090, 3.0)], monkeypatch)
    monkeypatch.setitem(sys.modules, "footprints_tpu_torch.telemetry", None)
    assert read(name, m) is None


@pytest.mark.parametrize("name", NEW)
def test_entries_read_the_program_spans(name):
    entry = next(m for m in harness.benchmark()["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span" and entry["workloads"]
    for cell in entry["workloads"]:
        assert entry in harness.cell(cell).per_layer
