"""``graph_replay_pct``, the share of the traced stretch's requests that a
CUDA graph's replay served, on synthetic spans: a forward counts when a
``predict.graph.replay`` span is its child; spans outside the stretch are
left out; no forward reads nothing."""

import math
import sys

import pytest

import devtrace
import harness
from footprints_tpu_torch import telemetry

NAME = "graph_replay_pct.predict"


def span(name, id_, start, end, parent=None):
    return telemetry.Span(name=name, id=id_, parent=parent, thread=1, unit=id_,
                          start_ns=start, end_ns=end)


def read(spans, monkeypatch):
    monkeypatch.setattr(telemetry, "spans", lambda: list(spans))
    trace = devtrace.Trace(window=(1000, 2000), device=[], host=[], units=4)
    m = harness.Measure(cell=harness.cell("fp-kitti.predict.b1"), window_s=1.0, units=4,
                        trace=trace, flops_per_unit=1.0)
    return harness.metric_reader(NAME).read(m)


def forwards(replayed):
    """A forward and a fetch a request at 1100, 1300, ...; a replay inside
    each forward whose index is in ``replayed``."""
    out = []
    for i in range(4):
        start = 1100 + 200 * i
        out += [span("predict.forward", 10 * i + 1, start, start + 100),
                span("predict.fetch", 10 * i + 3, start + 100, start + 150)]
        if i in replayed:
            out.append(span("predict.graph.replay", 10 * i + 2, start + 50, start + 90,
                            parent=10 * i + 1))
    return out


@pytest.mark.parametrize("replayed,want", [((), 0.0), ((0, 1, 2, 3), 100.0),
                                           ((1, 3), 50.0)])
def test_the_share_of_forwards_with_a_replay(replayed, want, monkeypatch):
    assert math.isclose(read(forwards(replayed), monkeypatch), want)


def test_spans_outside_the_stretch_are_left_out(monkeypatch):
    # the warm-up's capture and its replay, before the stretch
    outside = [span("predict.forward", 100, 200, 400),
               span("predict.graph.capture", 101, 210, 350, parent=100),
               span("predict.graph.replay", 102, 360, 390, parent=100)]
    assert math.isclose(read(outside + forwards((2,)), monkeypatch), 25.0)


def test_no_forward_reads_nothing(monkeypatch):
    assert read([], monkeypatch) is None
    assert read([span("predict.graph.replay", 2, 1100, 1200)], monkeypatch) is None
    monkeypatch.setitem(sys.modules, "footprints_tpu_torch.telemetry", None)
    assert read(forwards((0,)), monkeypatch) is None


def test_the_entry_reads_the_program_spans_of_the_predict_cell():
    entry = next(m for m in harness.benchmark()["per_layer"] if m["name"] == NAME)
    assert entry["source"] == "program_span" and entry["layer"] == "host dispatch"
    assert entry["workloads"] == ["fp-kitti.predict.b1"]
    assert entry in harness.cell("fp-kitti.predict.b1").per_layer
