"""The port's spans (footprints_tpu_torch/telemetry.py) on the CPU: off, a
span enters no ``record_function`` and records nothing but its totals;
under a profiler session it is a host event of that session, stamped on
the profiler's clock, with its parent, thread and unit; the ring keeps its
bound; and the layers record their spans: the dump loop and its writer,
both train steps, the decoders' blocks and the PSP, predict_simple's call
(eager on the CPU), and the models' construction.  A CUDA span records no event while its stream captures a
graph.  The card's timing events are tested in test_torch_cuda.py."""

import threading

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from footprints_tpu_torch import predict_simple, telemetry
from footprints_tpu_torch.data.loader import BackgroundWriter
from footprints_tpu_torch.eval.inference import dump_predictions
from footprints_tpu_torch.model_manager import ModelManager
from footprints_tpu_torch.models import FootprintNetwork, Segmentor
from footprints_tpu_torch.preprocessing.segmentation import trainer as seg_trainer
from footprints_tpu_torch.train import step as tstep

H, W = 64, 64
CLOCK_SLACK_NS = 50_000  # a span's stamps lie this close inside its host event


@pytest.fixture(autouse=True)
def fresh():
    telemetry.reset()
    yield
    telemetry.reset()


def traced(fn):
    """fn() under a CPU profiler session: (its result, {name: [(start_ns,
    end_ns)]} of the session's host events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return out, events


def named(*names):
    return [s for s in telemetry.spans() if s.name in names]


def test_off_enters_no_record_function_and_records_only_totals(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span off touched the profiler or the card")

    monkeypatch.setattr(telemetry, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    for unit in range(3):
        with telemetry.span("off", device="cuda", unit=unit):
            with telemetry.span("off.inner"):
                pass
    assert telemetry.spans() == []
    assert telemetry.current_unit() is None
    totals = telemetry.totals()
    assert totals["off"].count == 3 and totals["off.inner"].count == 3
    assert 0 <= totals["off.inner"].seconds <= totals["off"].seconds


@pytest.mark.parametrize("capturing", [False, True])
def test_a_cuda_span_records_its_events_unless_the_stream_is_capturing(monkeypatch,
                                                                       capturing):
    """Traced, a span on a CUDA device records a timing event on the
    current stream as it begins and as it ends; while that stream captures
    a CUDA graph it records none (the events would be part of the graph)
    and the span has no device time."""
    recorded = []

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self, stream):
            recorded.append(stream)

        def query(self):
            return False

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: "the stream")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)

    def body():
        with telemetry.span("timed", device="cuda"):
            pass

    traced(body)
    s, = named("timed")
    assert recorded == ([] if capturing else ["the stream", "the stream"])
    assert (s.events is None) == capturing and s.device_ms is None
    assert telemetry.totals()["timed"].count == 1


def test_a_span_is_a_host_event_of_the_session_on_its_clock():
    names = [f"clock.{i}" for i in range(5)]

    def body():
        with telemetry.span("clock.warm"):  # the profiler's first event is slow
            pass
        for name in names:
            with telemetry.span(name):
                torch.ones(64).sum()

    # a span's stamps sit inside its event always; within the slack in one
    # of a few sessions (the host may be preempted between two clock reads)
    for _ in range(3):
        telemetry.reset()
        _, events = traced(body)
        spans = named(*names)
        assert [s.name for s in spans] == names
        slack = []
        for s in spans:
            (start, end), = events[s.name]
            assert start <= s.start_ns <= s.end_ns <= end
            slack += [s.start_ns - start, end - s.end_ns]
        if max(slack) <= CLOCK_SLACK_NS:
            break
    assert max(slack) <= CLOCK_SLACK_NS, slack
    assert telemetry.totals()["clock.0"].count == 1


def test_nested_spans_carry_parent_thread_and_unit():
    def body():
        with telemetry.span("outer", unit=7):
            assert telemetry.current_unit() == 7
            with telemetry.span("inherits"):
                with telemetry.span("own", unit=8):
                    pass
            with telemetry.span("sibling"):
                pass
        with telemetry.span("root"):
            pass

    traced(body)
    s = {x.name: x for x in telemetry.spans()}
    assert s["outer"].parent is None and s["root"].parent is None
    assert s["inherits"].parent == s["outer"].id == s["sibling"].parent
    assert s["own"].parent == s["inherits"].id
    assert (s["outer"].unit, s["inherits"].unit, s["own"].unit, s["sibling"].unit,
            s["root"].unit) == (7, 7, 8, 7, None)
    assert {x.thread for x in s.values()} == {threading.get_ident()}
    assert [x.name for x in telemetry.spans()] == ["outer", "inherits", "own", "sibling",
                                                   "root"]


def test_the_writer_thread_nests_its_own_spans():
    def save():
        with telemetry.span("save.inner"):
            pass

    def body():
        with BackgroundWriter() as writer:
            with telemetry.span("dump.save", unit=3):
                writer.submit(save)
                writer.submit(save)

    traced(body)
    (outer,) = named("dump.save")
    writes, inners = named("writer.write"), named("save.inner")
    assert len(writes) == len(inners) == 2
    for write, inner in zip(writes, inners):
        assert write.thread != outer.thread and write.parent is None
        assert write.unit == 3 and inner.unit == 3
        assert inner.parent == write.id and inner.thread == write.thread


def test_the_ring_keeps_the_last_spans_up_to_its_bound():
    telemetry.reset(capacity=4)

    def body():
        for i in range(10):
            with telemetry.span("ring", unit=i):
                pass

    traced(body)
    assert [s.unit for s in telemetry.spans()] == [6, 7, 8, 9]
    assert telemetry.totals()["ring"].count == 10


def _tiny_loader(batches, batch=2):
    rng = np.random.default_rng(0)
    return [{"image": rng.random((batch, 8, 8, 3), np.float32),
             "idx": list(range(b * batch, (b + 1) * batch))} for b in range(batches)]


@pytest.mark.parametrize("overlap", [True, False])
def test_dump_predictions_records_its_spans(overlap):
    saved = []

    def save_batch(writer, inputs, preds):
        for i, pred in zip(inputs["idx"], preds):
            writer.submit(saved.append, (i, pred.shape))

    _, events = traced(lambda: dump_predictions(
        _tiny_loader(3), lambda x: x.permute(0, 3, 1, 2) * 2, save_batch, batch_size=2,
        device="cpu", overlap=overlap))
    assert len(saved) == 6
    for name in ("dump.submit", "dump.wait", "dump.save"):
        assert [s.unit for s in named(name)] == [0, 1, 2]
        assert len(events[name]) == 3
    writes = named("writer.write")
    assert sorted(s.unit for s in writes) == [0, 0, 1, 1, 2, 2]
    assert all(s.thread != threading.get_ident() for s in writes)
    # the main thread waits for the last saves in a span of its own
    (flush,) = named("writer.flush")
    assert flush.thread == threading.get_ident() and len(events["writer.flush"]) == 1
    assert max(s.end_ns for s in writes) <= flush.end_ns
    # each batch is submitted before it is waited on and saved
    for b in range(3):
        submit, wait, save = (next(s for s in named(n) if s.unit == b)
                              for n in ("dump.submit", "dump.wait", "dump.save"))
        assert submit.end_ns <= wait.start_ns and wait.end_ns <= save.start_ns


def test_dump_predictions_off_counts_its_spans():
    dump_predictions(_tiny_loader(2), lambda x: x, lambda w, i, p: w.submit(len, p),
                     batch_size=2, device="cpu")
    totals = telemetry.totals()
    assert telemetry.spans() == []
    assert [totals[n].count for n in ("dump.submit", "dump.wait", "dump.save",
                                      "writer.write", "writer.flush")] == [2, 2, 2, 2, 1]


def _train_batch(n, seed=5):
    g = torch.Generator().manual_seed(seed)

    def mask(p):
        return (torch.rand(n, H, W, generator=g) < p).float()

    def depth(p):
        return (0.1 + 79.9 * torch.rand(n, H, W, generator=g)) * mask(p)

    return {"image": torch.rand(n, H, W, 3, generator=g), "visible_ground": mask(0.4),
            "all_ground": mask(0.5), "depth": depth(0.7), "ground_depth": depth(0.3),
            "depth_mask": mask(0.2), "moving_object_mask": mask(0.05)}


def test_train_step_records_its_phases_in_order():
    mm = ModelManager(depth=18, device="cpu")
    step_fn = tstep.build_train_step(mm.net, mm.optimizer, mm.config)
    batch = _train_batch(2)
    traced(lambda: step_fn(4, batch))
    phases = ("step.forward", "step.loss", "step.backward", "step.optimizer")
    spans = named(*phases)
    assert [s.name for s in spans] == list(phases)
    assert all(s.unit == 4 and s.parent is None for s in spans)
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))
    # the model's spans nest in the forward and take its unit
    forward = spans[0]
    inner = named("encoder", "decoder")
    assert [s.name for s in inner] == ["encoder", "decoder", "decoder"]
    assert all(s.parent == forward.id and s.unit == 4 for s in inner)
    assert all(s.device_ms is None for s in telemetry.spans())  # no events on the CPU


@pytest.mark.parametrize("depth", [18, 50])
def test_forward_records_the_encoder_stages_and_post_concat_blocks(depth):
    """A FootprintNetwork forward records 12 spans inside its model spans:
    ``encoder.layer1`` ... ``encoder.layer4`` in ``encoder``, and one
    ``decoder.post_concat`` a decoder block in each ``decoder``, on the
    fused route (blocks 2 and 4) as on cuDNN's (blocks 1 and 3)."""
    net = FootprintNetwork(depth).eval()
    with torch.no_grad():
        traced(lambda: net(torch.rand(1, H, W, 3)))
    encoder = named("encoder")
    decoders = named("decoder")
    stages = named(*(f"encoder.layer{i}" for i in range(1, 5)))
    posts = named("decoder.post_concat")
    assert [s.name for s in stages] == [f"encoder.layer{i}" for i in range(1, 5)]
    assert all(s.parent == encoder[0].id for s in stages)
    assert len(posts) == 8 and len(decoders) == 2
    for d in decoders:
        assert sum(s.parent == d.id for s in posts) == 4
    assert telemetry.totals()["decoder.post_concat"].count == 8


def test_seg_train_step_records_its_phases_in_order():
    """The segmentation trainer's step records train/step.py's four phases,
    with its step as their unit; the Segmentor's spans, the PSP's among
    them, nest in the forward."""
    net = Segmentor(18, use_psp=True)
    step_fn = seg_trainer.build_train_step(
        net, tstep.make_optimizer(net, tstep.TrainStepConfig()), lambda step: 1e-4)
    g = torch.Generator().manual_seed(8)
    batch = {"image": torch.rand(2, H, W, 3, generator=g),
             "ground_mask": (torch.rand(2, H, W, generator=g) < 0.4).float(),
             "labelled_pix": (torch.rand(2, H, W, generator=g) < 0.9).float()}
    traced(lambda: step_fn(6, batch))
    phases = ("step.forward", "step.loss", "step.backward", "step.optimizer")
    spans = named(*phases)
    assert [s.name for s in spans] == list(phases)
    assert all(s.unit == 6 and s.parent is None for s in spans)
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))
    inner = named("encoder", "decoder")
    assert [s.name for s in inner] == ["encoder", "decoder"]
    assert all(s.parent == spans[0].id and s.unit == 6 for s in inner)
    (psp,) = named("decoder.psp")
    assert psp.parent == inner[1].id and psp.unit == 6


@pytest.mark.parametrize("use_psp", [True, False])
def test_segmentor_forward_records_the_psp_and_its_blocks(use_psp):
    """A Segmentor forward records one ``decoder.psp`` inside its
    ``decoder`` (none without the PSP), before the decoder's four blocks,
    each a ``decoder.pre_concat`` then a ``decoder.post_concat``."""
    net = Segmentor(18, use_psp=use_psp).eval()
    with torch.no_grad():
        traced(lambda: net(torch.rand(1, H, W, 3)))
    (decoder,) = named("decoder")
    blocks = named("decoder.psp", "decoder.pre_concat", "decoder.post_concat")
    assert [s.name for s in blocks] == ["decoder.psp"] * use_psp + [
        "decoder.pre_concat", "decoder.post_concat"] * 4
    assert all(s.parent == decoder.id for s in blocks)


@pytest.mark.parametrize("depth", [18, 50])
def test_every_decoder_records_its_four_pre_concat_blocks(depth):
    """One ``decoder.pre_concat`` a decoder block, on the fused route
    (block3) as on cuDNN's (blocks 1, 2 and 4), each before its block's
    ``decoder.post_concat``: 4 in each of a FootprintNetwork's decoders."""
    net = FootprintNetwork(depth).eval()
    with torch.no_grad():
        traced(lambda: net(torch.rand(1, H, W, 3)))
    decoders = named("decoder")
    pres = named("decoder.pre_concat")
    assert len(decoders) == 2 and len(pres) == 8
    for d in decoders:
        mine = [s for s in named("decoder.pre_concat", "decoder.post_concat")
                if s.parent == d.id]
        assert [s.name for s in mine] == ["decoder.pre_concat", "decoder.post_concat"] * 4
        assert all(a.end_ns <= b.start_ns for a, b in zip(mine, mine[1:]))
    assert telemetry.totals()["decoder.pre_concat"].count == 8


def test_predict_records_its_call_forward_and_fetch(tmp_path):
    manager = ModelManager(is_inference=True, depth=18, device="cpu")

    class Predictor(predict_simple.InferenceManager):
        def _load_model(self, model_name, model_load_folder, device, height, width):
            self.model_manager, self.device = manager, manager.device
            self.height, self.width = height, width

    serve = Predictor(None, str(tmp_path), save_visualisations=False, height=H, width=W,
                      batch_size=1, device="cpu")
    frame = np.random.default_rng(1).random((H, W, 3), np.float32)
    outs, events = traced(lambda: [serve._predict_batch([frame]) for _ in range(2)])
    assert outs[0].shape == (1, 4, H, W)
    batches = named("predict.batch")
    forwards, fetches = named("predict.forward"), named("predict.fetch")
    assert [s.unit for s in batches] == [s.unit for s in forwards] == [0, 1]
    assert [s.unit for s in fetches] == [0, 1]
    for name in ("predict.batch", "predict.forward", "predict.fetch"):
        assert len(events[name]) == 2
    for batch, forward, fetch in zip(batches, forwards, fetches):
        assert forward.parent == fetch.parent == batch.id
        assert forward.end_ns <= fetch.start_ns
        inner = [s for s in named("encoder", "decoder") if s.parent == forward.id]
        assert [s.name for s in inner] == ["encoder", "decoder", "decoder"]


def test_predict_on_the_cpu_runs_eagerly_and_captures_no_graph(tmp_path, monkeypatch):
    """On the CPU predict_simple's forward is the eager '1/1' forward at
    every input shape: no CUDA graph, no ``predict.graph.*`` span."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU forward touched a CUDA graph")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    manager = ModelManager(is_inference=True, depth=18, device="cpu")

    class Predictor(predict_simple.InferenceManager):
        def _load_model(self, model_name, model_load_folder, device, height, width):
            self.model_manager, self.device = manager, manager.device
            self.height, self.width = height, width

    serve = Predictor(None, str(tmp_path), save_visualisations=False, height=H, width=W,
                      batch_size=1, device="cpu")
    rng = np.random.default_rng(2)
    for shape in ((1, H, W, 3), (2, H, 2 * W, 3), (1, H, W, 3)):
        x = rng.random(shape, np.float32)
        with torch.no_grad():
            want = manager.net(torch.from_numpy(x), scales=("1/1",))["1/1"]
        np.testing.assert_array_equal(serve._forward(x), want.permute(0, 3, 1, 2).numpy())
    assert serve._graphs == {}
    assert not [k for k in telemetry.totals() if k.startswith("predict.graph")]
    assert telemetry.totals()["predict.forward"].count == 3


def test_building_a_model_adds_to_model_build():
    FootprintNetwork(18)
    Segmentor(18, use_psp=True)
    total = telemetry.totals()["model.build"]
    assert total.count == 2 and total.seconds > 0
    assert telemetry.spans() == []
    traced(lambda: Segmentor(18, use_psp=False))
    assert [s.name for s in telemetry.spans()] == ["model.build"]
    assert telemetry.totals()["model.build"].count == 3
