"""The program's own spans (``footprints_tpu_torch/telemetry.py``) as the
readers of per-layer metrics take them: those recorded inside the traced
stretch, on its clock, and the totals of the process.  A checkout of the
program without that module has no spans: there every function here gives
nothing, and its metrics are left out of the result line."""

import importlib

import devtrace


def telemetry():
    """The program's telemetry module, or None where it has none."""
    try:
        return importlib.import_module("footprints_tpu_torch.telemetry")
    except ImportError:
        return None


def total(name):
    """(host seconds, count) of every span ``name`` of the process, or None."""
    t = telemetry()
    return t.totals().get(name) if t is not None else None


def in_stretch(trace, *names):
    """The recorded spans named ``names`` that lie inside the traced stretch."""
    t = telemetry()
    if t is None or trace is None:
        return []
    lo, hi = trace.window
    return [s for s in t.spans() if s.name in names and lo <= s.start_ns and s.end_ns <= hi]


def host_ms(spans):
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6


def busy_s(spans):
    """Seconds in which one of ``spans`` was open: the union of their intervals."""
    return devtrace.union_ns([(s.start_ns, s.end_ns) for s in spans]) / 1e9


def device_ms_per_unit(trace, name):
    """The device time of the spans ``name`` in the stretch, in ms a unit of
    it (an image), or None unless every one of them was timed on the card."""
    spans = in_stretch(trace, name)
    if not spans or not trace.units or any(s.device_ms is None for s in spans):
        return None
    return sum(s.device_ms for s in spans) / trace.units
