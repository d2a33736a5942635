"""The port's spans: named stretches of the program's work at its layer
boundaries, counted always and recorded in full while a profiler runs.

    with telemetry.span("dump.submit", unit=batch):
        ...

Always, a span adds its host seconds and one count to ``totals()[name]``:
two clock reads and a dict update.  While a ``torch.profiler`` session is
running (a traced stretch of the benchmark, the trainer's
``--profile_dir``, chip_smoke.py's profiles), a span also

  * enters ``record_function(name)``, so that it is a host event of the
    same trace (of the threads the profiler follows: the one that started
    it and autograd's; a span on another thread, such as the dump's
    writer, is in the ring alone unless the session profiles all threads);
  * appends a ``Span`` to a ring of the last ``CAPACITY`` spans: its name,
    id, parent (the span open on the same thread when it began), thread,
    unit (the batch, request or step number; by default its parent's), and
    its start and end in ``time.time_ns()``, the clock on which the
    profiler stamps its host events, so that spans and trace compare
    without conversion;
  * on a CUDA ``device``, records a timing event on that device's current
    stream as it begins and as it ends: ``spans()`` gives the span's
    ``device_ms`` once both have completed.  Not while that stream is
    capturing a CUDA graph (``predict_simple``'s capture of the forward):
    an event recorded there would be part of the graph, so such a span has
    no ``device_ms``.

With no profiler running it does none of these.  Nothing here is a switch:
the profiler's own state decides.
"""

import collections
import dataclasses
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler
from torch.profiler import record_function

CAPACITY = 1 << 15  # spans the ring keeps


@dataclasses.dataclass
class Span:
    name: str
    id: int
    parent: int | None  # id of the span open on this thread when it began
    thread: int
    unit: object
    start_ns: int  # time.time_ns(), the profiler's clock
    end_ns: int = 0
    device_ms: float | None = None  # between its events, once they completed
    events: tuple | None = dataclasses.field(default=None, repr=False)


Total = collections.namedtuple("Total", "seconds count")

_lock = threading.Lock()
_totals = {}  # name -> [host seconds, count]
_ring = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()  # .open: this thread's recorded spans, innermost last


def _open():
    try:
        return _local.open
    except AttributeError:
        _local.open = []
        return _local.open


class span:
    """A context manager: the span ``name`` over the body (module doc).
    ``device``: where the body queues work (CUDA: timed by events while
    tracing).  ``unit``: the batch, request or step the body works on."""

    __slots__ = ("name", "device", "unit", "_t0", "_record", "_span")

    def __init__(self, name, *, device=None, unit=None):
        self.name, self.device, self.unit = name, device, unit

    def __enter__(self):
        self._span = self._begin() if _profiler._is_profiler_enabled else None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        if self._span is not None:
            self._end(self._span)
        with _lock:
            total = _totals.get(self.name)
            if total is None:
                _totals[self.name] = [seconds, 1]
            else:
                total[0] += seconds
                total[1] += 1
        return False

    def _begin(self):
        stack = _open()
        parent = stack[-1] if stack else None
        unit = self.unit if self.unit is not None or parent is None else parent.unit
        self._record = record_function(self.name)
        self._record.__enter__()
        s = Span(self.name, next(_ids), parent and parent.id, threading.get_ident(), unit,
                 time.time_ns())
        if (self.device is not None and torch.device(self.device).type == "cuda"
                and not torch.cuda.is_current_stream_capturing()):
            s.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            s.events[0].record(torch.cuda.current_stream(self.device))
        stack.append(s)
        return s

    def _end(self, s):
        if s.events is not None:
            s.events[1].record(torch.cuda.current_stream(self.device))
        s.end_ns = time.time_ns()
        self._record.__exit__(None, None, None)
        _open().remove(s)
        with _lock:
            _ring.append(s)


def current_unit():
    """The unit of the innermost span recorded on this thread, else None
    (a thread that hands work to another passes it along)."""
    stack = _open() if _profiler._is_profiler_enabled else None
    return stack[-1].unit if stack else None


def totals():
    """{name: Total(host seconds, count)} of every span closed so far in
    this process, traced or not."""
    with _lock:
        return {name: Total(*t) for name, t in _totals.items()}


def spans():
    """The ring's spans in the order they began, each with ``device_ms``
    once its events have completed."""
    with _lock:
        out = list(_ring)
        for s in out:
            if s.events is not None and s.events[1].query():
                s.device_ms = s.events[0].elapsed_time(s.events[1])
                s.events = None
    return sorted(out, key=lambda s: s.id)


def reset(capacity=CAPACITY):
    """Forget every total and recorded span; keep at most ``capacity``."""
    global _ring
    with _lock:
        _totals.clear()
        _ring = collections.deque(maxlen=capacity)
