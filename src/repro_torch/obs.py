"""Spans and counters of the port, in memory, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` session records: the
switch is the profiler itself, as an operator already uses it to look at
kernels.  There is no other switch.

- ``span(name, *, uid=None, device=False, sink=None)`` is a context
  manager.  Tracing off, it costs one ``_profiler_enabled()`` check and
  does nothing else: no ``record_function``, no timing event, no host-device
  sync, nothing stored; with a ``sink`` list it still appends its host
  duration (``time.perf_counter``) to it.  Tracing on, it records its name,
  start and end in nanoseconds on the profiler's clock (``time.time_ns``:
  the profiler's event times, ``trace_start_ns() + time_range.start * 1e3``,
  are on that clock), its parent (the innermost span open when it began),
  ``uid`` (a request's id) and, with ``device=True`` on a card, a pair of
  timing events on the current stream, resolved only when the spans are
  read.  It also opens a profiler range of the same name (``_range``:
  ``record_function``'s lighter form where torch has it), which lands in
  the profiler's trace on the device trace's clock.
- ``count(name, n)`` adds ``n`` to a counter keyed by the innermost open
  phase span (``PHASES``, else ``"other"``).  A tensor ``n`` adds the sum of
  its elements, taken on its device, and ``.item()`` runs only when the
  counters are read.  Tracing off, it records nothing and computes nothing.
- ``spans()`` and ``counters()`` return what the latest profiler session
  recorded in the calling thread: the first span or count recorded after a
  check that found tracing off starts the recorder afresh.  The recorder
  is the thread's own (the profiler's state is per thread too), so a
  thread that is not traced, such as the daemon's tuner beside a traced
  serve loop, neither resets nor joins another thread's records.

The spans (each module's docstring says what its spans cover):
``engine.step``, ``engine.queued(uid)``, ``engine.prefill(uid)``,
``engine.decode``, ``engine.sample`` (``serve/engine.py``); ``train.step``,
``train.forward``, ``train.backward``, ``train.optimizer``
(``train/step.py``); ``model.moe_ffn`` (``models/moe.py``).  The counters:
``moe.pairs``, ``moe.rows``, ``moe.kept`` (``models/moe.py``);
``matmul.acol`` (launches that stage A along M: the bf16 weight gradient)
and ``matmul.splits`` (their K splits) (``kernels/matmul.py``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

_enabled = torch._C._autograd._profiler_enabled
# a profiler range: the C++ form costs a fraction of record_function's
_range = getattr(torch._C._profiler, "_RecordFunctionFast", None) \
    or torch.autograd.profiler.record_function

# the spans that key the counters, innermost first
PHASES = ("engine.prefill", "engine.decode", "train.step")


@dataclass
class Span:
    """A recorded span: ``start_ns``/``end_ns`` on the profiler's clock,
    ``parent`` the index of its parent in ``spans()`` (None at a root),
    ``device_ms`` the device time between its events (None without)."""
    name: str
    start_ns: int
    end_ns: int = 0
    parent: Optional[int] = None
    uid: Optional[int] = None
    device_ms: Optional[float] = None
    events: list = field(default_factory=list, repr=False)

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Recorder(threading.local):
    """What one profiler session recorded in this thread."""

    def __init__(self):
        self.stale = True   # this thread's last check found tracing off
        self.spans: List[Span] = []
        self.stack: List[int] = []
        self.counts: Dict[str, Dict[str, object]] = {}

    def on(self) -> bool:
        """Whether tracing is on; the first check that finds it on after
        one that found it off starts afresh."""
        if not _enabled():
            self.stale = True
            return False
        if self.stale:
            self.stale = False
            self.spans, self.stack, self.counts = [], [], {}
        return True

    def phase(self) -> str:
        for i in reversed(self.stack):
            if self.spans[i].name in PHASES:
                return self.spans[i].name
        return "other"


_rec = _Recorder()


def _event() -> torch.cuda.Event:
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


class _Off:
    """A span while tracing is off: nothing, or the host time to a sink."""
    __slots__ = ("sink", "t0")

    def __init__(self, sink):
        self.sink = sink

    def __enter__(self):
        if self.sink is not None:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sink is not None:
            self.sink.append(time.perf_counter() - self.t0)
        return False


_OFF = _Off(None)


class _On:
    """A span while tracing is on."""
    __slots__ = ("span", "sink", "device", "rf", "i", "t0")

    def __init__(self, name, uid, device, sink):
        self.span = Span(name, 0, uid=uid)
        self.device, self.sink = device, sink

    def __enter__(self):
        s, rec = self.span, _rec
        self.rf = _range(s.name)
        self.rf.__enter__()
        s.parent = rec.stack[-1] if rec.stack else None
        self.i = len(rec.spans)
        rec.spans.append(s)
        rec.stack.append(self.i)
        if self.device and torch.cuda.is_initialized():
            s.events.append(_event())
        self.t0 = time.perf_counter()
        s.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        rec, s = _rec, self.span
        if s.events:
            s.events.append(_event())
        s.end_ns = time.time_ns()
        if self.sink is not None:
            self.sink.append(time.perf_counter() - self.t0)
        if self.i in rec.stack:
            rec.stack.remove(self.i)
        self.rf.__exit__(None, None, None)
        return False


def span(name: str, *, uid: Optional[int] = None, device: bool = False,
         sink: Optional[list] = None):
    """A context manager over the block: see the module's docstring."""
    if not _rec.on():
        return _OFF if sink is None else _Off(sink)
    return _On(name, uid, device, sink)


def emit(name: str, start_ns: int, *, uid: Optional[int] = None) -> None:
    """Record a span that began at ``start_ns`` (``time.time_ns()``, taken
    whether or not tracing was on) and ends now: a root, with no profiler
    range.  Nothing while tracing is off."""
    if _rec.on():
        _rec.spans.append(Span(name, start_ns, time.time_ns(), uid=uid))


def count(name: str, n) -> None:
    """Add ``n`` (an int, or a tensor's sum, taken where it lies) to the
    counter ``name`` of the innermost open phase span."""
    if not _rec.on():
        return
    if isinstance(n, torch.Tensor):
        n = n.sum()
    c = _rec.counts.setdefault(_rec.phase(), {})
    c[name] = c.get(name, 0) + n


def spans() -> List[Span]:
    """The latest session's spans in this thread, in the order they began,
    each span's device time resolved (which waits for its end event)."""
    for s in _rec.spans:
        if len(s.events) == 2:
            s.events[1].synchronize()
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = []
    return list(_rec.spans)


def counters() -> Dict[str, Dict[str, int]]:
    """{phase: {counter: total}} of the latest session in this thread."""
    return {ph: {k: int(v.item()) if isinstance(v, torch.Tensor) else int(v)
                 for k, v in c.items()} for ph, c in _rec.counts.items()}
