"""Phase timing and the port's span recorder.

``PhaseTimer`` is the port's copy of ``timed_design_tpu/utils/timing.py``'s:
named phases (datasetmap, predict, decode, write) accumulate wall seconds;
``summary`` returns them as a dict. Each phase is also a ``span``.

The recorder is one per process and off by default. Off, ``span`` and
``device_span`` return one shared object that does nothing, and ``count``
adds nothing. ``recording()`` turns it on for a block and yields a
``Recording`` that holds, once the block exits:

- ``spans``: ``Span`` tuples; start and end from ``time.perf_counter_ns``
  (the clock ``time.perf_counter`` reads), the thread's name, the span
  open on the same thread when it opened (its ``parent``, an ``index``),
  and the caller's ``id`` (a batch or step number);
- ``device_spans``: (name, id, milliseconds) between a pair of CUDA events
  recorded on the current stream around the block;
- ``counters``: name -> total.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
import typing as t

import torch


class Span(t.NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: str
    index: int
    parent: int | None
    id: t.Any


class Recording:
    """What one ``recording()`` block kept; filled while it is open."""

    def __init__(self):
        self.spans: list[Span] = []
        self.device_spans: list[tuple] = []
        self.counters: dict[str, int] = {}
        self.closed = False
        self._lock = threading.Lock()
        self._stacks = threading.local()
        self._index = itertools.count()

    def _stack(self) -> list:
        stack = getattr(self._stacks, "open", None)
        if stack is None:
            stack = self._stacks.open = []
        return stack

    def _finish(self) -> None:
        """Stop keeping, then read the device spans' times (waiting for
        their end events: the only synchronisation the recorder does)."""
        self.closed = True
        timed = []
        for name, id_, start, end in self.device_spans:
            end.synchronize()
            timed.append((name, id_, start.elapsed_time(end)))
        self.device_spans = timed


class _Off:
    """The span of a recorder that is off: one shared object, no work."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_active: Recording | None = None


class _HostSpan:
    __slots__ = ("rec", "name", "id", "start", "index", "parent")

    def __init__(self, rec: Recording, name: str, id_):
        self.rec, self.name, self.id = rec, name, id_

    def __enter__(self):
        stack = self.rec._stack()
        self.parent = stack[-1] if stack else None
        self.index = next(self.rec._index)
        stack.append(self.index)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.rec._stack().pop()
        if not self.rec.closed:
            self.rec.spans.append(Span(self.name, self.start, end,
                                       threading.current_thread().name, self.index,
                                       self.parent, self.id))
        return False


class _DeviceSpan:
    __slots__ = ("rec", "name", "id", "start")

    def __init__(self, rec: Recording, name: str, id_):
        self.rec, self.name, self.id = rec, name, id_

    def __enter__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()
        return self

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        if not self.rec.closed:
            self.rec.device_spans.append((self.name, self.id, self.start, end))
        return False


def is_recording() -> bool:
    return _active is not None


def span(name: str, id=None):
    """A host span around a block, kept while recording is on."""
    rec = _active
    return _OFF if rec is None else _HostSpan(rec, name, id)


def device_span(name: str, id=None, *, device: torch.device):
    """The device time of the work a block queues on the current stream:
    a pair of CUDA events, kept while recording is on and ``device`` is a
    card, and not while the stream is being captured into a graph."""
    rec = _active
    if rec is None or device.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return _OFF
    return _DeviceSpan(rec, name, id)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    rec = _active
    if rec is not None:
        with rec._lock:
            rec.counters[name] = rec.counters.get(name, 0) + n


def traced(name: str):
    """Decorator: every call of the function is a ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def recording():
    """Turn the recorder on for the block; yields its ``Recording``."""
    global _active
    if _active is not None:
        raise RuntimeError("the span recorder is already recording")
    rec = _active = Recording()
    try:
        yield rec
    finally:
        _active = None
        rec._finish()


def chrome_trace(rec: Recording) -> dict:
    """A finished recording in Chrome's trace-event format: each host span
    a complete event (microseconds of ``perf_counter``), one track a
    thread; the device spans' milliseconds and the counters under
    ``otherData``."""
    pid = os.getpid()
    events = [{"name": s.name, "ph": "X", "ts": s.start_ns / 1e3,
               "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid, "tid": s.thread,
               "args": {} if s.id is None else {"id": s.id}} for s in rec.spans]
    device_ms: dict[str, list[float]] = {}
    for name, _, ms in rec.device_spans:
        device_ms.setdefault(name, []).append(ms)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"device_ms": device_ms, "counters": dict(rec.counters)}}


class PhaseTimer:
    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, id=None):
        t0 = time.perf_counter()
        try:
            with span(name, id):
                yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> dict[str, float]:
        return dict(self.phases)
