"""The program's own spans and counters in a traced window.

``ProgramTrace`` is ``harness.DeviceTrace`` that also turns the port's span
recorder (``timed_design_tpu_torch/utils/timing.py``) on for its window.
Afterwards ``program`` holds what the program recorded, on the device
trace's clock: ``spans`` as (name, start_us, end_us, thread, id) from the
device trace's zero (``perf_counter`` as the window's first kernel is
queued), ``device_spans`` as (name, id, ms), ``counters``, and
``idle_by_span``, the device's idle seconds by the innermost span open on
the main thread ("" where none is). The main thread's spans also join
``spans`` after the benchmark's own, so that ``idle_gaps`` names each gap
by the innermost program span open over it, and by the benchmark's span
where the program has none.

A program without the recorder records nothing, and its readers read
nothing. ``install()`` puts ``ProgramTrace`` in ``harness.DeviceTrace``'s
place for the ``kinds/`` modules imported after it: the readers of the
program's metrics call it as ``harness.load_cell`` loads them, before
``run.py`` imports the cell's kind. They read the last window's ``program`` where
their record does not hold it (``of``).
"""
from __future__ import annotations

import statistics
import threading
import time

from . import harness

_last: dict = {}


def recorder():
    """The program's ``recording()`` context, or None for a program
    without one."""
    try:
        from timed_design_tpu_torch.utils.timing import recording
    except ImportError:
        return None
    return recording()


def innermost(spans) -> list:
    """(start, end, name) pieces of the timeline, each under the innermost of
    ``spans`` ((start, end, name) of one thread, nested) open over it."""
    out, stack, t = [], [], float("-inf")
    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, name = stack.pop()
            out.append((t, end, name))
            t = end
        if stack:
            out.append((t, s, stack[-1][1]))
            e = min(e, stack[-1][0])
        stack.append((e, n))
        t = s
    while stack:
        end, name = stack.pop()
        out.append((t, end, name))
        t = end
    return [p for p in out if p[1] > p[0]]


def idle_by_span(intervals, window_us: float, spans) -> dict:
    """The window's idle seconds (no device interval in ``intervals``) by
    the innermost of ``spans`` ((start_us, end_us, name)) open at the
    time; "" holds the idle time under no span."""
    idle, end = [], 0.0
    for a, b, *_ in sorted(intervals):
        if a > end:
            idle.append((end, a))
        end = max(end, b)
    if window_us > end:
        idle.append((end, window_us))
    pieces = innermost(spans)
    out = {"": sum(b - a for a, b in idle) / 1e6}
    j = 0
    for a, b in idle:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            s, e, name = pieces[k]
            share = (min(b, e) - max(a, s)) / 1e6
            out[name] = out.get(name, 0.0) + share
            out[""] -= share
            k += 1
    out[""] = max(out[""], 0.0)
    return out


def window_record(rec, t0_s: float, events, window_s: float) -> dict:
    """A finished program recording in the window's terms (module doc)."""
    spans = [(s.name, s.start_ns / 1e3 - t0_s * 1e6, s.end_ns / 1e3 - t0_s * 1e6, s.thread, s.id)
             for s in rec.spans]
    main = threading.main_thread().name
    on_main = [(a, b, n) for n, a, b, thread, _ in spans if thread == main]
    return {"spans": spans, "device_spans": list(rec.device_spans),
            "counters": dict(rec.counters),
            "idle_by_span": idle_by_span(events, window_s * 1e6, on_main)}


class ProgramTrace(harness.DeviceTrace):
    """``DeviceTrace`` with the program's recording over the same window."""

    def __init__(self, enabled: bool, device):
        super().__init__(enabled, device)
        self.program: dict = {}
        self._recording = None
        self._zero = 0.0

    def __enter__(self):
        if self.enabled:
            import torch

            # the window's first device event is a sleep kernel; a first
            # launch loads the kernel, about 1 ms on the host before it
            # reaches the device: launched once before, it starts at once
            torch.cuda._sleep(1)
        super().__enter__()
        # the marker is queued on an idle device: the device trace's zero
        self._zero = time.perf_counter()
        if self.enabled:
            self._recording = recorder()
            if self._recording is not None:
                self._rec = self._recording.__enter__()
        return self

    def __exit__(self, *exc):
        global _last
        try:
            return super().__exit__(*exc)
        finally:
            if self._recording is not None:
                self._recording.__exit__(None, None, None)
                self._recording = None
                self.program = _last = window_record(self._rec, self._zero, self.events,
                                                     self.window_s)
                main = threading.main_thread().name
                self.spans += sorted(((a, b, n) for n, a, b, thread, _ in self.program["spans"]
                                      if thread == main), key=lambda x: (x[0], -x[1]))


def install() -> None:
    harness.DeviceTrace = ProgramTrace


def of(record: dict) -> dict | None:
    """``record`` with the program's window (its own, else the last
    traced window's); None where there is none."""
    if "spans" not in record:
        if not _last:
            return None
        record = {**record, **_last}
    return record if record["spans"] or record["device_spans"] else None


def span_seconds(record: dict, name: str) -> float:
    return sum(b - a for n, a, b, *_ in record["spans"] if n == name) / 1e6


def pass_share(record: dict, name: str):
    """The share (%) of the passes' wall time in the spans ``name``."""
    r = of(record) if record.get("kind") == "predict" else None
    if r is None or not r.get("passes"):
        return None
    return 100.0 * span_seconds(r, name) / sum(p["wall_s"] for p in r["passes"])


def predict_share(record: dict, name: str):
    """The share (%) of the ``predict`` phase in the spans ``name``."""
    r = of(record) if record.get("kind") == "predict" else None
    if r is None:
        return None
    whole = span_seconds(r, "predict")
    return 100.0 * span_seconds(r, name) / whole if whole else None


def median_device_ms(record: dict, kind: str, name: str):
    r = of(record) if record.get("kind") == kind else None
    ms = [m for n, _, m in r["device_spans"] if n == name] if r else []
    return statistics.median(ms) if ms else None


def pad_share(record: dict, kind: str):
    """The share (%) of the voxelizer's frame-atom pairs that are padding."""
    r = of(record) if record.get("kind") == kind else None
    c = r["counters"] if r else {}
    if not c.get("voxelize.pairs_computed"):
        return None
    return 100.0 * (1.0 - c["voxelize.pairs_real"] / c["voxelize.pairs_computed"])
