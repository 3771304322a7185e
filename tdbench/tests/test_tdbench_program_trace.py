"""The program's spans in a traced window (``program_trace.py``): the
readers of the program's metrics on hand-made records, the idle time split
by span and the gaps' names on hand-made intervals, and on the card the
check that the program's spans and the device trace share one clock."""
from __future__ import annotations

import math

import pytest
import torch

from conftest import ROOT  # noqa: F401  (puts the checkout on sys.path)
from tdbench import harness, program_trace


@pytest.fixture(autouse=True)
def _no_last_window(monkeypatch):
    monkeypatch.setattr(program_trace, "_last", {})


def _predict_record():
    # one pass of 10 s; a predict phase of 4 s; spans on the main thread
    # and the writer's; the device spans' milliseconds; the counters
    spans = [("frame_set", 0, 6e6, "MainThread", None),
             ("frame_set.parse", 0, 2e6, "MainThread", None),
             ("frame_set.frame_atoms", 2e6, 5e6, "MainThread", None),
             ("frame_set.index", 5e6, 5.5e6, "MainThread", None),
             ("predict", 6e6, 10e6, "MainThread", None),
             ("fetch_wait", 7e6, 8e6, "MainThread", 0),
             ("fetch_wait", 8e6, 9e6, "MainThread", 1),
             ("write_batch", 8e6, 8.5e6, "csv-writer", 0)]
    return {"kind": "predict", "passes": [{"frames": 100, "wall_s": 10.0, "frame_set_s": 6.0,
                                           "timings": {"predict": 4.0}}],
            "spans": spans,
            "device_spans": [("voxelize", 0, 2.0), ("voxelize", 1, 4.0), ("voxelize", 2, 3.0),
                             ("forward", 0, 30.0), ("forward", 1, 32.0)],
            "counters": {"voxelize.pairs_real": 750, "voxelize.pairs_computed": 1000},
            "idle_by_span": {"": 0.5, "frame_set.parse": 1.5, "frame_set.frame_atoms": 3.0}}


def _train_record():
    spans = [("train.next_batch", 0, 1000, "MainThread", 5),
             ("train.step", 1000, 3000, "MainThread", 5),
             ("train.next_batch", 3000, 7000, "MainThread", 6),
             ("train.step", 7000, 8000, "MainThread", 6),
             ("train.step", 8000, 8500, "MainThread", 4),  # its batch came before the window
             ("train.next_batch", 8500, 9500, "MainThread", 7)]  # the loader ran dry
    return {"kind": "train", "spans": spans,
            "device_spans": [("train.step_device", 5, 35.0), ("train.step_device", 6, 36.0),
                             ("train.step_device", 4, 34.0), ("voxelize", 0, 1.5),
                             ("voxelize", 1, 2.5)],
            "counters": {"voxelize.pairs_real": 600, "voxelize.pairs_computed": 800},
            "idle_by_span": {"": 0.0}}


def read(name, record):
    return harness.load_reader(name).read(record)


def test_predict_readers_on_a_hand_made_record():
    r = _predict_record()
    assert math.isclose(read("predict.parse_share", r), 20.0)
    assert math.isclose(read("predict.frame_atoms_share", r), 30.0)
    assert math.isclose(read("predict.frame_index_share", r), 5.0)
    assert read("predict.voxelize_device_ms", r) == 3.0
    assert read("predict.forward_device_ms", r) == 31.0
    assert math.isclose(read("predict.voxelize_pad_share", r), 25.0)
    assert math.isclose(read("predict.fetch_wait_share", r), 50.0)
    assert math.isclose(read("predict.writer_busy_share", r), 12.5)
    assert math.isclose(read("predict.idle_unspanned_share", r), 10.0)
    for name in ("train.step_device_ms", "train.batch_host_ms", "train.voxelize_device_ms",
                 "train.voxelize_pad_share"):
        assert read(name, r) is None, name


def test_train_readers_on_a_hand_made_record():
    r = _train_record()
    assert read("train.step_device_ms", r) == 35.0
    assert read("train.batch_host_ms", r) == 4.0  # steps 5 and 6: 3 and 5 ms
    assert read("train.voxelize_device_ms", r) == 2.0
    assert math.isclose(read("train.voxelize_pad_share", r), 25.0)
    assert read("predict.voxelize_pad_share", r) is None


NEW = ("predict.parse_share", "predict.frame_atoms_share", "predict.frame_index_share",
       "predict.voxelize_device_ms", "predict.forward_device_ms", "predict.voxelize_pad_share",
       "predict.fetch_wait_share", "predict.writer_busy_share", "predict.idle_unspanned_share",
       "train.step_device_ms", "train.batch_host_ms", "train.voxelize_device_ms",
       "train.voxelize_pad_share")


@pytest.mark.parametrize("kind", ["predict", "train"])
def test_readers_read_nothing_without_the_programs_spans(kind):
    """What a program without the recorder leaves: what `kinds/` put in the record alone."""
    record = {"kind": kind, "passes": [{"frames": 1, "wall_s": 1.0, "frame_set_s": 0.5,
                                        "timings": {"predict": 0.5}}], "step_ms": [1.0]}
    assert all(read(name, record) is None for name in NEW)
    empty = {**record, "spans": [], "device_spans": [], "counters": {}, "idle_by_span": {}}
    assert all(read(name, empty) is None for name in NEW)


def test_readers_fall_back_to_the_last_window(monkeypatch):
    r = _predict_record()
    monkeypatch.setattr(program_trace, "_last", {k: r.pop(k) for k in (
        "spans", "device_spans", "counters", "idle_by_span")})
    assert math.isclose(read("predict.parse_share", r), 20.0)


def test_idle_by_span_on_hand_made_intervals():
    # device busy 0-10, 30-40, 70-80 of a 100 us window; spans: a pass 0-100
    # holding parse 5-35 and predict 50-90, with fetch_wait 60-75 inside it
    events = [(0, 10, "k"), (30, 40, "k"), (70, 80, "k")]
    spans = [(0, 100, "pass"), (5, 35, "parse"), (50, 90, "predict"), (60, 75, "fetch_wait")]
    got = program_trace.idle_by_span(events, 100, spans)
    want = {"": 0.0, "parse": 20e-6, "pass": 20e-6, "predict": 20e-6, "fetch_wait": 10e-6}
    assert got.keys() == want.keys()
    assert all(math.isclose(got[k], want[k], abs_tol=1e-15) for k in want)
    # idle outside every span goes to ""
    got = program_trace.idle_by_span(events, 120, [(5, 35, "parse")])
    assert math.isclose(got[""], 70e-6) and math.isclose(got["parse"], 20e-6)


def test_innermost_pieces_of_nested_spans():
    pieces = program_trace.innermost([(0, 10, "a"), (2, 4, "b"), (4, 6, "c"), (12, 14, "d")])
    assert pieces == [(0, 2, "a"), (2, 4, "b"), (4, 6, "c"), (6, 10, "a"), (12, 14, "d")]


def test_gaps_are_named_by_the_innermost_program_span():
    """The benchmark's span first, the program's main-thread spans after it
    in order of start: ``idle_gaps`` names each gap by the innermost."""
    events = [(0, 10, "k"), (30, 40, "k"), (70, 80, "k")]
    spans = [(0, 100, "td-predict pass")] + sorted(
        [(5, 35, "frame_set"), (6, 25, "frame_set.parse"), (50, 85, "predict")],
        key=lambda x: (x[0], -x[1]))
    gaps = harness.idle_gaps(events, 100, spans)
    assert gaps == [["predict", 30e-6], ["frame_set.parse", 20e-6], ["td-predict pass", 20e-6]]


def test_window_record_in_the_windows_microseconds():
    from timed_design_tpu_torch.utils.timing import Recording, Span

    rec = Recording()
    rec.spans = [Span("next_batch", 2_000_500, 2_000_900, "MainThread", 0, None, 3),
                 Span("write_batch", 2_000_600, 2_000_700, "csv-writer", 1, None, 3)]
    rec.device_spans = [("forward", 3, 31.5)]
    rec.counters = {"voxelize.pairs_real": 1}
    got = program_trace.window_record(rec, 2e-3, [(0.0, 0.2, "k")], 1e-6)
    assert [s[0] for s in got["spans"]] == ["next_batch", "write_batch"]
    assert all(math.isclose(a, b, abs_tol=1e-9) for a, b in zip(got["spans"][0][1:3], (0.5, 0.9)))
    assert got["spans"][1][3:] == ("csv-writer", 3)
    assert got["device_spans"] == [("forward", 3, 31.5)]
    assert got["counters"] == {"voxelize.pairs_real": 1}
    # idle 0.2-1.0 us; next_batch covers 0.5-0.9 on the main thread
    assert math.isclose(got["idle_by_span"]["next_batch"], 0.4e-6, abs_tol=1e-15)


def test_a_program_without_the_recorder_records_nothing(monkeypatch):
    from timed_design_tpu_torch.utils import timing

    assert program_trace.recorder() is not None
    monkeypatch.delattr(timing, "recording")
    assert program_trace.recorder() is None


def test_install_puts_the_program_trace_in_the_harness(monkeypatch):
    monkeypatch.setattr(harness, "DeviceTrace", harness.DeviceTrace)
    harness.load_reader("predict.parse_share")
    assert harness.DeviceTrace is program_trace.ProgramTrace
    with harness.DeviceTrace(True, torch.device("cpu")) as trace:  # no card: no recording
        pass
    assert trace.program == {} and trace.spans == []


@pytest.mark.cuda
def test_program_spans_and_the_device_trace_share_a_clock(cuda_device):
    """A program span around a sleep kernel and a synchronise: the kernel's
    interval, as ``DeviceTrace`` aligns it, lies inside the span to 50 us."""
    from timed_design_tpu_torch.utils.timing import span

    with program_trace.ProgramTrace(True, cuda_device) as trace:
        with span("sleep"):
            torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
    (s,) = [x for x in trace.program["spans"] if x[0] == "sleep"]
    a, b, _ = max(trace.events, key=lambda e: e[1] - e[0])
    print(f"span {s[1]:.1f}-{s[2]:.1f} us, kernel {a:.1f}-{b:.1f} us: "
          f"starts {a - s[1]:.1f} us in, ends {s[2] - b:.1f} us before")
    assert b - a > 500
    assert s[1] - 50 <= a and b <= s[2] + 50
    assert trace.spans[-1] == (s[1], s[2], "sleep")
