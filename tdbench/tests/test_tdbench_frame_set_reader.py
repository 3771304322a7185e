"""The reader of `predict.frame_set_us_per_atom` (the frame set's host time
an atom record) on hand-made records, and nothing read where the program
does not count the atoms."""
from __future__ import annotations

import math

import pytest

from conftest import ROOT  # noqa: F401  (puts the checkout on sys.path)
from tdbench import harness, program_trace

NAME = "predict.frame_set_us_per_atom"


@pytest.fixture(autouse=True)
def _no_last_window(monkeypatch):
    monkeypatch.setattr(program_trace, "_last", {})


def _record(counters):
    # two passes' frame sets of 0.6 and 0.4 s on the main thread, a parse
    # span inside each (not counted again), a predict phase after
    spans = [("frame_set", 0, 6e5, "MainThread", None),
             ("frame_set.parse", 0, 4e5, "MainThread", None),
             ("predict", 6e5, 9e5, "MainThread", None),
             ("frame_set", 1e6, 1.4e6, "MainThread", None),
             ("frame_set.parse", 1e6, 1.3e6, "MainThread", None)]
    return {"kind": "predict", "passes": [{"frames": 10, "wall_s": 1.0}] * 2, "spans": spans,
            "device_spans": [], "counters": counters, "idle_by_span": {"": 0.0}}


def test_microseconds_an_atom_record():
    read = harness.load_reader(NAME).read
    got = read(_record({"frame_set.atoms": 250_000, "frame_set.python_scans": 0}))
    assert math.isclose(got, 4.0)  # 1 s over 250,000 records


@pytest.mark.parametrize("record", [
    _record({}),  # a program that does not count the atoms (the parent's)
    _record({"frame_set.atoms": 0}),
    {"kind": "predict", "passes": [{"frames": 1, "wall_s": 1.0}]},  # no program window
    {**_record({"frame_set.atoms": 10}), "kind": "train"},
], ids=["no_counter", "no_atoms", "no_window", "train"])
def test_nothing_to_read(record):
    assert harness.load_reader(NAME).read(record) is None


def test_falls_back_to_the_last_window(monkeypatch):
    r = _record({"frame_set.atoms": 500_000})
    monkeypatch.setattr(program_trace, "_last", {k: r.pop(k) for k in (
        "spans", "device_spans", "counters", "idle_by_span")})
    assert math.isclose(harness.load_reader(NAME).read(r), 2.0)
