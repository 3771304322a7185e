"""The harness on the CPU: BENCHMARK.json against the contract it is
written to, the cells' files found by name, seeded traffic, and the metric
arithmetic on hand-worked cases."""
from __future__ import annotations

import json
import math
import re
import statistics

import numpy as np
import pytest

from conftest import ROOT, bench_with_all_cells
from tdbench import harness, peaks, structures
from tdbench.kinds import design_open_loop

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][:3] == ["python3", "-m", "tdbench.run"]
    assert BENCH["paths"] == ["tdbench"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert [m["bound"] for m in BENCH["end_to_end"] if m["name"] == "setup_s"] == [0.25]
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200


def test_run_seconds_fit_the_checks_budget():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_each_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"], BENCH)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer and all(m["moves"] in reported for m, _ in cell.per_layer)
        assert cell.limits, "every cell compares its answers"
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_config_files_are_whole_and_unreduced():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["reduced"] == [] and cfg["name"] == c["name"]
        assert cfg["forward_flop_per_frame"] == peaks.forward_flop_per_frame(cfg)


@pytest.mark.parametrize("name", sorted(bench_with_all_cells()["workloads"],
                                        key=lambda w: w["name"]), ids=lambda w: w["name"])
def test_cells_are_found_by_file_name(name):
    cell = harness.load_cell(name["name"], bench_with_all_cells())
    assert (ROOT / "tdbench" / "kinds" / f"{cell.traffic['kind']}.py").exists()
    for entry, reader in cell.per_layer:
        assert reader.read({}) is None, f"{entry['name']} reads something from nothing"


def test_per_layer_readers_exist_for_every_metric():
    for m in BENCH["per_layer"]:
        assert (ROOT / "tdbench" / "metrics" / f"{m['name']}.py").exists()


def test_traffic_repeats_for_a_seed_and_differs_across_seeds():
    def draw(seed):
        rng = np.random.default_rng(seed)
        return (structures.backbone_text(rng, 150),
                structures.balanced(rng, range(1, 7), 12).tolist(),
                structures.lognormal_lengths(rng, 50, 150, 0.6, 40, 600).tolist(),
                structures.exponential_gaps(rng, 50, 7.0).tolist())

    big = 2 ** 40 + 17
    assert draw(big) == draw(big)
    a, b = draw(big), draw(big + 1)
    assert all(x != y for x, y in zip(a, b))
    # every seed gets the same sizes and gaps, in another order
    assert sorted(a[1]) == sorted(b[1]) and sorted(a[2]) == sorted(b[2])
    assert np.allclose(sorted(a[3]), sorted(b[3]))


def test_backbone_text_has_the_asked_length():
    text = structures.backbone_text(np.random.default_rng(1), 200)
    residues = {(l[21], l[22:27]) for l in text.splitlines() if l.startswith("ATOM")}
    assert len(residues) == 200 and {c for c, _ in residues} == {"A", "B", "C"}


def test_design_plan_is_seeded_and_keeps_the_longest():
    from tdbench.kinds import Run

    cell = harness.load_cell("design_rotamer_poisson", bench_with_all_cells())
    run = Run(cell, 2 ** 33 + 1, 10.0, False, None, ROOT)
    p, q = design_open_loop.plan(run, 1), design_open_loop.plan(run, 1)
    assert p == q and len(p["at"]) == round(cell.traffic["rate"] * 10)
    assert int(np.argmax(p["lengths"])) in p["keep"]
    assert p["at"] == sorted(p["at"]) and p["at"][0] == 0.0


def test_forward_flops_by_hand():
    cfg = json.loads((ROOT / "tdbench/configs/timed.json").read_text())
    by_hand = 2 * 9261 * (27 * (5 * 16 + 16 * 32 + 32 * 64 + 64 * 128) + 128 * 20)
    assert peaks.forward_flop_per_frame(cfg) == by_hand == 5_464_434_528


def test_conv_least_time_by_hand():
    cfg = {"in_channels": 2, "filters": [4], "n_classes": 3}
    # 3^3 conv 2->4 and a 1^3 head 4->3, 10 frames of 21^3, bf16 values
    f1, b1 = 2 * 27 * 8 * 9261 * 10, 2 * (9261 * 10 * 6 + 27 * 8)
    f2, b2 = 2 * 12 * 9261 * 10, 2 * (9261 * 10 * 7 + 12)
    t1 = max(f1 / 989e12, b1 / 3.35e12)
    t2 = max(f2 / 989e12, b2 / 3.35e12)
    assert math.isclose(peaks.conv_least_s(cfg, 10), t1 + t2)
    assert math.isclose(peaks.conv_least_s(cfg, 10, training=True), 2 * t1 + 3 * t2)


def test_sample_least_time_by_hand():
    # 76 residues, 338 classes, 100 draws each: 7,600 draws of 60 + 9 ops
    ops = 7600 * 69 / (132 * 64 * 1.98e9)
    moved = (76 * 338 * 4 + 7600 + 100 * 80 + 338) / 3.35e12
    assert math.isclose(peaks.sample_least_s(76, 338, 100), max(ops, moved))


def test_busy_union_and_idle_gaps():
    events = [(0, 10, "a"), (5, 15, "b"), (20, 30, "c"), (40, 45, "d")]
    assert harness.busy_us(events) == 30
    gaps = harness.idle_gaps(events, 60, [(0, 60, "pass")])
    assert gaps == [["pass", 15e-6], ["pass", 10e-6], ["pass", 5e-6]]


def test_percentiles_over_all_requests():
    values = sorted([0.1, 0.4, 0.2, 0.3, 0.5])
    assert design_open_loop._percentile(values, 50) == 0.3
    assert math.isclose(design_open_loop._percentile(values, 95), 0.48)
    big = sorted(np.random.default_rng(0).random(101).tolist())
    assert math.isclose(design_open_loop._percentile(big, 95),
                        statistics.quantiles(big, n=20, method="inclusive")[-1])


def test_readers_on_a_hand_made_record():
    cfg = json.loads((ROOT / "tdbench/configs/timed.json").read_text())
    record = {"kind": "predict", "frames": 1000, "window_s": 2.0, "busy_s": 1.5,
              "flop_per_frame": 5_464_434_528, "config": cfg, "device_frames": 1024,
              "kernels": {"sm90_xmma_fprop_implicit_gemm_bf16": 0.5, "elu_kernel": 0.2},
              "passes": [{"frames": 1000, "wall_s": 2.0, "frame_set_s": 1.0,
                          "timings": {"predict": 0.5, "decode": 0.1, "write": 0.1}}],
              "step_ms": [3.0, 1.0, 2.0], "requests": [
                  {"status": 200, "latency": 0.1, "timings_s": {
                      "parse": 0.01, "voxelisation": 0.02, "prediction": 0.03,
                      "sampling": 0.01, "group_requests": 2}},
                  {"status": 500, "latency": 9.0}]}

    def read(name):
        return harness.load_reader(name).read(record)

    assert math.isclose(read("predict.frame_set_share"), 50.0)
    assert math.isclose(read("predict.engine_frames_per_s"), 2000.0)
    assert math.isclose(read("predict.write_share"), 10.0)
    assert math.isclose(read("device_idle.predict"), 25.0)
    assert read("device_idle.train") is None
    assert math.isclose(read("mfu.predict"), 100 * 1000 * 5_464_434_528 / 2.0 / 989e12)
    assert math.isclose(read("conv3d_roofline.predict"),
                        100 * peaks.conv_least_s(cfg, 1024) / 0.5)
    assert read("train.step_ms") == 2.0
    assert math.isclose(read("design.outside_stages_ms"), 30.0)
    assert read("design.group_requests") == 2
