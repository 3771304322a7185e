"""Shared pieces of the benchmark's own tests: the ``cuda`` marker, the
card fixture, and the cells cut to a size the CPU runs in seconds."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every traffic file with the configuration it runs in its cell, the design
# traffic among them though it is not a cell of BENCHMARK.json yet
CELLS = {"predict_timed_pdb": ("timed", "pdb_passes"),
         "design_rotamer_poisson": ("timed_rotamer", "design_poisson"),
         "train_timed": ("timed", "fit_shuffled")}
KINDS = {"predict_timed_pdb": "predict_passes", "design_rotamer_poisson": "design_open_loop",
         "train_timed": "train_fit"}
SMALL = {"predict_passes": {"pool_files": 6, "files_per_pass": 2, "chains_max": 2,
                            "warmup_files": 1, "check_rows_per_pass": 400},
         "design_open_loop": {"rate": 4.0, "median_length": 60, "min_length": 40,
                              "max_length": 120, "warmup_rounds": 1, "warmup_concurrency": 2,
                              "check_requests": 4, "n_samples": 10},
         "train_fit": {"files": 4, "chains_max": 2, "warmup_steps": 1}}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def bench_with_all_cells() -> dict:
    """BENCHMARK.json with an entry for every traffic file, so that a cell
    not in the benchmark yet loads as one that is."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {w["name"] for w in bench["workloads"]}
    for name, (config, traffic) in CELLS.items():
        if name not in names:
            bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                       "chips": 1, "why": "test"})
        if config not in {c["name"] for c in bench["configs"]}:
            bench["configs"].append({"name": config, "file": f"tdbench/configs/{config}.json"})
    return bench


def small_cell(name: str):
    """The cell ``name`` with its limits as committed, its model cut to two
    narrow blocks and its traffic to a few small structures."""
    from tdbench import harness

    cell = harness.load_cell(name, bench_with_all_cells())
    cell.config.update(filters=[4, 8], batch_inference=32, batch_training=16)
    cell.traffic.update(SMALL[cell.traffic["kind"]])
    return cell
