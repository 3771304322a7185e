"""Whole runs of every cell at a small size on the CPU, past the look for
a card: sound, they come out correct; with the control in the next lower
precision, or with a fault planted in the program underneath, they come
out not correct. One test on the card runs a cell at its real size."""
from __future__ import annotations

import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import CELLS, KINDS, ROOT, small_cell
from tdbench import controls, harness
from tdbench.run import execute

SEED = 2 ** 35 + 11


def small_run(name: str, mode: str = "sound", trace: bool = False) -> dict:
    cell = small_cell(name)
    kind = cell.traffic["kind"]
    t0 = time.perf_counter()
    with controls.planted(kind, None if mode in ("sound", "control") else mode):
        return execute(cell, SEED, 1.5, trace, torch.device("cpu"),
                       quantize=controls.CONTROL[kind] if mode == "control" else None,
                       setup_clock=lambda: time.perf_counter() - t0)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_runs_are_correct(name):
    result = small_run(name)
    assert result["correct"], [(c.name, c.value, c.limit) for c in result["checks"]]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_is_not_correct(name):
    assert not small_run(name, "control")["correct"]


@pytest.mark.parametrize("name,fault", [(n, f) for n in sorted(CELLS)
                                        for f in controls.FAULTS[KINDS[n]]])
def test_faults_are_caught(name, fault):
    assert not small_run(name, fault)["correct"]


def test_traced_run_reads_its_per_layer_metrics():
    result = small_run("predict_timed_pdb", trace=True)
    assert {"predict.frame_set_share", "predict.engine_frames_per_s"} <= set(result["metrics"])
    assert "busy_s" in result["device"] and "breakdown" in result


def test_a_machine_without_a_card_gets_no_result():
    out = subprocess.run([sys.executable, "-m", "tdbench.run", "--workload", "train_timed",
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.cuda
def test_train_cell_on_the_card(cuda_device):
    cell = harness.load_cell("train_timed")
    result = execute(cell, SEED, 3.0, False, cuda_device)
    assert result["correct"] and result["device"]["platform"] == "gpu"
