"""One driver per kind of traffic. A traffic file names its kind
(``"kind": "predict_passes"``) and the driver ``kinds/<kind>.py`` reads
the rest of the file as its parameters; a cell of an existing kind is a
new traffic file and a ``workloads`` entry, with no code.

Each driver's ``run(run)`` makes the cell's inputs and weights from the
seed, warms up, measures for ``run.seconds``, reads the device's peak
memory, frees the program's state, compares what the timed path produced
with the plain reference, and returns an ``Outcome``."""
from __future__ import annotations

import dataclasses
from pathlib import Path

from ..harness import Cell, Check, DeviceTrace
from ..weights import calibrate, make_weights


@dataclasses.dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    work: Path  # the run's own directory, under TMPDIR
    quantize: str | None = None  # the program's lower-precision path (the control)
    setup_clock: object = None  # () -> seconds since the process started


@dataclasses.dataclass
class Outcome:
    end_to_end: dict  # metric name -> value
    record: dict  # what the per-layer readers read
    checks: list[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: DeviceTrace | None = None
    readings: dict = dataclasses.field(default_factory=dict)  # every number measured


def compute_dtype(config: dict):
    import torch

    return getattr(torch, config["compute_dtype"])


def program_model(config: dict, seed: int, device):
    """The port's module of the configuration with the benchmark's seeded
    weights, on ``device``; and a float32 copy of those weights for the
    reference."""
    import torch

    from timed_design_tpu_torch.models import MODEL_REGISTRY

    module = MODEL_REGISTRY[config["model"]].build(
        compute_dtype=compute_dtype(config), filters=tuple(config["filters"]),
        dropout_rate=config["dropout_rate"], in_channels=config["in_channels"])
    init = config["init"]
    weights = make_weights(module.state_dict(), seed, device, init["conv_gain"],
                           init["head_gain"])
    weights.update(calibrate(weights, calibration_frames(seed, device), init["logit_std"]))
    module.load_state_dict(weights)
    module.to(device)
    reference = {k: v.detach().clone().float() for k, v in weights.items()
                 if v.is_floating_point()}
    if device.type == "cuda":
        torch.cuda.synchronize()
    return module, reference


def calibration_frames(seed: int, device, residues: int = 152):
    """The frames the weights are calibrated on: a seeded two-chain
    structure, voxelized by the reference."""
    import numpy as np

    from .. import structures
    from ..reference import frames as ref_frames

    text = structures.backbone_text(np.random.default_rng([seed, 4]), residues)
    fa = ref_frames.frame_atoms(ref_frames.parse_backbone(text))
    return ref_frames.voxelize(fa, np.arange(len(fa["keys"])), device)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free(device) -> None:
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
