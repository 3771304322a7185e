"""The readings that the cells' limits are set from: the program's sound
runs, its control in the next lower precision, and the faults that the
comparison has to catch, each on several seeds.

    python -m tdbench.controls --workload <name> --mode <mode> --seeds 1,2,3 --seconds 8

prints one JSON line per seed with every number compared. ``--mode``:
``sound``; ``control`` (the program's own ``int8`` path where it has one,
else the reference in float8 in the program's place); or a fault planted
in the program: ``half_batch`` (the second half of every device batch, or
of every training batch, left out), ``altered`` (one answer changed where
it is produced: a probability row, a sampled residue, a step's loss) and
``unchanged`` (training steps that leave the weights as they were). The
benchmark's own runs run none of this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

from . import harness

CONTROL = {"predict_passes": "int8", "design_open_loop": "int8", "train_fit": "float8_e4m3fn"}
FAULTS = {"predict_passes": ("half_batch", "altered"),
          "design_open_loop": ("half_batch", "altered"),
          "train_fit": ("half_batch", "altered", "unchanged")}


@contextlib.contextmanager
def planted(kind: str, fault: str | None):
    """The program with ``fault`` planted for the duration."""
    if fault is None:
        yield
        return
    if kind == "train_fit":
        import timed_design_tpu_torch.train.train as train_mod

        make = train_mod.make_train_step

        def broken(module, optimizer, *args, **kw):
            if fault == "unchanged":
                optimizer.step = lambda *a, **k: None
            step = make(module, optimizer, *args, **kw)

            def run(x, y, generator=None):
                if fault == "half_batch":
                    half = x.shape[0] // 2
                    return step(x[:half], y[:half], generator)
                out = step(x, y, generator)
                if fault == "altered":
                    out = {**out, "loss": out["loss"] * 1.5}
                return out

            return run

        train_mod.make_train_step = broken
        try:
            yield
        finally:
            train_mod.make_train_step = make
        return
    from timed_design_tpu_torch.engine.predictor import Predictor

    forward = Predictor.run_device_batch
    patched = [(Predictor, "run_device_batch", forward)]

    def half(self, x):
        h = x.shape[0] // 2
        return forward(self, x[:h].repeat(2, *([1] * (x.dim() - 1))))

    def altered(self, x):
        import torch

        host, done = forward(self, x)
        if done is not None:
            done.synchronize()
        with torch.inference_mode():
            host[0] = host[0].roll(1)
        return host, done

    if fault == "half_batch":
        Predictor.run_device_batch = half
    elif kind == "predict_passes":
        Predictor.run_device_batch = altered
    else:
        import timed_design_tpu_torch.sample.sampler as sampler

        draw = sampler.sample_structure
        patched.append((sampler, "sample_structure", draw))

        def one_residue_changed(*args, **kw):
            out = draw(*args, **kw)
            seq, *rest = out[0]
            swap = "A" if seq[0] != "A" else "C"
            return [(swap + seq[1:], *rest), *out[1:]]

        sampler.sample_structure = one_residue_changed
    try:
        yield
    finally:
        for owner, name, original in patched:
            setattr(owner, name, original)


def readings(cell: harness.Cell, seed: int, seconds: float, device, mode: str) -> dict:
    """One run of ``cell`` in ``mode``; the numbers compared and ``correct``."""
    from .run import execute

    kind = cell.traffic["kind"]
    quantize = CONTROL[kind] if mode == "control" else None
    fault = None if mode in ("sound", "control") else mode
    with planted(kind, fault):
        result = execute(cell, seed, seconds, False, device, quantize=quantize)
    return {"seed": seed, "mode": mode, "correct": result["correct"], **result["readings"],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tdbench.controls")
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", default="control")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    args = p.parse_args(argv)
    harness.fix_cache_dirs()
    import torch

    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload,
                          **readings(cell, seed, args.seconds, torch.device("cuda"),
                                     args.mode)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
