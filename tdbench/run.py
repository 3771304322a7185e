"""One run of one cell of the benchmark.

    python -m tdbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic and limits
are the files that BENCHMARK.json names; the traffic file's ``kind`` picks
the driver (``tdbench/kinds/<kind>.py``). With ``--trace 0`` the result
line holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read under ``torch.profiler``. The last line of standard output
is the result; the numbers compared with the reference and their limits
are also the last lines of standard error. A run that finds no CUDA card,
or fewer than the cell asks for, exits with 3 and prints no result.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import tempfile
from pathlib import Path

from . import harness
from .kinds import Run


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m tdbench.run", description=__doc__.split("\n")[1])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(cell: harness.Cell, seed: int, seconds: float, trace: bool, device,
            quantize: str | None = None, setup_clock=harness.process_age_s) -> dict:
    """Run the cell once; returns the result line's fields, with
    ``checks``. Inputs and outputs live in a directory under TMPDIR that
    goes with the run."""
    kind = importlib.import_module(f"tdbench.kinds.{cell.traffic['kind']}")
    with tempfile.TemporaryDirectory(prefix="tdbench-") as work:
        out = kind.run(Run(cell, seed, seconds, trace, device, Path(work), quantize,
                           setup_clock))
    if trace:
        record = {**out.record, "busy_s": out.trace.summary()["busy_s"]}
        metrics = {}
        for entry, reader in cell.per_layer:
            value = reader.read(record)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    import torch

    cuda = device.type == "cuda"
    result = {
        "correct": all(c.ok for c in out.checks) and bool(out.checks),
        "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes},
        "checks": out.checks, "readings": out.readings,
    }
    if trace:
        summary = out.trace.summary()
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = summary["breakdown"]
    return result


def main(argv=None) -> int:
    args = parse(argv)
    harness.fix_cache_dirs()
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"tdbench: the cell asks for {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    print(f"tdbench: {args.workload}, seed {args.seed}, {args.seconds} s, trace {args.trace}, "
          f"{harness.card_name_and_limit()}", file=sys.stderr)
    result = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"))
    found = harness.forbidden_modules()
    if found:
        print(f"tdbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    harness.print_result(result["correct"], result["attempted"], result["failed"],
                         result["metrics"], result["device"], result["checks"],
                         result.get("breakdown"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
