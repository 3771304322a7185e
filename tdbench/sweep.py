"""The sweep that finds a ``/design`` cell's knee: runs of the cell at
fixed rates, each printing its latencies and whether the backlog grew.

    python -m tdbench.sweep --workload <name> --rates 10,20,30 --seconds 20 --seed 1

The backlog grows where the median latency of the window's last third of
requests exceeds twice that of its first third; the knee is the highest
rate at which it does not. The cell's rate is then written into its
traffic file as a number; the benchmark's runs never search for it.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
from pathlib import Path

from . import harness


def grew(requests: list) -> tuple[float, float]:
    """Median latency (s) of the first and of the last third of the
    requests by due time."""
    done = sorted((r["due"], r["latency"] if r["latency"] is not None else float("inf"))
                  for r in requests)
    third = max(1, len(done) // 3)
    return (statistics.median(l for _, l in done[:third]),
            statistics.median(l for _, l in done[-third:]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tdbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    harness.fix_cache_dirs()
    import torch

    from . import kinds
    from .kinds import design_open_loop

    cell = harness.load_cell(args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        cell.traffic["rate"] = rate
        with tempfile.TemporaryDirectory(prefix="tdbench-") as work:
            out = design_open_loop.run(kinds.Run(cell, args.seed, args.seconds, False,
                                                 torch.device("cuda"), Path(work),
                                                 setup_clock=harness.process_age_s))
        first, last = grew(out.record["requests"])
        late = sorted(r["late"] for r in out.record["requests"])
        print(json.dumps({"rate": rate, **out.end_to_end, "failed": out.failed,
                          "first_third_median_s": first, "last_third_median_s": last,
                          "backlog_grew": last > 2 * first, "sent_late_p95_s":
                          late[int(0.95 * (len(late) - 1))],
                          "correct": all(c.ok for c in out.checks)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
