"""Phase timing: the port's copy of ``PhaseTimer`` from
``timed_design_tpu/utils/timing.py``. Named phases (datasetmap, predict,
decode, write) accumulate wall seconds; ``summary`` returns them as a dict."""
from __future__ import annotations

import contextlib
import time


class PhaseTimer:
    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> dict[str, float]:
        return dict(self.phases)

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{k}: {v:.3f}s ({100*v/max(total,1e-9):.1f}%)" for k, v in self.phases.items()]
        lines.append(f"total: {total:.3f}s")
        return "\n".join(lines)
