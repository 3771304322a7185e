"""What every cell shares: the cell's files found by name, the caches inside
the checkout, the device and its peak memory, the profiler's device trace
and its reductions, the per-layer metric readers, and the result line."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "timed_design_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat)."""
    start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
    uptime = float(Path("/proc/uptime").read_text().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def fix_cache_dirs() -> None:
    """Every compile cache the run may fill, at a fixed path in the checkout;
    the program's own CUDA build directory is already there."""
    cache = HERE / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` and the files it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    per_layer: list  # [(metric entry, reader module)]
    end_to_end: list  # metric entries this cell reports


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json, with its configuration file,
    its traffic file (``traffic/<traffic>.json``), its limits
    (``limits/<cell>.json``) and the readers of its per-layer metrics
    (``metrics/<metric>.py``)."""
    bench = bench or read_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layers = []
    for m in bench["per_layer"]:
        if m["moves"] in reported and name in m.get("workloads", [name]):
            layers.append((m, load_reader(m["name"])))
    return Cell(name, entry["chips"], read_json(ROOT / config["file"]),
                read_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                read_json(HERE / "limits" / f"{name}.json"), layers, e2e)


def load_reader(metric: str):
    """``metrics/<metric>.py``: a module whose ``read(record)`` gives the
    metric's value, or None where the record holds nothing to read."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"tdbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's, Flax's
    or the JAX package's, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card_name_and_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def busy_us(intervals) -> float:
    """Device busy time (us): the union of (start, end, ...) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b, *_ in sorted(intervals):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def idle_gaps(intervals, window_us: float, spans, top: int = 10) -> list:
    """The ``top`` longest stretches of the window with no device activity,
    each named by the benchmark's host span that covers its middle
    (``spans``: (start_us, end_us, name), in the trace's clock)."""
    gaps, end = [], 0.0
    for a, b, *_ in sorted(intervals):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if window_us > end:
        gaps.append((end, window_us))
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) / 2
        names = [n for s, e, n in spans if s <= mid <= e]
        out.append([names[-1] if names else "outside any span", (b - a) / 1e6])
    return out


class DeviceTrace:
    """``torch.profiler`` over the measured window, device activity only.
    ``span(name)`` records a host span in the trace's clock; afterwards
    ``events`` holds (start_us, end_us, name) of every kernel, copy and set,
    relative to the window's start."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled and device.type == "cuda"
        self.cuda = device.type == "cuda"
        self.events: list = []
        self.spans: list = []
        self.window_s = 0.0
        self._prof = None
        self._t0 = 0.0

    def __enter__(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        if self.enabled:
            torch.cuda._sleep(1000)  # the trace's first event marks the window's start
        return self

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def span(self, name: str, start_us: float, end_us: float) -> None:
        self.spans.append((start_us, end_us, name))

    def __exit__(self, *exc):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        if self._prof is not None:
            from torch.autograd import DeviceType

            self._prof.__exit__(*exc)
            raw = [(e.time_range.start, e.time_range.end, e.name)
                   for e in self._prof.events() if e.device_type == DeviceType.CUDA]
            if raw:
                # the profiler's clock starts before the window; the first
                # device event is the marker launched as the window opened
                lead = min(a for a, *_ in raw)
                self.events = [(a - lead, b - lead, n) for a, b, n in raw]
        return False

    def kernel_seconds(self) -> dict:
        """Device seconds by kernel (or copy) name."""
        out: dict[str, float] = {}
        for a, b, n in self.events:
            out[n] = out.get(n, 0.0) + (b - a) / 1e6
        return out

    def summary(self) -> dict:
        """busy_s, window_s and the breakdown of the result line."""
        by_name = self.kernel_seconds()
        return {
            "busy_s": busy_us(self.events) / 1e6,
            "window_s": self.window_s,
            "breakdown": {
                "device_ops": [[n, s] for n, s in
                               sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
                "idle_gaps": idle_gaps(self.events, self.window_s * 1e6, self.spans),
            },
        }


@dataclasses.dataclass
class Check:
    """One number compared with its limit: correct while value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def print_result(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                 checks: list[Check], breakdown: dict | None = None) -> None:
    """The checks on standard error, then the result as the last line of
    standard output, the checks last in it."""
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
