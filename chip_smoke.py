#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
builds every CUDA kernel of the serving path from ``timed_design_tpu_torch/
csrc``, checks each kernel against its plain PyTorch version run on a CPU
copy of the same inputs at the shapes the path gives it, and times it: host-
inclusive per call (CUDA events), device time per call (a CUDA graph of
the calls), its bound, one PyTorch library call computing the same
function, and the plain version on the card. Then it starts the design server in-process on
the full-width TIMED_rotamer model (random weights from a fixed seed,
bfloat16, batch 512) and sends it real requests. It counts the kernel
launches made while serving, and fails if a kernel of the path was not
launched, disagrees with its plain version, or a response is wrong. Last, it
profiles one warm request (stage medians, device busy time and idle share,
the kernels that take the most device time) and the sampling stage alone
(every device operation it runs).

The line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import gzip
import json
import math
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
UBQ = ROOT / "tests" / "testing_files" / "1ubq.pdb1.gz"
# (L, C, n): kernel-check shapes. The first two are the serving path's own
# (76-residue and 760-residue designs with a 338-class head, 100 samples).
SHAPES = [(76, 338, 100), (760, 338, 100), (76, 338, 1000), (1024, 20, 256), (4096, 338, 64)]
SEED = 20261016


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def time_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_events(fn, cpu: bool = False) -> list:
    """The device events (kernels, copies, sets) that one call of ``fn``
    leaves in a torch.profiler trace; the profiles below read them. The
    profiler now and then returns a trace without device events: such a
    trace is taken again, up to four times, and an empty list means that all
    four came back empty."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for _ in range(4):
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            return events
    return []


def graph_ms(fn, reps: int = 20) -> float:
    """Device time per call: CUDA events around replays of a CUDA graph of
    ``reps`` calls of ``fn``, so no host time sits between the calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


# The card's peaks for the bound: HBM3 at 3.35 TB/s; 32-bit integer
# operations at 132 SMs x 64 INT32 lanes x 1.98 GHz (boost) = 16.7 T/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# The least integer work of one Philox4x32-10 block: 10 rounds of two
# 32x32 -> 64-bit products (four multiply halves) and two three-input XORs
# (one LOP3 each). The key schedule depends only on the seed, the same for
# every draw, so it is not counted.
PHILOX_OPS = 60


def bound(L: int, C: int, n: int, other_bytes: int) -> tuple[float, str]:
    """Least time (ms) for n*L draws from (L, C) float32 probabilities: the
    probabilities and ``other_bytes`` (outputs, a class map) moved once over
    the memory rate, or a Philox block (PHILOX_OPS) and ceil(log2(C+1))
    compares per draw over the integer rate, whichever is longer."""
    t_bytes = (L * C * 4 + other_bytes) / HBM_BYTES_PER_S
    t_ops = n * L * (PHILOX_OPS + math.ceil(math.log2(C + 1))) / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def random_probs(L: int, C: int, seed: int):
    import numpy as np

    p = np.random.default_rng(seed).random((L, C)).astype(np.float32) ** 4
    return p / p.sum(1, keepdims=True)


def build_kernels(names: list[str]) -> None:
    """One nvcc per source, all started together."""
    from timed_design_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        results = dict(zip(names, pool.map(_build.build, names)))
    log(f"build: {len(names)} kernel(s) in {time.perf_counter() - t0:.2f} s")
    for name, (path, report) in results.items():
        log(f"build: {name} -> {path.relative_to(ROOT)}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")


def class_map(C: int):
    """The map a C-class head uses: the rotamer -> amino-acid table for 338
    classes; for 20 classes, a fixed permutation (the map path at C = 20)."""
    import numpy as np
    import torch

    from timed_design_tpu_torch.constants import ROTAMER_TO_AA

    table = ROTAMER_TO_AA if C == 338 else np.random.default_rng(C).permutation(C)
    return torch.from_numpy(table.astype(np.uint8))


def check_sampling_kernel() -> dict:
    """sample_inverse_cdf against sample_codes_plain run on a CPU copy of the
    same probabilities and uniforms: codes and counts equal at every shape,
    with a class map and without. Then, at each shape, with the map the
    serving path gives it (the rotamer table at C = 338, none at C = 20):
    (a) the host-inclusive time per call, CUDA events around 20 back-to-back
    calls; (b) the device time per call (the zeroing of the counts and the
    kernel), from a CUDA graph of 20 calls; (c) the bound and its share;
    (d) one library call, torch.searchsorted(cdf, u.T, right=True), given
    the device CDF and the uniforms (the count of entries <= u; the port
    never calls it); (e) the plain version's device time on the card, given
    the uniforms. (d) and (e) are timed as (b). Last, statistics, a
    half-mass row and determinism."""
    import numpy as np
    import torch

    from timed_design_tpu_torch.ops.sample import (
        N_COUNTED,
        philox_uniforms,
        sample_codes_plain,
        sample_inverse_cdf,
    )

    dev = torch.device("cuda")
    shapes, max_err = [], 0
    for i, (L, C, n) in enumerate(SHAPES):
        probs_cpu = torch.from_numpy(random_probs(L, C, i))
        u_cpu = torch.from_numpy(philox_uniforms(SEED, n, L))
        probs = probs_cpu.to(dev)
        equal = True
        for cmap in (None, class_map(C)):
            codes, counts = sample_inverse_cdf(probs, n, SEED, None if cmap is None else cmap.to(dev))
            want_codes, want_counts = sample_codes_plain(probs_cpu, u_cpu, cmap)
            torch.cuda.synchronize()
            assert codes.shape == (n, L) and codes.dtype == want_codes.dtype
            assert counts.shape == (n, N_COUNTED) and counts.dtype == torch.int32
            err = max(int((codes.cpu().long() - want_codes.long()).abs().max()),
                      int((counts.cpu() - want_counts).abs().max()))
            max_err = max(max_err, err)
            equal &= err == 0
            log(f"sample_inverse_cdf L={L} C={C} n={n} map={cmap is not None}: codes "
                f"{codes.dtype} and counts equal to the plain version on the CPU: {err == 0}")
        smap = class_map(C).to(dev) if C == 338 else None

        def kernel():
            return sample_inverse_cdf(probs, n, SEED, smap)

        host_ms = time_ms(kernel)
        ms = graph_ms(kernel)
        cdf = torch.cumsum(probs, -1)
        u = u_cpu.to(dev)
        ut = u.T.contiguous()
        library_ms = graph_ms(lambda: torch.searchsorted(cdf, ut, right=True))
        plain_ms = graph_ms(lambda: sample_codes_plain(probs, u, smap))
        code_bytes = 1 if smap is not None or C <= 256 else 2
        bound_ms, bound_by = bound(L, C, n, n * L * code_bytes + n * N_COUNTED * 4
                                   + (C if smap is not None else 0))
        shapes.append({"L": L, "C": C, "n": n, "map": smap is not None,
                       "equal_to_plain": equal, "host_ms": host_ms, "ms": ms,
                       "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                       "bound_share": bound_ms / ms})
        log(f"sample_inverse_cdf L={L} C={C} n={n} map={smap is not None}: (a) host-inclusive "
            f"{host_ms:.4f} ms/call; (b) device {ms * 1e3:.2f} us/call; (c) bound {bound_ms * 1e3:.3f} us ({bound_by}), "
            f"share {bound_ms / ms:.3f}; (d) searchsorted {library_ms * 1e3:.2f} us (given the "
            f"CDF and the uniforms); (e) plain {plain_ms * 1e3:.2f} us (given the uniforms)")
        assert equal, f"kernel disagrees with its plain version at {(L, C, n)}"

    # distribution: 1e6 draws from [0.5, 0.3, 0.2, 0, ...]
    probs = torch.tensor([[0.5, 0.3, 0.2] + [0.0] * 17], device=dev)
    codes, counts = sample_inverse_cdf(probs, 1_000_000, 1)
    idx = codes.cpu().numpy().ravel()
    freq = np.bincount(idx, minlength=20) / idx.size
    log(f"sample_inverse_cdf 1e6 draws: freq[:3]={freq[:3].tolist()}")
    assert np.abs(freq[:3] - [0.5, 0.3, 0.2]).max() <= 0.01 and freq[3:].sum() == 0
    assert torch.equal(counts.sum(0).cpu(), torch.from_numpy(np.bincount(idx, minlength=20)).int())
    # a half-mass row: u past the mass gives class 0
    half = torch.zeros((1, 20), device=dev)
    half[0, 3] = half[0, 7] = 0.25
    idx = sample_inverse_cdf(half, 1_000_000, 11)[0].cpu().numpy().ravel()
    zero = float((idx == 0).mean())
    log(f"sample_inverse_cdf half-mass row: share of class 0 = {zero:.4f}")
    assert abs(zero - 0.5) <= 0.01 and set(np.unique(idx).tolist()) <= {0, 3, 7}
    # determinism in the seed
    probs = torch.from_numpy(random_probs(76, 338, 9)).to(dev)
    smap = class_map(338).to(dev)
    a, b = sample_inverse_cdf(probs, 500, 5, smap), sample_inverse_cdf(probs, 500, 5, smap)
    c = sample_inverse_cdf(probs, 500, 6, smap)
    assert all(map(torch.equal, a, b)) and not torch.equal(a[0], c[0])
    log("sample_inverse_cdf: statistics, half-mass and determinism checks passed")
    return {"shapes": shapes, "max_abs_err": max_err}


def multichain_pdb(text: str, copies: int = 10) -> str:
    """``copies`` of the first model's ATOM records, chains A, B, ...,
    each shifted 50 A along x."""
    atoms = []
    for line in text.splitlines():
        if line.startswith("ENDMDL"):
            break
        if line.startswith("ATOM"):
            atoms.append(line)
    out = []
    for k in range(copies):
        for line in atoms:
            x = float(line[30:38]) + 50.0 * k
            out.append(f"{line[:21]}{chr(ord('A') + k)}{line[22:30]}{x:8.3f}{line[38:]}")
        out.append("TER")
    return "\n".join(out + ["END"]) + "\n"


def post(url: str, payload: dict) -> tuple[int, dict, float]:
    data = json.dumps(payload).encode()
    t0 = time.perf_counter()
    with urllib.request.urlopen(urllib.request.Request(url, data=data, method="POST"),
                                timeout=300) as r:
        body = json.loads(r.read())
        return r.status, body, time.perf_counter() - t0


STAGES = ("parse", "voxelisation", "prediction", "sampling")


def stages(timings: dict) -> str:
    return ", ".join(f"{k} {timings[k] * 1e3:.1f}" for k in STAGES)


def profile_request(designer, pdb: str, reps: int = 10) -> None:
    """Where one warm 1ubq design with 100 samples spends its time: the
    server's stage medians over ``reps`` requests, then one request under
    torch.profiler. Device busy time is the union of the kernel and copy
    intervals on the card; the idle share is the rest of the wall time."""
    import numpy as np
    import torch

    from timed_design_tpu_torch.cli.serve import _design_payload

    def request():
        return _design_payload(designer, pdb, n_samples=100, temperature=0.2, seed=7)

    runs = [request()["timings_s"] for _ in range(reps)]
    log(f"profile: stage medians of {reps} warm 1ubq requests (ms): " + ", ".join(
        f"{k} {np.median([r[k] for r in runs]) * 1e3:.2f}" for k in STAGES))
    torch.cuda.synchronize()
    wall = []

    def timed_request():
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e6)

    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in device_events(timed_request, cpu=True))
    if not dev:
        log("profile: one request: the profiler returned no device events; not measured")
        return
    wall_us = wall[-1]
    busy, end, by_name = 0.0, float("-inf"), {}
    for a, b, name in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    kernels = sum(1 for *_, n in dev if not n.startswith(("Memcpy", "Memset")))
    log(f"profile: one request, wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}, "
        f"{kernels} kernels, {len(dev) - kernels} copies/sets")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"profile:   {us / 1e3:7.3f} ms  {name[:90]}")


def profile_sampling(session, reps: int = 10) -> None:
    """The sampling stage of a warm 1ubq request alone (temperature 0.2,
    100 samples, the rotamer head): host wall per call, and one call under
    torch.profiler with every device operation it runs."""
    import numpy as np
    import torch

    from timed_design_tpu_torch.sample.sampler import apply_temperature, sample_structure

    probs, _ = session.design(UBQ)

    def stage():
        p = apply_temperature(torch.as_tensor(probs, device=session.device), 0.2)
        return sample_structure(p, 100, 7, rotamer_mode=probs.shape[1] == 338)

    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        stage()
        walls.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    dev = device_events(stage, cpu=True)
    if not dev:
        log("profile sampling: the profiler returned no device events; not measured")
        return
    names: dict[str, list[float]] = {}
    for e in dev:
        names.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    log(f"profile sampling: median wall {np.median(walls):.3f} ms over {reps} warm calls; "
        f"one call: {len(dev)} device operations, "
        f"{sum(map(sum, names.values())) / 1e3:.4f} ms device time")
    for name, us in sorted(names.items(), key=lambda kv: -sum(kv[1])):
        log(f"profile sampling:   {len(us):3d} x {sum(us) / len(us):8.2f} us  {name[:90]}")


def check_serving() -> dict:
    """The design server on the card: counts the kernel launches it makes."""
    import numpy as np
    import torch

    from timed_design_tpu_torch.cli.serve import build_designers, build_parser, make_server
    from timed_design_tpu_torch.ops.sample import sample_inverse_cdf
    from timed_design_tpu_torch.sample.metrics import sequence_metrics

    args = build_parser().parse_args([
        "--model", "TIMED_rotamer", "--allow-random-weights", "--batch_size", "512",
    ])
    designers = build_designers(args)
    d = designers["TIMED_rotamer"]
    model = d.session.predictor.model
    assert all(p.device.type == "cuda" for p in model.parameters())
    assert model.compute_dtype == torch.bfloat16
    server = make_server(d, "127.0.0.1", 0, "TIMED_rotamer")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    pdb = gzip.decompress(UBQ.read_bytes()).decode()
    lat: dict[str, list[float]] = {}
    try:
        sample_inverse_cdf.launches = 0
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["device"].startswith("cuda")
        req = {"pdb": pdb, "n_samples": 100, "temperature": 0.2, "seed": 7}
        bodies = []
        for _ in range(3):
            status, body, dt = post(url + "/design", req)
            assert status == 200
            bodies.append(body)
            lat.setdefault("design_1ubq_n100", []).append(dt)
        status, big, dt = post(url + "/design", {**req, "pdb": multichain_pdb(pdb)})
        assert status == 200 and big["n_residues"] == 760 and len(big["samples"]) == 100
        lat["design_760res_n100"] = [dt]
        with ThreadPoolExecutor(max_workers=8) as pool:
            conc = list(pool.map(lambda _: post(url + "/design", req), range(8)))
        lat["design_1ubq_n100_8_concurrent"] = [dt for _, _, dt in conc]
        launches = sample_inverse_cdf.launches
        profile_request(d, pdb)
        profile_sampling(d.session)
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)
        for des in designers.values():
            des.close()

    for body in bodies + [big] + [b for _, b, _ in conc]:
        p = np.array(body["probabilities"])
        assert np.isfinite(p).all() and np.abs(p.sum(1) - 1).max() <= 1e-3
        assert all(len(s["sequence"]) == body["n_residues"] for s in body["samples"])
    seqs = [[s["sequence"] for s in b["samples"]] for b in bodies]
    assert all(s == seqs[0] for s in seqs), "same seed, different samples"
    # packed requests sit at other rows of the batch: the same probabilities
    solo = np.array(bodies[0]["probabilities"])
    for _, b, _ in conc:
        assert np.abs(np.array(b["probabilities"]) - solo).max() <= 1e-3
    for s in bodies[0]["samples"][:10]:
        want = sequence_metrics(s["sequence"])
        got = (s["charge"], s["isoelectric_point"], s["molecular_weight"], s["molar_extinction"])
        assert np.allclose(got, want, rtol=1e-4, atol=0.05), (got, want)
    packed = max(b["timings_s"]["group_requests"] for _, b, _ in conc)
    log(f"serving: launches of sample_inverse_cdf = {launches}, "
        f"largest coalesced group = {packed} requests")
    assert launches >= 12, "the serving path did not go through the kernel"
    assert packed >= 2, "concurrent requests were not coalesced"
    split = {"design_1ubq_n100": bodies, "design_760res_n100": [big],
             "design_1ubq_n100_8_concurrent": [b for _, b, _ in conc]}
    for k, v in lat.items():
        log(f"serving latency {k}: " + ", ".join(
            f"{x * 1e3:.1f} ms ({stages(b['timings_s'])}, "
            f"group {b['timings_s']['group_requests']})" for x, b in zip(v, split[k])))
    log(json.dumps({"serving_latency_s": lat}))
    return {"launches": launches}


def check_reference() -> None:
    """The whole design path on the card against the same model on the CPU
    in float32 (1ubq): probabilities within 1e-4."""
    import copy

    import numpy as np
    import torch

    from timed_design_tpu_torch.engine import DesignSession

    gpu = DesignSession("TIMED_rotamer", compute_dtype="float32", batch_size=128,
                        allow_random_weights=True, device="cuda")
    model = gpu.predictor.model
    cpu = DesignSession(copy.deepcopy(model).cpu(), codec="CNOCACB", batch_size=128,
                        device="cpu")
    want, _ = cpu.design(UBQ)
    got, _ = gpu.design(UBQ)
    err = float(np.abs(got - want).max())
    agree = float((got.argmax(1) == want.argmax(1)).mean())
    log(f"reference: 1ubq float32 GPU vs CPU max |dp| = {err:.3g}, argmax agreement {agree:.3f}")
    assert got.shape == (76, 338) and np.isfinite(got).all() and err <= 1e-4
    half = copy.deepcopy(model)
    half.compute_dtype = torch.bfloat16
    pb, _ = DesignSession(half, codec="CNOCACB", batch_size=128, device="cuda").design(UBQ)
    log(f"reference: 1ubq bfloat16 vs float32 on the GPU max |dp| = "
        f"{float(np.abs(pb - got).max()):.3g}, argmax agreement "
        f"{float((pb.argmax(1) == got.argmax(1)).mean()):.3f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 1
    import timed_design_tpu_torch  # noqa: F401  (fails outside a checkout)

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, GPU: {gpu_name_and_power()}")
    build_kernels(["sample_inverse_cdf"])
    kernel = check_sampling_kernel()
    check_reference()
    serving = check_serving()
    main_shape = kernel["shapes"][0]
    print(json.dumps({"kernels": [{
        "name": "sample_inverse_cdf",
        "route": "cuda",
        "source": "timed_design_tpu_torch/csrc/sample_inverse_cdf.cu",
        "replaces": "timed_design_tpu/ops/pallas_sample.py:88",
        "launches": serving["launches"],
        "max_abs_err": kernel["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "shape":[main_shape["L"], main_shape["C"], main_shape["n"]],
        "equal_to_plain": all(s["equal_to_plain"] for s in kernel["shapes"]),
        "per_shape": kernel["shapes"],
    }]}), flush=True)
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
