#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
builds every CUDA kernel of the serving path from ``timed_design_tpu_torch/
csrc``, checks each kernel against its plain PyTorch version at the shapes
the path gives it (and times both with CUDA events), then starts the design
server in-process on the full-width TIMED_rotamer model (random weights from
a fixed seed, bfloat16, batch 512) and sends it real requests. It counts the
kernel launches made while serving, and fails if a kernel of the path was
not launched, disagrees with its plain version, or a response is wrong.
Last, it profiles one warm request: stage medians, device busy time and
idle share, and the kernels that take the most device time.

The line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import gzip
import json
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


def check_sampling_kernel() -> dict:
    """sample_inverse_cdf against its plain version, index for index."""
    import numpy as np
    import torch

    from timed_design_tpu_torch.ops.sample import (
        philox_uniforms,
        sample_class_indices_plain,
        sample_inverse_cdf,
    )

    dev = torch.device("cuda")
    shapes, max_err = [], 0
    for i, (L, C, n) in enumerate(SHAPES):
        cdf = torch.cumsum(torch.from_numpy(random_probs(L, C, i)).to(dev), -1).contiguous()
        got = sample_inverse_cdf(cdf, n, SEED)
        u = torch.from_numpy(philox_uniforms(SEED, n, L)).to(dev)
        want = sample_class_indices_plain(cdf, u)
        torch.cuda.synchronize()
        assert got.shape == (n, L) and got.dtype == torch.int32
        err = int((got - want).abs().max())
        max_err = max(max_err, err)
        ms = time_ms(lambda: sample_inverse_cdf(cdf, n, SEED))
        plain_ms = time_ms(lambda: sample_class_indices_plain(cdf, u))
        shapes.append({"L": L, "C": C, "n": n, "equal_to_plain": err == 0,
                       "ms": ms, "plain_ms": plain_ms})
        log(f"sample_inverse_cdf L={L} C={C} n={n}: equal_to_plain={err == 0} "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (plain given the uniforms)")
        assert err == 0, f"kernel disagrees with its plain version at {(L, C, n)}"

    # distribution: 1e6 draws from [0.5, 0.3, 0.2, 0, ...]
    cdf = torch.cumsum(torch.tensor([[0.5, 0.3, 0.2] + [0.0] * 17], device=dev), -1)
    idx = sample_inverse_cdf(cdf, 1_000_000, 1).cpu().numpy().ravel()
    freq = np.bincount(idx, minlength=20) / idx.size
    log(f"sample_inverse_cdf 1e6 draws: freq[:3]={freq[:3].tolist()}")
    assert np.abs(freq[:3] - [0.5, 0.3, 0.2]).max() <= 0.01 and freq[3:].sum() == 0
    # a half-mass row: u past the mass gives class 0
    half = torch.zeros((1, 20), device=dev)
    half[0, 3] = half[0, 7] = 0.25
    idx = sample_inverse_cdf(torch.cumsum(half, -1), 1_000_000, 11).cpu().numpy().ravel()
    zero = float((idx == 0).mean())
    log(f"sample_inverse_cdf half-mass row: share of class 0 = {zero:.4f}")
    assert abs(zero - 0.5) <= 0.01 and set(np.unique(idx).tolist()) <= {0, 3, 7}
    # determinism in the seed
    cdf = torch.cumsum(torch.from_numpy(random_probs(76, 338, 9)).to(dev), -1)
    a, b = sample_inverse_cdf(cdf, 500, 5), sample_inverse_cdf(cdf, 500, 5)
    c = sample_inverse_cdf(cdf, 500, 6)
    assert torch.equal(a, b) and not torch.equal(a, c)
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from timed_design_tpu_torch.cli.serve import _design_payload

    def request():
        return _design_payload(designer, pdb, n_samples=100, temperature=0.2, seed=7)

    runs = [request()["timings_s"] for _ in range(reps)]
    log(f"profile: stage medians of {reps} warm 1ubq requests (ms): " + ", ".join(
        f"{k} {np.median([r[k] for r in runs]) * 1e3:.2f}" for k in STAGES))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
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
    assert dev, "the profiler saw no device activity"


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
        "shape": [main_shape["L"], main_shape["C"], main_shape["n"]],
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
