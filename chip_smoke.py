#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
builds every CUDA kernel of the port's paths from ``timed_design_tpu_torch/
csrc``, checks each kernel entry against its plain PyTorch version run on a
CPU copy of the same inputs at the shapes the paths give it, and times it:
host-inclusive per call (CUDA events), device time per call (a CUDA graph
of the calls), its bound, one PyTorch library call computing the same
function, and the plain version on the card. Then it drives each path with
the launch counts set to 0 just before and read just after, and fails if a
kernel of the path was not launched, disagrees with its plain version, or
an output is wrong:
  - ``td-serve``: the design server in-process on the full-width
    TIMED_rotamer model (random weights from a fixed seed, bfloat16, batch
    512) and real requests;
  - ``td-sample``: a prediction CSV and a datasetmap made by the port's own
    full-width TIMED_rotamer session (1ubq and a 760-residue multichain),
    sampled in-process by ``main_sample`` (one batched launch per call) and
    once by ``python -m timed_design_tpu_torch.cli.sample``;
  - ProDCoNN, DenseNet and DenseCPD at registry widths: float32 on the card
    against the CPU, bfloat16 against float32, and one ``/design`` with
    samples each from a server of all three;
  - ``td-predict --voxelize``: TIMED and TIMED_rotamer at registry widths,
    batch 512, bfloat16 and float32, over 1ubq, the multichain and a
    two-state NMR file, in-process and once as a subprocess; TIMED_rotamer
    on 1ubq in float32 held to the CPU. It reaches no kernel of the port;
  - the analysis stack: ``td-predict`` of TIMED_rotamer as a CLI subprocess
    whose ``_rot.csv`` the native ``%.18e`` formatter writes (byte-equal to
    ``np.savetxt``), ``td-analyse-rotamers`` on its outputs with a fake
    Scwrl4 on the card and on the CPU (the same results), the metric passes
    alone at 200,000 x 338 on both, the packing count of the multichain on
    both, and ``run_temperature_sweep`` (one batched sampling launch per
    temperature);
  - training (``train/``) on the same 988 frames, shuffled, batch 256: one
    float32 train step of each family at registry widths on the card and
    the CPU against a float64 step; one epoch of ``fit`` of registry TIMED
    in bfloat16 and float32 on those frames; TIMED overfit on 1ubq, its
    checkpoint through ``td-predict --voxelize``. It reaches no kernel of
    the port either;
  - quantized inference: the int8 convolution kernel, its int32 route and
    its fused rescale, cast and bias, held to its plain version on every
    convolution shape of six registry models and timed at TIMED's shapes at
    batch 512 against its bound; each ``--quantize`` mode through
    DesignSession (float32 against the CPU, bfloat16); ``td-predict
    --voxelize --quantize int8`` as a subprocess and in-process (frames/s
    per mode); ``td-serve --quantize int8`` with samples, which launches
    both kernels; TIMED's BatchNorm folding against the unfolded forward;
  - property-constrained design: the sampling kernel past C = 341 (single
    and batched, up to the largest C the card's shared memory takes, held to
    the plain version and timed); 1ubq and the multichain rewritten to a
    zeroed and a seeded charge map and designed by TIMED_Charge at registry
    widths with 100 samples each (one launch a design), TIMED_Polar once;
    the scatter voxelizer against the matmul one and the CPU; the design
    report where matplotlib is installed, else the refusals of
    ``td-report``, ``td-predict --report`` and ``/report``;
  - HDF5 frame datasets (``check_hdf5``): ``td-voxelize``,
    ``td-convert-dataset``, ``td-predict`` from each layout, one epoch of
    ``fit`` from the files, ``td-train`` on 1ubq;
  - Keras ``.h5`` release files (``check_keras``): registry TIMED and
    TIMED_rotamer written by the port's exporter, imported and held to the
    native modules (float32, bf16 at batch 512); ``td-serve --model
    TIMED_rotamer.h5`` with samples (codes equal to the plain version);
    ``td-predict --path_to_model TIMED.h5`` beside ``TIMED@.npz`` and with
    ``--quantize int8``; the TF-written fixtures against TF's predictions,
    each int8 launch of their strided, dilated and even-kernel convolutions
    equal to the plain version; ``td-train --init_from/--output .h5``;
  - the Streamlit design app (``check_ui``), driven through a recording
    stand-in for streamlit at registry widths from ``.h5`` files: the
    design page with Monte-Carlo (one sampling launch a page, held to the
    plain version), a rerun from the design cache, NMR consensus, an
    ensemble, property-constrained design, and the script's start as
    ``streamlit run`` starts it;
  - scale-out (``check_scale_out``): a mesh of one process per card over
    NCCL (``parallel/``): the Predictor over a world of one against one
    card (TIMED and TIMED_rotamer, bf16, and int8 with its launches held to
    the plain version), a float32 train step over the mesh against float64,
    ``fit`` with and without the mesh, ``torchrun`` of td-predict (files
    byte-equal to the plain run's, with and without ``--quantize int8``)
    and of td-train; two ranks where the machine has two cards;
  - the rank-0 front end (``check_front_end``): ``torchrun`` of td-serve (and
    with ``--quantize int8``, and with no launcher through
    ``start_followers``) at world size 1 over NCCL against the one-card
    server, byte for byte, each launch counted and replayed in the child;
    the design app through ``shared_front_end``; the four analysis scripts
    (``timed_design_tpu_torch/scripts``) on the card against the CPU.

The line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import gzip
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# the card's peaks and a Philox block's least work, as the benchmark takes them
from tdbench.peaks import HBM_BYTES_PER_S, INT32_OPS_PER_S, PHILOX_OPS

ROOT = Path(__file__).resolve().parent
UBQ = ROOT / "tests" / "testing_files" / "1ubq.pdb1.gz"
# (L, C, n): kernel-check shapes. The first two are the serving path's own
# (76-residue and 760-residue designs with a 338-class head, 100 samples).
SHAPES = [(76, 338, 100), (760, 338, 100), (76, 338, 1000), (1024, 20, 256), (4096, 338, 64)]
SEED = 20261016
# The single entry's recorded device time per call (PERF.md, section 6): at
# (76, 338, 100) the last run before its tile's rows became a launch
# parameter, at (4096, 338, 64) the highest of four runs before the batched
# entry shared its kernel. The single entry must stay within 10% of each.
RECORDED_US = {(76, 338, 100): 8.19, (4096, 338, 64): 13.69}
FAMILIES = ("ProDCoNN", "DenseNet", "DenseCPD")


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
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
        if (L, C, n) in RECORDED_US:
            ratio = ms * 1e3 / RECORDED_US[(L, C, n)]
            log(f"sample_inverse_cdf L={L} C={C} n={n}: device time / the recorded "
                f"{RECORDED_US[(L, C, n)]} us = {ratio:.3f} (within 10%: {ratio <= 1.1})")
            assert ratio <= 1.1, f"the single entry is slower than recorded at {(L, C, n)}"
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


def batches() -> list[tuple[list[int], int, int]]:
    """(lengths, C, n): the batched entry's check batches. Five lengths from
    1 to 760; three short ones; td-sample's own batch in check_td_sample
    (1ubq and the ten chains of the multichain, 76 residues each, where
    every start and length is a multiple of 4 and the kernel stores four
    codes at once); last, a sweep of 59 structures of 50-400 residues drawn
    from the script's seed."""
    import numpy as np

    sweep = np.random.default_rng(SEED).integers(50, 401, 59).tolist()
    return [([76, 129, 1, 760, 33], 338, 100), ([25, 40, 33], 20, 256),
            ([76] * 11, 338, 100), (sweep, 338, 100)]


def check_batched_kernel() -> dict:
    """sample_inverse_cdf_batched against sample_codes_plain_batched run on
    a CPU copy: codes and counts equal on every batch of batches(), with a
    class map (uint8 codes) and without (int16 codes at 338 classes); B = 1
    equal to the single entry bit for bit. For the 59-structure sweep with
    the rotamer map: (a) the host-inclusive time per call (offsets checked
    and copied from the host each call); (b) the device time per call, a
    CUDA graph of 20 launches given the checked device offsets; (c) the
    bound with the packed sizes; (d) torch.searchsorted on the packed CDF
    and the uniforms; (e) the plain version on the card; (f) 59 single-entry
    calls, one per structure, host-inclusive and as a graph."""
    import numpy as np
    import torch

    from timed_design_tpu_torch.ops.sample import (
        N_COUNTED,
        _host_offsets,
        _launch_batched,
        _tile_rows,
        philox_uniforms_batched,
        sample_codes_plain_batched,
        sample_inverse_cdf,
        sample_inverse_cdf_batched,
    )

    dev = torch.device("cuda")
    equal, max_err = True, 0
    for i, (lengths, C, n) in enumerate(batches()):
        offsets = np.concatenate([[0], np.cumsum(lengths)])
        total = int(offsets[-1])
        probs_cpu = torch.from_numpy(random_probs(total, C, 100 + i))
        probs = probs_cpu.to(dev)
        u_cpu = torch.from_numpy(philox_uniforms_batched(SEED, n, offsets))
        for cmap in (None, class_map(C)):
            codes, counts = sample_inverse_cdf_batched(probs, offsets, n, SEED,
                                                       None if cmap is None else cmap.to(dev))
            want_codes, want_counts = sample_codes_plain_batched(probs_cpu, offsets, u_cpu, cmap)
            torch.cuda.synchronize()
            assert codes.shape == (n, total) and codes.dtype == want_codes.dtype
            assert counts.shape == (len(lengths), n, N_COUNTED)
            err = max(int((codes.cpu().long() - want_codes.long()).abs().max()),
                      int((counts.cpu() - want_counts).abs().max()))
            max_err, equal = max(max_err, err), equal and err == 0
            log(f"sample_inverse_cdf_batched B={len(lengths)} sum L={total} C={C} n={n} "
                f"map={cmap is not None} codes {codes.dtype}: codes and counts equal to the "
                f"plain version on the CPU: {err == 0}")
    # B = 1 is the single entry, with and without a map
    one = torch.from_numpy(random_probs(76, 338, 0)).to(dev)
    for cmap in (None, class_map(338).to(dev)):
        a = sample_inverse_cdf_batched(one, [0, 76], 100, SEED, cmap)
        b = sample_inverse_cdf(one, 100, SEED, cmap)
        same = torch.equal(a[0], b[0]) and torch.equal(a[1][0], b[1])
        log(f"sample_inverse_cdf_batched B=1 (76, 338, 100) map={cmap is not None}: equal to "
            f"the single entry bit for bit: {same}")
        equal &= same

    # the timings: the loop's last batch, the sweep, with the rotamer map
    B = len(lengths)
    smap = class_map(C).to(dev)
    dev_offsets = torch.from_numpy(_host_offsets(offsets, total).astype(np.int32)).to(dev)
    host_ms = time_ms(lambda: sample_inverse_cdf_batched(probs, offsets, n, SEED, smap))
    rows = _tile_rows(C, torch.cuda.current_device())
    ms = graph_ms(lambda: _launch_batched(probs, dev_offsets, n, SEED, smap, rows))
    u = torch.from_numpy(philox_uniforms_batched(SEED, n, offsets)).to(dev)
    cdf, ut = torch.cumsum(probs, -1), u.T.contiguous()
    library_ms = graph_ms(lambda: torch.searchsorted(cdf, ut, right=True))
    plain_ms = graph_ms(lambda: sample_codes_plain_batched(probs, offsets, u, smap))
    slices = [probs[a:e] for a, e in zip(offsets[:-1].tolist(), offsets[1:].tolist())]

    def singles():
        for p in slices:
            sample_inverse_cdf(p, n, SEED, smap)

    singles_host_ms = time_ms(singles, reps=5)
    singles_ms = graph_ms(singles, reps=5)
    bound_ms, bound_by = bound(total, C, n, n * total + B * n * N_COUNTED * 4 + C
                               + (B + 1) * 4)
    log(f"sample_inverse_cdf_batched B={B} sum L={total} C={C} n={n} map=True: (a) "
        f"host-inclusive {host_ms:.4f} ms/call; (b) device {ms * 1e3:.2f} us/call; (c) bound "
        f"{bound_ms * 1e3:.3f} us ({bound_by}), share {bound_ms / ms:.3f}; (d) searchsorted "
        f"{library_ms * 1e3:.2f} us (given the packed CDF and the uniforms); (e) plain "
        f"{plain_ms * 1e3:.2f} us (given the uniforms); (f) {B} single-entry calls: "
        f"host-inclusive {singles_host_ms:.4f} ms, device {singles_ms * 1e3:.2f} us")
    assert equal, "the batched entry disagrees with its plain version"
    return {"shape": [B, total, C, n], "map": True, "equal_to_plain": equal,
            "max_abs_err": max_err, "host_ms": host_ms, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "singles_ms": singles_ms,
            "singles_host_ms": singles_host_ms}


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


def check_serving() -> dict:
    """The design server on the card: counts the kernel launches it makes."""
    import numpy as np
    import torch

    from timed_design_tpu_torch.cli.serve import build_designers, build_parser, make_server
    from timed_design_tpu_torch.ops.sample import sample_inverse_cdf, sample_inverse_cdf_batched
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
        sample_inverse_cdf.launches = sample_inverse_cdf_batched.launches = 0
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
        launches_batched = sample_inverse_cdf_batched.launches
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
    assert launches_batched == 0
    split = {"design_1ubq_n100": bodies, "design_760res_n100": [big],
             "design_1ubq_n100_8_concurrent": [b for _, b, _ in conc]}
    for k, v in lat.items():
        log(f"serving latency {k}: " + ", ".join(
            f"{x * 1e3:.1f} ms ({stages(b['timings_s'])}, "
            f"group {b['timings_s']['group_requests']})" for x, b in zip(v, split[k])))
    log(json.dumps({"serving_latency_s": lat}))
    return {"launches": launches}


def check_reference(name: str, n_classes: int) -> dict:
    """The whole design path of registry model ``name`` on the card against
    the same model on the CPU in float32 (1ubq): probabilities within 1e-4;
    then bfloat16 against float32 on the card."""
    import copy

    import numpy as np
    import torch

    from timed_design_tpu_torch.engine import DesignSession

    gpu = DesignSession(name, compute_dtype="float32", batch_size=128,
                        allow_random_weights=True, device="cuda")
    model = gpu.predictor.model
    cpu = DesignSession(copy.deepcopy(model).cpu(), codec="CNOCACB", batch_size=80,
                        device="cpu")
    want, _ = cpu.design(UBQ)
    got, _ = gpu.design(UBQ)
    err = float(np.abs(got - want).max())
    agree = float((got.argmax(1) == want.argmax(1)).mean())
    log(f"reference {name}: 1ubq float32 GPU vs CPU max |dp| = {err:.3g}, argmax agreement "
        f"{agree:.3f}")
    assert got.shape == (76, n_classes) and np.isfinite(got).all() and err <= 1e-4
    half = copy.deepcopy(model)
    half.compute_dtype = torch.bfloat16
    pb, _ = DesignSession(half, codec="CNOCACB", batch_size=128, device="cuda").design(UBQ)
    bf16 = {"max_abs_dp": float(np.abs(pb - got).max()),
            "argmax_agreement": float((pb.argmax(1) == got.argmax(1)).mean())}
    log(f"reference {name}: 1ubq bfloat16 vs float32 on the GPU max |dp| = "
        f"{bf16['max_abs_dp']:.3g}, argmax agreement {bf16['argmax_agreement']:.3f}")
    return {"f32_gpu_vs_cpu_max_abs_dp": err, "bf16": bf16}


def check_families() -> dict:
    """ProDCoNN, DenseNet and DenseCPD at registry widths: each held to the
    CPU in float32 and its bfloat16 compared (check_reference); then one
    server of all three (random weights, bfloat16, batch 512) answers two
    /design requests with 100 samples per family, the first of each
    including cuDNN's warm-up."""
    import numpy as np

    from timed_design_tpu_torch.cli.serve import build_designers, build_parser, make_server
    from timed_design_tpu_torch.ops.sample import sample_inverse_cdf, sample_inverse_cdf_batched
    from timed_design_tpu_torch.sample.metrics import sequence_metrics

    out = {name: check_reference(name, 20) for name in FAMILIES}
    argv = ["--allow-random-weights", "--batch_size", "512"]
    for name in FAMILIES:
        argv += ["--model", name]
    designers = build_designers(build_parser().parse_args(argv))
    server = make_server(designers[FAMILIES[0]], "127.0.0.1", 0, FAMILIES[0],
                         extra_designers={k: designers[k] for k in FAMILIES[1:]})
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/design"
    pdb = gzip.decompress(UBQ.read_bytes()).decode()
    try:
        sample_inverse_cdf.launches = sample_inverse_cdf_batched.launches = 0
        for name in FAMILIES:
            lat = []
            reset_dense_block_launches()
            for _ in range(2):
                status, body, dt = post(url, {"pdb": pdb, "n_samples": 100, "temperature": 0.2,
                                              "seed": 7, "model": name})
                assert status == 200 and body["model"] == name and body["n_residues"] == 76
                p = np.array(body["probabilities"])
                assert p.shape == (76, 20) and np.isfinite(p).all()
                assert np.abs(p.sum(1) - 1).max() <= 1e-3 and len(body["samples"]) == 100
                for smp in body["samples"][:5]:
                    got = (smp["charge"], smp["isoelectric_point"], smp["molecular_weight"],
                           smp["molar_extinction"])
                    assert len(smp["sequence"]) == 76
                    assert np.allclose(got, sequence_metrics(smp["sequence"]), rtol=1e-4, atol=0.05)
                lat.append(dt)
            out[name]["design_1ubq_n100_s"] = lat
            out[name]["dense_block_launches"] = dense_block_forwards(name, "2 /design requests")
            log(f"serving {name} (bf16, batch 512): /design 1ubq n=100 latency "
                + ", ".join(f"{x * 1e3:.1f} ms" for x in lat) + f" ({stages(body['timings_s'])})")
        launches = sample_inverse_cdf.launches
        assert sample_inverse_cdf_batched.launches == 0
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)
        for d in designers.values():
            d.close()
    log(f"serving the families: launches of sample_inverse_cdf = {launches}")
    assert launches == 2 * len(FAMILIES), "a family's /design did not go through the kernel"
    return {"launches": launches, "per_family": out,
            "dense_block_launches": {k: out[k]["dense_block_launches"] for k in FAMILIES}}


DENSE_BATCH = 512
DENSE_KERNELS = ("dense_bn_relu", "dense_bias_store", "dense_pool_store")


def reset_dense_block_launches() -> None:
    from timed_design_tpu_torch.ops import dense_block as db

    db.bn_relu.launches = db.bias_store.launches = db.pool_bias_store.launches = 0


def dense_block_forwards(model: str, what: str) -> dict:
    """The dense-block kernels' launches since ``reset_dense_block_launches``
    for ``what`` with registry ``model``: a whole number of evaluation
    forwards of its block buffers (at least one for DenseNet and DenseCPD,
    none for another family)."""
    from timed_design_tpu_torch.models import MODEL_REGISTRY
    from timed_design_tpu_torch.ops import dense_block as db

    got = [db.bn_relu.launches, db.bias_store.launches, db.pool_bias_store.launches]
    m = MODEL_REGISTRY[model].build()
    if hasattr(m, "block_layers"):
        n, t = sum(m.block_layers), len(m.transitions)
        per = [2 * n + t + 1, n + 1, t]
    else:
        per = [0, 0, 0]
    forwards = got[0] // per[0] if per[0] else 0
    log(f"{what} with {model}: launches of {', '.join(DENSE_KERNELS)} = {got}; "
        f"{forwards} forwards of {per}")
    assert got == [forwards * k for k in per] and (forwards > 0) == (per[0] > 0), (got, per)
    return {"launches": got, "forwards": forwards, "per_forward": per}


def check_dense_block() -> dict:
    """The dense-block kernels (``csrc/dense_block.cu``) at DenseCPD's
    bfloat16 shapes, batch 512: each held bit for bit to its plain version
    on the card, then timed (``graph_ms``) beside its bound (its bytes, each
    read once and written once, over HBM), the plain version and, as
    context, the PyTorch sequence the concatenating path ran for the same
    step. Then one DenseCPD forward of 512 frames both ways (block buffers;
    ``_logits_concatenated``, the path of training and autograd), A B B A:
    device time, the spans, and the kernels by name under torch.profiler;
    no kernel of the buffered path may match ``tdbench/densenet.py::CONV``.
    The two paths' logits are compared in bfloat16 and under ``--quantize
    int8`` (needs ``conv3d_int8`` built)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tdbench.densenet import CONV
    from timed_design_tpu_torch.models import MODEL_REGISTRY, quantized_convs
    from timed_design_tpu_torch.ops import dense_block as db
    from timed_design_tpu_torch.utils import timing

    dev, bf16, B = torch.device("cuda"), torch.bfloat16, DENSE_BATCH
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def bn(c):
        m = torch.nn.BatchNorm3d(c, eps=1e-3).to(dev).eval()
        with torch.no_grad():
            m.running_mean.uniform_(-0.5, 0.5, generator=gen)
            m.running_var.uniform_(0.2, 3.0, generator=gen)
            m.weight.uniform_(0.5, 1.5, generator=gen)
            m.bias.uniform_(-0.3, 0.3, generator=gen)
        return m

    def stats(m):
        return m.running_mean, m.running_var, m.weight, m.bias, m.eps

    rows0 = B * 21 ** 3
    buf0 = randn(B, 21, 21, 21, 128)
    cases = []
    for C in (32, 112):  # block 0's first and last layer's prefix
        m = bn(C)
        cat = buf0[..., :C].contiguous()  # the concatenated tensor the old path held
        cases.append((f"bn_relu {C} of 128 @21^3", rows0 * C * 4,
                      lambda C=C, m=m: db.bn_relu(buf0, C, *stats(m)),
                      lambda C=C, m=m: db.bn_relu_plain(buf0, C, *stats(m)),
                      lambda m=m, cat=cat: F.relu(m(cat.permute(0, 4, 1, 2, 3).float())).to(bf16)))
    m64, h64, b64 = bn(64), randn(B, 21, 21, 21, 64), randn(64, dtype=torch.float32)
    cases.append(("bn_relu + conv bias 64 @21^3", rows0 * 64 * 4,
                  lambda: db.bn_relu(h64, 64, *stats(m64), b64),
                  lambda: db.bn_relu_plain(h64, 64, *stats(m64), b64),
                  lambda: F.relu(m64((h64.permute(0, 4, 1, 2, 3) + b64.to(bf16).view(-1, 1, 1, 1))
                                     .float())).to(bf16)))
    h16, b16 = randn(B, 21, 21, 21, 16), randn(16, dtype=torch.float32)
    prefix = buf0[..., :112].contiguous()
    cases.append(("bias_store 16 at 112 of 128 @21^3", rows0 * 16 * 4,
                  lambda: db.bias_store(h16, b16, buf0, 112),
                  lambda: db.bias_store_plain(h16, b16, buf0, 112),
                  lambda: torch.cat([prefix.permute(0, 4, 1, 2, 3),
                                     h16.permute(0, 4, 1, 2, 3) + b16.to(bf16).view(-1, 1, 1, 1)],
                                    dim=1)))
    buf1 = randn(B, 10, 10, 10, 160)
    # the pool reads the 20^3 voxels its cells cover (21 floors to 10)
    cases.append(("pool_store 64 @21^3 -> 10^3 of 160", B * (20 ** 3 + 10 ** 3) * 64 * 2,
                  lambda: db.pool_bias_store(h64, b64, buf1),
                  lambda: db.pool_bias_store_plain(h64, b64, buf1),
                  lambda: F.avg_pool3d((h64.permute(0, 4, 1, 2, 3)
                                        + b64.to(bf16).view(-1, 1, 1, 1)).float(), 2, 2).to(bf16)))
    buf2, m176 = randn(B, 5, 5, 5, 176), bn(176)
    cases.append(("head bn_relu 176 @5^3 -> float32", B * 125 * 176 * 6,
                  lambda: db.bn_relu(buf2, 176, *stats(m176), out_dtype=torch.float32),
                  lambda: db.bn_relu_plain(buf2, 176, *stats(m176), out_dtype=torch.float32),
                  lambda: F.relu(m176(buf2.permute(0, 4, 1, 2, 3).float()))))
    out = {"card": gpu_name_and_power(), "kernels": []}
    with torch.inference_mode():
        for name, moved, kernel, plain, unfused in cases:
            before = (buf0.clone(), buf1.clone())
            got = kernel()
            got = got if got is not None else (buf0.clone(), buf1.clone())
            buf0.copy_(before[0]), buf1.copy_(before[1])
            want = plain()
            want = want if want is not None else (buf0.clone(), buf1.clone())
            torch.cuda.synchronize()
            same = (torch.equal(got, want) if isinstance(got, torch.Tensor)
                    else all(torch.equal(a, b) for a, b in zip(got, want)))
            assert same, f"dense_block {name}: the kernel differs from its plain version"
            row = {"name": name, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                   "kernel_ms": graph_ms(kernel), "plain_ms": graph_ms(plain, reps=5),
                   "unfused_ms": graph_ms(unfused, reps=5)}
            row["share"] = row["bound_ms"] / row["kernel_ms"]
            out["kernels"].append(row)
            log(f"dense_block {name}: kernel {row['kernel_ms']:.4f} ms (bound "
                f"{row['bound_ms']:.4f}, share {row['share']:.3f}); plain "
                f"{row['plain_ms']:.4f} ms; unfused PyTorch sequence (context) "
                f"{row['unfused_ms']:.4f} ms")
    del buf0, buf1, buf2, h64, h16, prefix
    torch.cuda.empty_cache()

    module = MODEL_REGISTRY["DenseCPD"].build(compute_dtype=bf16).to(dev).eval()
    x = torch.rand(B, 21, 21, 21, 5, generator=gen, device=dev)
    paths = {"buffered": lambda: module(x, logits=True),
             "concatenated": lambda: module._logits_concatenated(
                 x.to(bf16).permute(0, 4, 1, 2, 3))}
    ms = {k: [] for k in paths}
    with torch.inference_mode():
        want = paths["concatenated"]().float()
        got = paths["buffered"]().float()
        gap = float((got - want).abs().max() / want.abs().max())
        log(f"dense_block: DenseCPD bf16 logits, buffered against concatenated, max gap "
            f"{gap:.3g} of the largest")
        assert gap <= 2.0 ** -7
        # int8: the int8 kernel's convolutions without their bias, which the
        # dense-block passes add, against the concatenating path's biased ones
        with quantized_convs("int8"):
            want8 = paths["concatenated"]().float()
            got8 = paths["buffered"]().float()
        out["int8_gap"] = float((got8 - want8).abs().max() / want8.abs().max())
        log(f"dense_block: DenseCPD int8 logits, buffered against concatenated, max gap "
            f"{out['int8_gap']:.3g} of the largest")
        assert out["int8_gap"] <= 2.0 ** -4
        for name in ("buffered", "concatenated", "concatenated", "buffered"):
            for _ in range(3):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                paths[name]()
                end.record()
                end.synchronize()
                ms[name].append(start.elapsed_time(end))
        out["forward_ms"] = {k: float(np.median(v)) for k, v in ms.items()}
        log("dense_block: DenseCPD forward of 512 bf16 frames (ms, median of 6): " + ", ".join(
            f"{k} {v:.2f}" for k, v in out["forward_ms"].items()))
        counts = (db.bn_relu.launches, db.bias_store.launches, db.pool_bias_store.launches)
        with timing.recording() as rec:
            paths["buffered"]()
        out["launches_a_forward"] = [a - b for a, b in zip(
            (db.bn_relu.launches, db.bias_store.launches, db.pool_bias_store.launches), counts)]
        assert out["launches_a_forward"] == [39, 19, 2], out["launches_a_forward"]
        spans: dict = {}
        for name, id_, t in rec.device_spans:
            spans[f"{name}{'' if id_ is None else id_}"] = t
        out["spans_ms"], out["counters"] = spans, dict(rec.counters)
        log("dense_block: buffered spans (ms) "
            + ", ".join(f"{k} {v:.2f}" for k, v in spans.items()) + f"; counters {rec.counters}")
        for name, fn in paths.items():
            events = device_events(fn)
            by_name: dict = {}
            for e in events:
                by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
            total = sum(by_name.values()) / 1e3
            log(f"dense_block: {name} forward under torch.profiler, device {total:.2f} ms, "
                f"{len(events)} events")
            for k, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
                log(f"dense_block:   {us / 1e3:8.3f} ms  {k[:100]}")
            out[f"profile_{name}_ms"] = total
            if name == "buffered":
                mine = [k for k in by_name if "dense_" in k]
                assert len(mine) >= 3 and not any(CONV.search(k) for k in mine), mine
                out["dense_kernels_ms"] = sum(by_name[k] for k in mine) / 1e3
                out["kernel_names"] = sorted({k.split("<")[0] for k in mine})
    log(f"dense_block: {json.dumps(out)}")
    return out


def check_td_sample() -> dict:
    """td-sample on the card. The port's full-width TIMED_rotamer session
    (random weights, bfloat16, batch 512) designs 1ubq and the 760-residue
    multichain; the port's writers save the rotamer probability CSV, the
    argmax fasta and the per-residue datasetmap. ``main_sample`` then runs
    in-process twice (T = 0.5, 100 samples, seed 42), with exactly one
    batched launch per call; the files, every sequence's length and every
    sample's metrics (recomputed from its sequence) are checked. Then the
    same run as a subprocess of the CLI, whose fasta must equal the
    in-process one byte for byte. Last, ``main_sample`` with device cpu,
    the plain version on the same uniforms: its fasta equals the card's
    byte for byte, and its json the card's sequences."""
    import dataclasses
    import json
    import os
    import tempfile

    import numpy as np

    from timed_design_tpu_torch.constants import ROTAMER_CATEGORIES
    from timed_design_tpu_torch.engine import DesignSession
    from timed_design_tpu_torch.io import (
        DatasetMap,
        extract_sequences,
        load_datasetmap,
        load_prediction_matrix,
        save_datasetmap,
        save_dict_to_fasta,
        save_prediction_csv,
    )
    from timed_design_tpu_torch.ops.sample import sample_inverse_cdf, sample_inverse_cdf_batched
    from timed_design_tpu_torch.sample import (
        SampleConfig,
        apply_temperature,
        main_sample,
        sample_all_structures,
        sequence_metrics,
    )
    from timed_design_tpu_torch.structure import parse_pdb_string

    work = Path(tempfile.mkdtemp(prefix=".chip_smoke_td_sample_", dir=ROOT))
    cwd = Path.cwd()
    try:
        session = DesignSession("TIMED_rotamer", batch_size=512, allow_random_weights=True,
                                device="cuda")
        text = gzip.decompress(UBQ.read_bytes()).decode()
        entries, argmax = [], {}
        for name, pdb in (("1ubq", text), ("mult", multichain_pdb(text))):
            probs, fa = session.design(parse_pdb_string(pdb, name=name)[0])
            save_prediction_csv(probs, "TIMED_rotamer", work, rotamer=True)
            entries += [(name, c, r, lab) for c, r, lab in zip(fa.chain_ids, fa.residue_ids,
                                                                 fa.labels)]
            argmax[name] = session.design_sequence(parse_pdb_string(pdb, name=name)[0])
        save_dict_to_fasta(argmax, "TIMED_rotamer", work)
        dmap = save_datasetmap(DatasetMap(entries=entries), work / "datasetmap.txt")
        lengths: dict[str, int] = {}
        for pdb, chain, *_ in entries:
            lengths[pdb + chain] = lengths.get(pdb + chain, 0) + 1
        cfg = SampleConfig(work / "TIMED_rotamer_rot.csv", dmap, sample_n=100, temperature=0.5,
                           support_old_datasetmap=True, device="cuda")
        os.chdir(work)
        walls = []
        sample_inverse_cdf.launches = sample_inverse_cdf_batched.launches = 0
        for _ in range(2):
            t0 = time.perf_counter()
            paths = main_sample(cfg)
            walls.append(time.perf_counter() - t0)
        launches = sample_inverse_cdf_batched.launches
        assert sample_inverse_cdf.launches == 0
        assert launches == 2, f"{launches} batched launches for 2 main_sample calls"
        # where a call's time goes: the CSV read, and the sampling alone
        t0 = time.perf_counter()
        matrix = load_prediction_matrix(cfg.path_to_pred_matrix)
        split = {"read_csv": time.perf_counter() - t0}
        decoded = extract_sequences(load_datasetmap(dmap, is_old=True),
                                    apply_temperature(matrix, 0.5), ROTAMER_CATEGORIES)
        t0 = time.perf_counter()
        sample_all_structures(decoded.pdb_to_probability, 100, rotamer_mode=True, device="cuda")
        split["sample_all_structures"] = time.perf_counter() - t0
        assert [Path(p).name for p in paths] == [
            f"TIMED_rotamer_rot_temp_0.5_n_100_1ubqA{e}" for e in (".json", ".fasta", "_metrics.csv")]
        samples = json.loads((work / paths[0]).read_text())
        assert {k: len(v) for k, v in samples.items()} == {k: 100 for k in lengths}
        worst = 0.0
        for pdb, rows in samples.items():
            for seq, *metrics in rows:
                assert len(seq) == lengths[pdb] and set(seq) <= set("ACDEFGHIKLMNPQRSTVWY")
                want = sequence_metrics(seq)
                worst = max(worst, float(np.max(np.abs(np.subtract(metrics, want))
                                                / np.maximum(np.abs(want), 1.0))))
        assert worst <= 1e-4, f"metrics differ from the sequences' by {worst:.3g}"
        csv_lines = (work / paths[2]).read_text().splitlines()
        assert len(csv_lines) == 1 + 100 * len(lengths)
        fasta = (work / paths[1]).read_bytes()
        for p in paths:
            os.replace(work / p, work / f"inproc_{p}")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "timed_design_tpu_torch.cli.sample",
             "--path_to_pred_matrix", str(cfg.path_to_pred_matrix),
             "--path_to_datasetmap", str(dmap), "--support_old_datasetmap",
             "--sample_n", "100", "--temperature", "0.5"],
            cwd=work, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT)})
        cli_wall = time.perf_counter() - t0
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert (work / paths[1]).read_bytes() == fasta, "the CLI drew other sequences"
        # the plain version on the same files and the same Philox uniforms:
        # td-sample's batch, every start and length a multiple of 4, takes
        # the kernel's four-code store
        t0 = time.perf_counter()
        cpu_paths = main_sample(dataclasses.replace(cfg, device="cpu"))
        cpu_wall = time.perf_counter() - t0
        assert cpu_paths == paths
        assert (work / paths[1]).read_bytes() == fasta, "the card's sequences differ from the CPU's"
        cpu_samples = json.loads((work / paths[0]).read_text())
        assert {k: [r[0] for r in v] for k, v in cpu_samples.items()} == {
            k: [r[0] for r in v] for k, v in samples.items()}
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    log(f"td-sample: {len(lengths)} structures ({sum(lengths.values())} residues), 100 samples "
        f"each, T=0.5: main_sample wall {walls[0]:.3f} s (first), {walls[1]:.3f} s "
        f"(of which reading the CSV {split['read_csv']:.3f} s, sample_all_structures "
        f"{split['sample_all_structures']:.4f} s); "
        f"{launches} batched launches for 2 calls; metrics agree with the sequences to "
        f"{worst:.2g}; CLI subprocess rc 0 in {cli_wall:.2f} s, same fasta; main_sample "
        f"with device cpu (the plain version) in {cpu_wall:.3f} s, same fasta and sequences")
    return {"launches": launches, "main_sample_wall_s": walls, "split_s": split,
            "cli_wall_s": cli_wall, "cpu_main_sample_wall_s": cpu_wall,
            "structures": len(lengths)}


def nmr_pdb(text: str, states: int = 2) -> str:
    """``states`` MODELs of 1ubq's first model, every atom moved by noise
    of 0.2 A drawn from the script's seed."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    atoms = []
    for line in text.splitlines():
        if line.startswith("ENDMDL"):
            break
        if line.startswith("ATOM"):
            atoms.append(line)
    out = []
    for k in range(states):
        out.append(f"MODEL     {k + 1:4d}")
        for line in atoms:
            x, y, z = (float(line[30:38]), float(line[38:46]), float(line[46:54])) + rng.normal(
                0, 0.2, 3)
            out.append(f"{line[:30]}{x:8.3f}{y:8.3f}{z:8.3f}{line[54:]}")
        out.append("ENDMDL")
    return "\n".join(out + ["END"]) + "\n"


def write_structures(inputs: Path) -> None:
    """The td-predict and train phases' PDB files in ``inputs``: 1ubq, the
    760-residue multichain and a two-state NMR file, 988 frames with every
    NMR state a structure."""
    inputs.mkdir()
    text = gzip.decompress(UBQ.read_bytes()).decode()
    shutil.copy(UBQ, inputs / "1ubq.pdb1.gz")
    (inputs / "mult.pdb").write_text(multichain_pdb(text))
    (inputs / "2nmr.pdb").write_text(nmr_pdb(text))


PREDICT_STRUCTURAL = ("datasetmap.txt", "encoded_labels.csv", "dataset.fasta")


def check_td_predict_outputs(out: Path, model: str, rotamer: bool, nmr: bool) -> int:
    """Every artifact of a td-predict run is there, and every fasta record
    is as long as its chain's rows in the map; returns the residue count."""
    import numpy as np

    names = [*PREDICT_STRUCTURAL, f"{model}.csv", f"{model}.fasta", f"{model}.txt"]
    names += [f"{model}_rot.csv"] if rotamer else []
    names += [f"{model}_consensus.{e}" for e in ("fasta", "csv", "txt")] if nmr else []
    missing = [n for n in names if not (out / n).exists()]
    assert not missing, f"td-predict left out {missing}"
    rows: dict[str, int] = {}
    for line in (out / "datasetmap.txt").read_text().splitlines():
        pdb, chain, *_ = line.split(",")
        rows[pdb + chain] = rows.get(pdb + chain, 0) + 1
    for fasta in (f"{model}.fasta", "dataset.fasta"):
        lines = (out / fasta).read_text().splitlines()
        got = {k[1:]: len(v) for k, v in zip(lines[0::2], lines[1::2])}
        assert got == rows, f"{fasta}: record lengths differ from the map's residue counts"
    n = sum(rows.values())
    for csv in [f"{model}.csv"] + ([f"{model}_rot.csv"] if rotamer else []):
        P = np.loadtxt(out / csv, delimiter=",", ndmin=2)
        assert P.shape == (n, 338 if csv.endswith("_rot.csv") else 20) and np.isfinite(P).all()
    return n


def check_td_predict() -> dict:
    """td-predict --voxelize on the card, in-process through the CLI's
    ``main``: TIMED and TIMED_rotamer at registry widths (random weights
    from a fixed seed), batch 512, over 1ubq, the 760-residue multichain and
    a two-state NMR file (``--is_structure_nmr``, 988 frames in all); per
    model bfloat16 (its first run warms cuDNN up), float32, bfloat16 again.
    Prints the phase timings, frames/s of the predict phase (the warm
    bfloat16 run) and the bfloat16 against float32 argmax agreement. Then
    once as a subprocess of ``python -m timed_design_tpu_torch.cli.predict``
    (its files without a probability equal the in-process run's), and
    TIMED_rotamer on 1ubq in float32 on the card against the CPU:
    probabilities within 1e-4, the files without a probability byte-equal.
    Then DenseCPD in bfloat16 at batch 512 (after a warm-up run): its
    BN-ReLUs all through the block buffers, the dense-block kernels
    launched a whole number of forwards, at least one a batch. This path
    reaches no TPU kernel: the sampling kernel's counts stay 0."""
    import os
    import tempfile

    import numpy as np

    from timed_design_tpu_torch.cli.predict import main as predict_main
    from timed_design_tpu_torch.ops.sample import sample_inverse_cdf, sample_inverse_cdf_batched

    device, models = "cuda", ("TIMED", "TIMED_rotamer")
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix=".chip_smoke_td_predict_", dir=ROOT))
    try:
        inputs = work / "in"
        write_structures(inputs)

        def run(model, dtype, out, path=inputs, dev=device, batch=512, nmr=True):
            rotamer = model.endswith("rotamer")
            argv = ["--voxelize", "--path_to_dataset", str(path), "--path_to_model", model,
                    "--allow-random-weights", "--batch_size", str(batch), "--compute_dtype",
                    dtype, "--device", dev, "--path_to_output", str(out),
                    "--path_to_datasetmap", str(out / "datasetmap.txt")]
            argv += ["--predict_rotamers"] if rotamer else []
            argv += ["--is_structure_nmr"] if nmr else []
            result = predict_main(argv)
            return result, check_td_predict_outputs(out, model, rotamer, nmr)

        sample_inverse_cdf.launches = sample_inverse_cdf_batched.launches = 0
        per_model = {}
        for model in models:
            rotamer = model.endswith("rotamer")
            matrix = f"{model}_rot.csv" if rotamer else f"{model}.csv"
            runs = {}
            for tag, dtype in (("bf16_first", "bfloat16"), ("f32", "float32"),
                               ("bf16", "bfloat16")):
                result, n = run(model, dtype, work / f"{model}_{tag}")
                runs[tag] = {"timings_s": result.timings, "frames": n,
                             "predict_frames_per_s": n / result.timings["predict"]}
                log(f"td-predict {model} {dtype} ({tag}), {n} frames, batch 512: " + ", ".join(
                    f"{k} {v:.3f} s" for k, v in result.timings.items())
                    + f"; predict {n / result.timings['predict']:.0f} frames/s")
            for name in PREDICT_STRUCTURAL + (f"{model}.txt", f"{model}_consensus.txt"):
                assert len({(work / f"{model}_{t}" / name).read_bytes() for t in runs}) == 1, name
            bf = np.loadtxt(work / f"{model}_bf16" / matrix, delimiter=",", ndmin=2)
            f32 = np.loadtxt(work / f"{model}_f32" / matrix, delimiter=",", ndmin=2)
            agree = float((bf.argmax(1) == f32.argmax(1)).mean())
            per_model[model] = {"runs": runs, "bf16_vs_f32_argmax_agreement": agree,
                                "bf16_vs_f32_max_abs_dp": float(np.abs(bf - f32).max())}
            log(f"td-predict {model}: bfloat16 against float32 argmax agreement {agree:.4f} "
                f"({matrix}, {bf.shape[0]} residues, max |dp| "
                f"{per_model[model]['bf16_vs_f32_max_abs_dp']:.3g}); warm bfloat16 predict "
                f"{runs['bf16']['predict_frames_per_s']:.0f} frames/s; {gpu_name_and_power()}")

        # DenseCPD, bf16, batch 512: the block buffers and their kernels on
        # td-predict's main path, counted around this run alone
        from timed_design_tpu_torch.utils import timing

        run("DenseCPD", "bfloat16", work / "DenseCPD_bf16_first")  # cuDNN's warm-up
        reset_dense_block_launches()
        with timing.recording() as rec:
            result, n = run("DenseCPD", "bfloat16", work / "DenseCPD_bf16")
        dense = dense_block_forwards("DenseCPD", f"td-predict --voxelize, {n} frames, batch 512")
        bn_relu_paths = {k: rec.counters.get(f"densenet.bn_relu.{k}", 0)
                         for k in ("fused", "plain")}
        assert dense["forwards"] >= -(-n // 512), dense
        assert bn_relu_paths == {"fused": dense["launches"][0], "plain": 0}, bn_relu_paths
        per_model["DenseCPD"] = {"timings_s": result.timings, "frames": n,
                                 "predict_frames_per_s": n / result.timings["predict"],
                                 "dense_block_launches": dense, "bn_relu": bn_relu_paths}
        log(f"td-predict DenseCPD bfloat16, {n} frames, batch 512: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in result.timings.items())
            + f"; predict {n / result.timings['predict']:.0f} frames/s; BN-ReLUs {bn_relu_paths}")

        model = models[-1]
        t0 = time.perf_counter()
        out = work / "cli"
        proc = subprocess.run(
            [sys.executable, "-m", "timed_design_tpu_torch.cli.predict", "--voxelize",
             "--path_to_dataset", str(inputs), "--path_to_model", model,
             "--allow-random-weights", "--predict_rotamers", "--is_structure_nmr",
             "--compute_dtype", "bfloat16", "--device", device, "--path_to_output", str(out),
             "--path_to_datasetmap", str(out / "datasetmap.txt")],
            cwd=work, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT)})
        cli_wall = time.perf_counter() - t0
        assert proc.returncode == 0, proc.stdout + proc.stderr
        n = check_td_predict_outputs(out, model, True, True)
        assert f"Predicted {n} residues" in proc.stdout
        for name in PREDICT_STRUCTURAL + (f"{model}.txt", f"{model}_consensus.txt"):
            assert (out / name).read_bytes() == (work / f"{model}_bf16" / name).read_bytes(), name
        log(f"td-predict CLI subprocess ({model}, bfloat16): rc 0 in {cli_wall:.2f} s")

        # the card against the CPU: 1ubq, float32 (the CPU's batch is smaller,
        # which changes no row)
        cmp = {}
        for dev, batch in ((device, 512), ("cpu", 80)):
            cmp[dev] = work / f"ubq_{dev}"
            run(model, "float32", cmp[dev], path=inputs / "1ubq.pdb1.gz", dev=dev, batch=batch,
                nmr=False)
        want = np.loadtxt(cmp["cpu"] / f"{model}_rot.csv", delimiter=",")
        got = np.loadtxt(cmp[device] / f"{model}_rot.csv", delimiter=",")
        err = float(np.abs(got - want).max())
        same = [name for name in PREDICT_STRUCTURAL + (f"{model}.txt",)
                if (cmp[device] / name).read_bytes() == (cmp["cpu"] / name).read_bytes()]
        log(f"td-predict {model} 1ubq float32, {device} against cpu: max |dp| = {err:.3g}; "
            f"byte-equal: {', '.join(same)}")
        assert got.shape == (76, 338) and err <= 1e-4
        assert len(same) == len(PREDICT_STRUCTURAL) + 1
        launches = sample_inverse_cdf.launches + sample_inverse_cdf_batched.launches
        assert launches == 0, "td-predict launched the sampling kernel"
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    log(f"td-predict: phase passed in {phase_s:.1f} s; launches of the sampling kernel: 0")
    return {"launches": launches, "per_model": per_model, "cli_wall_s": cli_wall,
            "f32_card_vs_cpu_max_abs_dp": err, "phase_s": phase_s}


# td-predict as a subprocess of its CLI's main, run once per entry of the
# JSON argument ({tag: argv}); prints each run's phase times and how many
# blocks the native %.18e writer wrote
PREDICT_E18_CLI = """
import json, sys
from timed_design_tpu_torch.cli.predict import main
from timed_design_tpu_torch.io.fast_fmt import write_e18_csv
runs = {}
for tag, argv in json.loads(sys.argv[1]).items():
    calls = write_e18_csv.calls
    result = main(argv)
    runs[tag] = {"timings": result.timings, "e18_calls": write_e18_csv.calls - calls}
print("RUNS " + json.dumps(runs))
"""

# td-analyse-rotamers as a subprocess of its CLI module, printing at the end
# the card's peak memory in that process (0 when it never touched the card);
# the first argument "block" makes matplotlib unimportable there
ANALYSE_CLI = """
import runpy, sys
if sys.argv[1] == "block":
    sys.modules["matplotlib"] = None
import torch
sys.argv = ["td-analyse-rotamers", *sys.argv[2:]]
runpy.run_module("timed_design_tpu_torch.cli.analyse_rotamers", run_name="__main__")
peak = torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() else 0
print(f"card peak bytes: {peak}")
"""

# A stand-in for the licensed SCWRL4 binary with its contract: -i/-o/-s,
# an output PDB (the input's), the "Total minimal energy" line on stdout
FAKE_SCWRL = r"""#!/usr/bin/env python3
import sys

args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
with open(args["-i"]) as f:
    pdb = f.read()
seq = open(args["-s"]).read().split()[0].strip()
if "x" in seq:
    sys.stderr.write("bad residue\n")
    sys.exit(1)
with open(args["-o"], "w") as f:
    f.write(pdb)
print("A few lines of preamble")
print(f"Total minimal energy of the graph = {-17.25 - len(seq) * 0.5}")
"""

# the metric passes alone: rows x classes of a test set of a few thousand
# structures
METRIC_ROWS, METRIC_CLASSES = 200_000, 338


def results_agree(got: Path, want: Path) -> None:
    """Two results_*.txt: every line equal but the AUCs, which agree within
    1e-12 relative (one-vs-rest is NaN in both where a class is absent)."""
    g, w = (p.read_text().splitlines() for p in (got, want))
    assert len(g) == len(w), got.name
    for a, b in zip(g, w):
        if a.startswith("Metrics AUC_"):
            x, y = float(a.split(": ")[1]), float(b.split(": ")[1])
            assert a.split(": ")[0] == b.split(": ")[0], (a, b)
            assert a == b or abs(x - y) <= 1e-12 * abs(y), (a, b)  # nan: equal lines
        else:
            assert a == b, f"{got.name}: {a[:80]} != {b[:80]}"


def card_ms(fn, reps: int = 3):
    """(median ms, result) of ``reps`` calls after one warm-up, each timed
    with CUDA events; a call ends by reading its result on the host."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        value = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2], value


def cpu_ms(fn):
    """(ms, result) of one call on the host clock."""
    t0 = time.perf_counter()
    value = fn()
    return (time.perf_counter() - t0) * 1e3, value


def metric_passes() -> dict:
    """OvO and OvR ROC AUC, top-1..5 and the confusion matrices (unweighted
    and weighted) over METRIC_ROWS x METRIC_CLASSES float16-quantized
    probability rows with labels, drawn from the script's seed: each on the
    card (median of 3, CUDA events) and once on the CPU with the same torch
    functions. The card's values equal the CPU's: the counts exactly, the
    AUCs within 1e-12 relative, the weighted matrix within 1e-12."""
    import numpy as np
    import torch

    import timed_design_tpu_torch.analyse.metrics as M
    from timed_design_tpu_torch.analyse.rotamer import renormalize_float16_rows

    g = torch.Generator(device="cuda").manual_seed(SEED)
    N, C = METRIC_ROWS, METRIC_CLASSES
    y = torch.randint(0, C, (N,), device="cuda", generator=g)
    p = torch.rand((N, C), device="cuda", generator=g, dtype=torch.float64) ** 24
    p[torch.arange(N, device="cuda"), y] += 0.3 * torch.rand(N, device="cuda", generator=g,
                                                               dtype=torch.float64) * p.max(1).values
    scores = renormalize_float16_rows((p / p.sum(1, keepdims=True)).half())
    del p
    pred = scores.argmax(1)
    weights = (torch.bincount(y, minlength=C).double() / N)[y]
    fns = {
        "auc_ovo": lambda s, t, a, w: M.roc_auc_ovo_macro(t, s),
        "auc_ovr": lambda s, t, a, w: M.roc_auc_ovr_macro(t, s),
        "top_1_to_5": lambda s, t, a, w: [int(v) for v in torch.bincount(
            M.true_class_rank(t, s).clamp(max=5), minlength=6).cpu()],
        "confusion": lambda s, t, a, w: M.confusion(t, a, C, normalize=None),
        "confusion_weighted": lambda s, t, a, w: M.confusion(t, a, C, sample_weight=w),
    }
    card = (scores, y, pred, weights)
    cpu = tuple(x.cpu() for x in card)
    out = {}
    for name, fn in fns.items():
        ms, got = card_ms(lambda: fn(*card))
        host, want = cpu_ms(lambda: fn(*cpu))
        if name.startswith("auc"):
            assert np.isfinite(got) and abs(got - want) <= 1e-12 * abs(want), (name, got, want)
        elif name == "confusion_weighted":
            assert np.allclose(got, want, rtol=1e-12, atol=0), name
        else:
            assert np.array_equal(np.asarray(got), np.asarray(want)), name
        out[name] = {"card_ms": ms, "cpu_ms": host,
                     "value": got if name.startswith("auc") or name == "top_1_to_5" else None}
        log(f"analyse metric passes, {N} x {C}: {name} card {ms:.2f} ms (median of 3), cpu "
            f"{host:.0f} ms ({torch.get_num_threads()} threads); card equals cpu"
            + (f"; {got}" if name.startswith("auc") or name == "top_1_to_5" else ""))
    return out


def check_analyse() -> dict:
    """The analysis stack on the card.

    (1) td-predict --voxelize of TIMED_rotamer over the 988 frames (bf16,
    batch 512) as a subprocess of the CLI, three runs in one process: cold,
    warm, and TIMED warm; the native %.18e formatter must have written every
    block of ``_rot.csv`` (2 a run), and the file equals np.savetxt of its
    rows byte for byte; the warm frames/s of both models. (2)
    td-analyse-rotamers on those outputs (the SRB map, the structures as the
    mirror, a fake Scwrl4), on the card and with --device cpu, the two
    processes side by side: the three
    results files agree (AUCs within 1e-12 relative, every other line
    equal), scwrl_scores.csv byte-equal, the card's run used the card, the
    CPU's did not. (3) the metric passes alone at METRIC_ROWS x
    METRIC_CLASSES (``metric_passes``). (4) atom_packing_density of the
    760-residue multichain on the card against the CPU: equal counts. (5)
    run_temperature_sweep over 1ubq's rotamer rows at the 5 default
    temperatures, n 100: exactly 5 batched sampling launches, every sample's
    metrics recomputed from its sequence. (6) td-analyse-rotamers
    --plot_confusion without matplotlib exits non-zero naming it."""
    import importlib.util
    import io
    import json
    import os
    import stat
    import tempfile

    import numpy as np

    from timed_design_tpu_torch.analyse import DEFAULT_TEMPERATURES, run_temperature_sweep
    from timed_design_tpu_torch.analyse import atom_packing_density
    from timed_design_tpu_torch.io import write_prediction_rows
    from timed_design_tpu_torch.ops.sample import sample_inverse_cdf, sample_inverse_cdf_batched
    from timed_design_tpu_torch.sample import sequence_metrics
    from timed_design_tpu_torch.structure import parse_pdb_string

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix=".chip_smoke_analyse_", dir=ROOT))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    cwd = Path.cwd()
    try:
        inputs = work / "in"
        write_structures(inputs)
        # (1) td-predict, the native writer
        runs = {tag: ["--voxelize", "--path_to_dataset", str(inputs), "--path_to_model", model,
                      "--allow-random-weights", "--batch_size", "512", "--compute_dtype",
                      "bfloat16", "--device", "cuda", "--path_to_output", str(work / tag),
                      "--path_to_datasetmap", str(work / tag / "datasetmap.txt"),
                      "--is_structure_nmr"] + (["--predict_rotamers"] if "rot" in tag else [])
                for tag, model in (("rot_cold", "TIMED_rotamer"), ("rot", "TIMED_rotamer"),
                                   ("timed", "TIMED"))}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", PREDICT_E18_CLI, json.dumps(runs)],
                              cwd=work, capture_output=True, text=True, timeout=600, env=env)
        predict_wall = time.perf_counter() - t0
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        done = json.loads(proc.stdout.rsplit("RUNS ", 1)[1])
        fps = {}
        for tag, model in (("rot_cold", "TIMED_rotamer"), ("rot", "TIMED_rotamer"),
                           ("timed", "TIMED")):
            n = check_td_predict_outputs(work / tag, model, "rot" in tag, True)
            fps[tag] = n / done[tag]["timings"]["predict"]
            assert done[tag]["e18_calls"] == (-(-n // 512) if "rot" in tag else 0), (tag, done[tag])
        rot_csv = work / "rot" / "TIMED_rotamer_rot.csv"
        rows = np.loadtxt(rot_csv, delimiter=",", ndmin=2)
        again = io.BytesIO()
        np.savetxt(again, rows, delimiter=",")
        assert rot_csv.read_bytes() == again.getvalue(), "_rot.csv differs from np.savetxt's"
        log(f"analyse: td-predict CLI subprocess (bf16, batch 512, {n} frames) in "
            f"{predict_wall:.2f} s; _rot.csv written by the native formatter "
            f"({done['rot']['e18_calls']} blocks), byte-equal to np.savetxt of its rows; warm "
            f"predict phase TIMED_rotamer {fps['rot']:.0f} frames/s (cold {fps['rot_cold']:.0f}), "
            f"TIMED {fps['timed']:.0f} frames/s; {gpu_name_and_power()}")

        # (2) td-analyse-rotamers, card and CPU, with a fake Scwrl4
        exe = work / "Scwrl4"
        exe.write_text(FAKE_SCWRL)
        exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
        argv = ["--path_to_pred_matrix", str(rot_csv), "--path_to_datasetmap",
                str(work / "rot" / "TIMED_rotamer.txt"), "--path_to_pdb", str(inputs),
                "--path_to_scwrl", str(exe)]
        analysed = {dev: work / f"analyse_{dev}" for dev in ("cuda", "cpu")}

        def analyse_run(dev):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", ANALYSE_CLI, "run", *argv, "--path_to_output",
                 str(analysed[dev]), "--device", dev],
                cwd=work, capture_output=True, text=True, timeout=600, env=env)
            return proc, time.perf_counter() - t0

        # the two runs are host-bound and independent: side by side
        with ThreadPoolExecutor(max_workers=2) as pool:
            runs_by_dev = dict(zip(analysed, pool.map(analyse_run, analysed)))
        walls = {dev: wall for dev, (_, wall) in runs_by_dev.items()}
        peaks, summary = {}, {}
        for dev, (proc, _) in runs_by_dev.items():
            assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
            assert "[scwrl-pred] top-1" in proc.stdout and "[scwrl-real] top-1" in proc.stdout, (
                proc.stdout[-3000:])
            peaks[dev] = int(proc.stdout.rsplit("card peak bytes: ", 1)[1].split()[0])
            summary[dev] = "; ".join(l for l in proc.stdout.splitlines() if l.startswith("["))
        assert peaks["cuda"] > 0 and peaks["cpu"] == 0, peaks
        for name in ("results_wt.txt", "results_scwrl_pred.txt", "results_scwrl_real.txt"):
            results_agree(analysed["cuda"] / name, analysed["cpu"] / name)
        assert ((analysed["cuda"] / "scwrl_scores.csv").read_bytes()
                == (analysed["cpu"] / "scwrl_scores.csv").read_bytes())
        n_scored = len((analysed["cuda"] / "scwrl_scores.csv").read_text().splitlines()) - 1
        log(f"analyse: td-analyse-rotamers with a fake Scwrl4, {n_scored} chains packed, the "
            f"two runs side by side: card {walls['cuda']:.2f} s (peak "
            f"{peaks['cuda'] / 2**20:.1f} MiB on the card), cpu {walls['cpu']:.2f} s; "
            f"results_wt/scwrl_pred/scwrl_real agree, scwrl_scores.csv "
            f"byte-equal; card: {summary['cuda']}")

        # (3) the metric passes at a test set's size
        passes = metric_passes()

        # (4) packing density of the multichain
        text = gzip.decompress(UBQ.read_bytes()).decode()
        xyz = parse_pdb_string(multichain_pdb(text), name="mult")[0].coords
        pack_ms, dens_card = card_ms(lambda: atom_packing_density(xyz, device="cuda"))
        pack_cpu_ms, dens_cpu = cpu_ms(lambda: atom_packing_density(xyz, device="cpu"))
        assert np.array_equal(dens_card, dens_cpu) and dens_card.min() >= 0
        log(f"analyse: atom_packing_density of the multichain ({len(xyz)} atoms): card "
            f"{pack_ms:.2f} ms, cpu {pack_cpu_ms:.0f} ms, counts equal (mean "
            f"{dens_card.mean():.2f})")

        # (5) the temperature sweep: one batched launch per temperature
        names = [l.split(",") for l in (work / "rot" / "datasetmap.txt").read_text().splitlines()]
        ubq_rows = [i for i, e in enumerate(names) if e[0] == "1ubq"]
        sweep_dir = work / "sweep"
        sweep_dir.mkdir()
        with open(sweep_dir / "ubq_rot.csv", "wb") as f:
            write_prediction_rows(f, rows[ubq_rows], float16=False)
        (sweep_dir / "ubq.txt").write_text(
            f"ignore_uncommon False\ninclude_pdbs\n##########\n1ubqA {len(ubq_rows)}\n")
        os.chdir(sweep_dir)
        sample_inverse_cdf.launches = sample_inverse_cdf_batched.launches = 0
        t0 = time.perf_counter()
        paths = run_temperature_sweep(sweep_dir / "ubq_rot.csv", sweep_dir / "ubq.txt",
                                      sample_n=100, device="cuda")
        sweep_wall = time.perf_counter() - t0
        launches = sample_inverse_cdf_batched.launches
        assert sample_inverse_cdf.launches == 0 and launches == len(DEFAULT_TEMPERATURES) == 5
        worst = 0.0
        for temp, files in paths.items():
            assert len(files) == 3
            samples = json.loads((sweep_dir / files[0]).read_text())["1ubqA"]
            assert len(samples) == 100
            for seq, *m in samples:
                assert len(seq) == 76
                want = sequence_metrics(seq)
                worst = max(worst, float(np.max(np.abs(np.subtract(m, want))
                                                / np.maximum(np.abs(want), 1.0))))
        assert worst <= 1e-4, f"sampled metrics differ from the sequences' by {worst:.3g}"
        log(f"analyse: run_temperature_sweep 1ubq, T {DEFAULT_TEMPERATURES}, n 100: "
            f"{sweep_wall:.2f} s, {launches} batched launches, metrics agree with the "
            f"sequences to {worst:.2g}")
        os.chdir(cwd)

        # (6) --plot_confusion where matplotlib is missing
        present = importlib.util.find_spec("matplotlib") is not None
        proc = subprocess.run(
            [sys.executable, "-c", ANALYSE_CLI, "block" if present else "run", *argv,
             "--path_to_output", str(work / "plots"), "--device", "cuda", "--plot_confusion"],
            cwd=work, capture_output=True, text=True, timeout=300, env=env)
        assert proc.returncode != 0 and "matplotlib" in proc.stderr, proc.stderr[-2000:]
        log(f"analyse: --plot_confusion without matplotlib ({'blocked' if present else 'absent'} "
            f"here) exits {proc.returncode}: {proc.stderr.strip().splitlines()[-1]}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    log(f"analyse: phase passed in {phase_s:.1f} s; launches of the sampling kernel: {launches}")
    return {"launches": launches, "predict_frames_per_s": fps, "predict_cli_wall_s": predict_wall,
            "analyse_wall_s": walls, "metric_passes": passes,
            "packing_density_ms": {"card": pack_ms, "cpu": pack_cpu_ms},
            "sweep_wall_s": sweep_wall, "phase_s": phase_s}


TRAIN_FAMILIES = ("TIMED", "ProDCoNN", "DenseNet", "DenseCPD")


def one_train_step(module, device, x, y, threads: int | None = None, mesh=None) -> dict:
    """One make_train_step of ``module`` on ``device`` (on the CPU with
    ``threads`` threads; over ``mesh``, this rank's rows of the batch): the
    loss, and the gradients and floating-point buffers (BatchNorm running
    statistics) after it, on the host in float64."""
    import torch

    from timed_design_tpu_torch.parallel import shard_batch
    from timed_design_tpu_torch.train import init_train_state, make_train_step

    n = torch.get_num_threads()
    torch.set_num_threads(threads or n)
    on_mesh = {} if mesh is None else {"mesh": mesh}
    if mesh is not None:
        x, y = shard_batch(x, mesh), shard_batch(y, mesh)
    try:
        state = init_train_state(module, device=device, **on_mesh)
        t0 = time.perf_counter()
        loss = float(make_train_step(module, state.optimizer, **on_mesh)(
            x.to(device), y.to(device))["loss"])
        secs = time.perf_counter() - t0
    finally:
        torch.set_num_threads(n)
    return {"loss": loss, "seconds": secs,
            "grads": {k: p.grad.cpu().double() for k, p in module.named_parameters()},
            "buffers": {k: b.cpu().double() for k, b in module.named_buffers()
                        if b.is_floating_point()}}


# A leaf whose float64 gradient is below this share of the largest |g| is
# zero to rounding (a bias that a BatchNorm cancels); its error is taken
# relative to the largest |g| instead of its own.
ZERO_LEAF = 1e-9


def step_errors(a: dict, ref: dict) -> dict:
    """``a`` against the float64 step ``ref``: the loss (relative), per leaf
    the largest gradient error relative to the leaf's largest float64 |g|
    (the model's largest for a leaf that is zero to rounding), and the
    largest error of a running statistic relative to max(1, |value|)."""
    top = max(float(g.abs().max()) for g in ref["grads"].values())
    scale = {k: float(g.abs().max()) for k, g in ref["grads"].items()}
    grad = {k: float((a["grads"][k] - g).abs().max()) / (s if s > ZERO_LEAF * top else top)
            for (k, g), s in zip(ref["grads"].items(), scale.values())}
    bn = max((float((a["buffers"][k] - v).abs().max()) / max(1.0, float(v.abs().max()))
              for k, v in ref["buffers"].items()), default=0.0)
    return {"loss": abs(a["loss"] - ref["loss"]) / abs(ref["loss"]), "grad": grad, "bn": bn}


# A float32 train step on the card and on the CPU (TF32 off), both held to a
# float64 step on the CPU from the same weights on the same 32 frames: the
# loss to 1e-5 relative, each leaf's gradient to 1e-4 of its largest |g|,
# the running statistics to 1e-5, or, where the float32 CPU itself lies
# further from float64 (its sums over 32 x 21^3 positions, in either of two
# thread counts), to 4x that distance. The gradient of a bias ahead of a
# BatchNorm sums many terms that cancel: in float32 it lies 1e-2 of itself
# from float64 on the CPU too.
STEP_TOL = {"loss": 1e-5, "grad": 1e-4, "bn": 1e-5}


class PoolChoices:
    """Max pooling (ProDCoNN's) that records each window's argmax in one
    step and replays them in the next: the float64 and CPU steps then route
    the gradient where the card did. Two values of a window within float32
    rounding of each other make the choice differ between devices, and one
    such window moves a leaf's gradient by 1e-3 of itself; what the step
    check compares is the rounding of the sums. A replay counts the windows
    whose own argmax differs from the recorded one."""

    def __init__(self):
        self.saved: list = []
        self.replaying, self.next, self.flips, self.windows = False, 0, 0, 0

    def __enter__(self):
        import torch.nn.functional as F

        self.real = F.max_pool3d
        F.max_pool3d = self.pool
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F

        F.max_pool3d = self.real

    def replay(self) -> None:
        self.replaying, self.next, self.flips, self.windows = True, 0, 0, 0

    def pool(self, x, kernel_size, stride=None):
        out, own = self.real(x, kernel_size, stride, return_indices=True)
        if not self.replaying:
            self.saved.append(own.cpu())
            return out
        chosen = self.saved[self.next].to(x.device)
        self.next += 1
        self.flips += int((own != chosen).sum())
        self.windows += own.numel()
        return x.flatten(2).gather(2, chosen.flatten(2)).view_as(out)


def train_step_parity(name: str, x, y) -> dict:
    """One train step of registry ``name`` (dropout off) on the card, on a
    CPU copy (all its threads and half of them) and on a float64 CPU copy,
    all from the same initial weights and with the card's max-pool choices
    (PoolChoices); the float32 steps against float64, and float64 against
    itself from weights nudged by 2^-24 (the gradients' conditioning)."""
    import copy

    import torch

    from timed_design_tpu_torch.models import MODEL_REGISTRY

    torch.manual_seed(SEED)
    module = MODEL_REGISTRY[name].build(**({"dropout_rate": 0.0} if name in ("TIMED", "ProDCoNN")
                                           else {}))
    witness = copy.deepcopy(module).double()
    witness.compute_dtype = torch.float64
    # the same float64 step from weights moved by float32's rounding (2^-24
    # relative): how far the gradients move for reasons no arithmetic fixes
    nudged = copy.deepcopy(witness)
    noise = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for p in nudged.parameters():
            p.mul_(1 + 2.0 ** -24 * torch.randn(p.shape, generator=noise, dtype=p.dtype))
    cpu_copy = copy.deepcopy(module)
    with PoolChoices() as choices:
        card = one_train_step(module, "cuda", x, y)
        choices.replay()
        f64 = one_train_step(witness, "cpu", x.cpu().double(), y.double())
        flips = (choices.flips, choices.windows)
        choices.replay()
        moved = step_errors(one_train_step(nudged, "cpu", x.cpu().double(), y.double()), f64)
        cpus = []
        for t in (None, max(1, torch.get_num_threads() // 2)):
            choices.replay()
            cpus.append(one_train_step(copy.deepcopy(cpu_copy), "cpu", x, y, threads=t))
    err, cpu = step_errors(card, f64), [step_errors(c, f64) for c in cpus]
    tol = {k: max(STEP_TOL[k], 4 * max(c[k] for c in cpu)) for k in ("loss", "bn")}
    leaf_tol = {k: max(STEP_TOL["grad"], 4 * max(c["grad"][k] for c in cpu)) for k in err["grad"]}
    worst = max(err["grad"], key=lambda k: err["grad"][k] / leaf_tol[k])
    largest = max(err["grad"], key=err["grad"].get)
    out = {"loss": err["loss"], "loss_cpu": [c["loss"] for c in cpu], "loss_tol": tol["loss"],
           "bn": err["bn"], "bn_cpu": [c["bn"] for c in cpu], "bn_tol": tol["bn"],
           "grad_leaves": len(err["grad"]), "grad_nearest_limit": {
               "leaf": worst, "card": err["grad"][worst], "tol": leaf_tol[worst],
               "cpu": [c["grad"][worst] for c in cpu]},
           "grad_largest": {"leaf": largest, "card": err["grad"][largest],
                            "cpu": [c["grad"][largest] for c in cpu]},
           "grad_cpu_largest": max(cpu[0]["grad"].values()),
           "grad_f64_nudged_largest": max(moved["grad"].values()),
           "pool_windows_card_unlike_f64": flips, "f64_step_s": f64["seconds"],
           "cpu_step_s": cpus[0]["seconds"]}
    log(f"train {name} float32 step, 32 frames, against float64 on the CPU: loss rel card "
        f"{err['loss']:.2e}, CPU {cpu[0]['loss']:.2e} and {cpu[1]['loss']:.2e} (all and half its "
        f"threads); gradients per leaf ({len(err['grad'])} leaves), |dg| over the leaf's max |g|: "
        f"nearest its limit {worst} card {err['grad'][worst]:.2e} (limit {leaf_tol[worst]:.2e}; "
        f"CPU {cpu[0]['grad'][worst]:.2e}, {cpu[1]['grad'][worst]:.2e}), largest {largest} card "
        f"{err['grad'][largest]:.2e} (CPU {cpu[0]['grad'][largest]:.2e}, "
        f"{cpu[1]['grad'][largest]:.2e}), CPU's largest {out['grad_cpu_largest']:.2e}, float64's "
        f"largest from weights nudged by 2^-24 {out['grad_f64_nudged_largest']:.2e}; max-pool "
        f"windows where the card chose otherwise than float64 {flips[0]} of {flips[1]}; running "
        f"statistics card {err['bn']:.2e}, CPU {cpu[0]['bn']:.2e}; steps: float64 "
        f"{f64['seconds']:.2f} s, float32 CPU {cpus[0]['seconds']:.2f} s, card "
        f"{card['seconds'] * 1e3:.1f} ms (first)")
    for k in ("loss", "bn"):
        assert err[k] <= tol[k], f"{name}: {k} {err[k]:.3g} from float64 (tolerance {tol[k]:.3g})"
    bad = sorted(k for k, v in err["grad"].items() if v > leaf_tol[k])
    assert not bad, f"{name}: the gradients of {bad} lie outside their tolerance"
    return out


def fit_one_epoch(source, dtype, mesh=None) -> int:
    """Registry TIMED in ``dtype`` (its seed's weights) trained by ``fit``
    for one epoch over ``source`` (over ``mesh`` when given): it must step,
    and its evaluation-mode loss over ``source`` after it must be finite.
    Returns the steps."""
    import torch

    from timed_design_tpu_torch.models import MODEL_REGISTRY
    from timed_design_tpu_torch.train import evaluate, fit

    torch.manual_seed(SEED)
    module = MODEL_REGISTRY["TIMED"].build(compute_dtype=dtype)
    on_mesh = {} if mesh is None else {"mesh": mesh}
    state = fit(module, source, n_classes=20, log_every=10_000, device="cuda", **on_mesh)
    loss = evaluate(module, source, **on_mesh)["loss"]
    assert state.step > 0 and math.isfinite(loss), f"fit: {state.step} steps, loss {loss}"
    return state.step


def check_train() -> dict:
    """Training on the card, the port's train/ fed by FrameBatchSource:
    the frame set of the td-predict phase (988 frames), shuffled, batch 256.
    (1) One float32 train step of each of TIMED, ProDCoNN, DenseNet and
    DenseCPD at registry widths on the first 32 frames of a batch, dropout
    off, on the card and on CPU copies, held to a float64 step: the loss,
    each leaf's gradient and the BatchNorm running statistics
    (train_step_parity, STEP_TOL). (2) Registry TIMED trained by ``fit`` for
    one epoch in bfloat16 and float32, and in bfloat16 with nn.BatchNorm3d's
    own forward (fit_one_epoch). (3) Registry TIMED
    (bn_momentum 0.9, lr 3e-3, bfloat16) overfit on 1ubq's 76 frames until
    the train top-1 and the evaluation-mode top-1 are at least 0.9, 600
    steps at most; its checkpoint, saved by save_checkpoint, through
    td-predict --voxelize on the card: argmax recovery of at least 0.9
    against dataset.fasta. Training reaches no TPU kernel: the sampling
    kernel's counts stay 0."""
    import tempfile

    import numpy as np
    import torch

    from torch import nn

    import timed_design_tpu_torch.models.layers as layers
    from timed_design_tpu_torch.cli.predict import main as predict_main
    from timed_design_tpu_torch.models import MODEL_REGISTRY
    from timed_design_tpu_torch.ops.sample import sample_inverse_cdf, sample_inverse_cdf_batched
    from timed_design_tpu_torch.train import (
        evaluate,
        init_train_state,
        make_eval_step,
        make_train_step,
        save_checkpoint,
    )
    from timed_design_tpu_torch.voxel import FrameBatchSource, create_flat_dataset_map, make_frame_set

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix=".chip_smoke_train_", dir=ROOT))
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    sample_inverse_cdf.launches = sample_inverse_cdf_batched.launches = 0
    try:
        inputs = work / "in"
        write_structures(inputs)
        fs = make_frame_set(sorted(inputs.glob("*.pdb*")), voxelise_all_states=True)
        source = FrameBatchSource(fs, create_flat_dataset_map(fs), 256, device=dev, shuffle=True,
                                  shuffle_seed=0)
        assert len(source.entries) == 988 and source.n_batches == 4

        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        X, y, _ = next(iter(source))
        x32, y32 = X[:32], torch.from_numpy(y[:32])
        parity = {name: train_step_parity(name, x32, y32) for name in TRAIN_FAMILIES}
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

        fit_steps = {str(dt).split(".")[-1]: fit_one_epoch(source, dt)
                     for dt in (torch.bfloat16, torch.float32)}
        # the bfloat16 run again with nn.BatchNorm3d's own forward (its
        # running variance the unbiased one)
        forward = layers.BatchNorm3d.forward
        layers.BatchNorm3d.forward = nn.BatchNorm3d.forward
        try:
            fit_steps["bfloat16_kernel_statistics"] = fit_one_epoch(source, torch.bfloat16)
        finally:
            layers.BatchNorm3d.forward = forward

        fs1 = make_frame_set([inputs / "1ubq.pdb1.gz"])
        dmap1 = create_flat_dataset_map(fs1)
        ubq = FrameBatchSource(fs1, dmap1, 76, device=dev, shuffle=True, shuffle_seed=0)
        ubq_eval = FrameBatchSource(fs1, dmap1, 76, device=dev)
        torch.manual_seed(SEED)
        module = MODEL_REGISTRY["TIMED"].build(compute_dtype=torch.bfloat16, bn_momentum=0.9)
        state = init_train_state(module, 3e-3, device=dev)
        step = make_train_step(module, state.optimizer)
        eval_step = make_eval_step(module)
        generator = torch.Generator(device=dev).manual_seed(SEED)
        top1 = eval_top1 = 0.0
        t0 = time.perf_counter()
        while min(top1, eval_top1) < 0.9:
            assert state.step < 600, (f"the overfit reached 600 steps at train top-1 {top1:.3f}, "
                                      f"evaluation-mode top-1 {eval_top1:.3f}")
            for Xb, yb, n in ubq:
                metrics = step(Xb[:n], torch.from_numpy(yb[:n]).to(dev), generator)
                state.step += 1
            if state.step % 10 == 0:
                top1 = float(metrics["top1"])
                eval_top1 = evaluate(module, ubq_eval, step_fn=eval_step)["top1"]
                if state.step % 50 == 0:
                    log(f"train overfit step {state.step}: loss {float(metrics['loss']):.4f}, "
                        f"train top-1 {top1:.3f}, evaluation-mode top-1 {eval_top1:.3f}")
        overfit_s = time.perf_counter() - t0
        ckpt = work / "timed_overfit.npz"
        save_checkpoint(state, ckpt)
        out = work / "predict"
        predict_main(["--voxelize", "--path_to_dataset", str(inputs / "1ubq.pdb1.gz"),
                      "--path_to_model", f"TIMED@{ckpt}", "--compute_dtype", "bfloat16",
                      "--device", "cuda", "--path_to_output", str(out),
                      "--path_to_datasetmap", str(out / "datasetmap.txt")])
        check_td_predict_outputs(out, "TIMED", rotamer=False, nmr=False)
        designed = (out / "TIMED.fasta").read_text().splitlines()[1::2]
        native = (out / "dataset.fasta").read_text().splitlines()[1::2]
        recovery = float(np.mean([a == b for d, r in zip(designed, native) for a, b in zip(d, r)]))
        log(f"train overfit: TIMED (registry widths, bf16, bn_momentum 0.9, lr 3e-3) on 1ubq's 76 "
            f"frames: train top-1 {top1:.3f}, evaluation-mode top-1 {eval_top1:.3f} after "
            f"{state.step} steps in {overfit_s:.1f} s, loss "
            f"{float(metrics['loss']):.4f}; td-predict --voxelize from its checkpoint: recovery "
            f"{recovery:.3f} against dataset.fasta")
        assert recovery >= 0.9, f"recovery {recovery:.3f} from the overfit checkpoint"
        launches = sample_inverse_cdf.launches + sample_inverse_cdf_batched.launches
        assert launches == 0, "training launched the sampling kernel"
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    log(f"train: phase passed in {phase_s:.1f} s; launches of the sampling kernel: 0")
    return {"launches": launches, "parity": parity, "fit_steps": fit_steps, "overfit": {
                "steps": state.step, "top1": top1, "seconds": overfit_s, "recovery": recovery},
            "phase_s": phase_s}


# Dense int8 peak of an H100 SXM (NVIDIA's data sheet, no sparsity)
INT8_OPS_PER_S = 1979e12
# (Cin, Cout, k, padding): registry TIMED's convolutions at 21^3, the four
# blocks and the 20- and 338-class heads; PER_FORWARD of them run per forward
TIMED_CONVS = [(5, 16, 3, 1), (16, 32, 3, 1), (32, 64, 3, 1), (64, 128, 3, 1), (128, 20, 1, 0),
               (128, 338, 1, 0)]
PER_FORWARD = 5
QUANT_MODES = ("w8", "int8-fake", "int8")
# A quantized float32 forward on the card against the same mode on the CPU,
# on log-probabilities: the card must lie within this share of how far the
# mode moves the output from the unquantized run on the card. A card path
# that ran unquantized lies the whole move away. The two sum the float32
# convolutions in another order, so an activation at a rounding tie can take
# the next int8 code on one of them; one code a step apart moves the output
# far less than rounding every code does.
QUANT_CPU_SHARE = 0.1
# ... and each mode must move the output by more than this many times the
# card's float32 distance from the CPU unquantized (the sums' order alone)
QUANT_MOVE_OVER_NOISE = 10
# the registry models whose every convolution the kernel is held to
ZOO = ("TIMED", "TIMED_rotamer", "TIMED_Deep", "ProDCoNN", "DenseNet", "DenseCPD")


def conv_bound(B: int, D: int, cin: int, cout: int, k: int, pad: int,
               out_bytes: int = 4) -> tuple[float, str]:
    """Least time (ms) of an int8 convolution of B (D^3, cin) frames into
    cout channels: its int8 input and weights read once and its output
    written once (``out_bytes`` a value: 4 for the int32 sums or float32, 2
    for bfloat16; a scale and a bias of cout values are too few to count)
    over the memory rate, or 2 M N K operations over the int8 peak,
    whichever is longer."""
    m = B * (D + 2 * pad - k + 1) ** 3
    kk = k ** 3 * cin
    t_bytes = (B * D ** 3 * cin + cout * kk + out_bytes * m * cout) / HBM_BYTES_PER_S
    t_ops = 2 * m * cout * kk / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ubq_frames(n: int):
    """1ubq's first ``n`` frames, voxelized on the card."""
    from timed_design_tpu_torch.structure import load_pdb
    from timed_design_tpu_torch.voxel import Codec, structure_to_frame_atoms, voxelize_frame_atoms

    codec = Codec.CNOCACB()
    fa = structure_to_frame_atoms(load_pdb(UBQ), codec)
    return voxelize_frame_atoms(fa, codec, device="cuda")[:n]


# the fused epilogues each recorded call is also run in: (dtype, with a bias)
FUSED_ROUTES = [(dt, b) for dt in ("float32", "bfloat16") for b in (False, True)]


def fused_variants(scale, bias):
    """(scale, bias, out_dtype) of each of FUSED_ROUTES for a call of the
    fused route recorded with ``scale`` and ``bias``: its own bias cast to
    the dtype, or a seeded one where it had none."""
    import torch

    out = []
    for name, with_bias in FUSED_ROUTES:
        dt = getattr(torch, name)
        b = None
        if with_bias:
            b = bias.to(dt) if bias is not None else torch.linspace(
                -1, 1, scale.numel(), device=scale.device).to(dt)
        out.append((scale, b, dt))
    return out


def replay_calls(calls, on_cpu: bool) -> tuple[dict, float]:
    """Each recorded call of conv3d_int8 (xq, wq, padding, scale, bias,
    out_dtype, output) against conv3d_int8_plain on the same codes, on a CPU
    copy or on the card (float64 is exact on both), torch.equal: the
    recorded output; the int32 route on the same codes; and the fused route
    in float32 and bfloat16, with and without a bias. Returns {(Cin, Cout, k,
    pad, D): all equal} and the largest difference."""
    import torch

    from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8, conv3d_int8_plain

    checked, max_err = {}, 0.0

    def same(got, want) -> bool:
        nonlocal max_err
        got = got.cpu() if on_cpu else got
        if torch.equal(got, want):
            return True
        max_err = max(max_err, float((got.double() - want.double()).abs().max()))
        return False

    for xq, wq, pad, scale, bias, dt, out in calls:
        key = (xq.shape[-1], wq.shape[0], wq.shape[1], pad, xq.shape[1])
        acc = conv3d_int8_plain(*((xq.cpu(), wq.cpu()) if on_cpu else (xq, wq)), pad)
        routes = [(scale, bias, dt, out), (None, None, None, None)]
        if scale is not None:
            routes += [(*v, None) for v in fused_variants(scale, bias)]
        equal = True
        for s, b, d, got in routes:  # one output on the card at a time
            if got is None:
                got = conv3d_int8(xq, wq, pad, s, b, d)
            if s is None:
                want = acc
            else:
                if on_cpu:
                    s, b = s.cpu(), None if b is None else b.cpu()
                want = acc.to(torch.float32).mul_(s).to(d)
                want = want if b is None else want + b
            equal = same(got, want) and equal
            del got, want
        checked[key] = checked.get(key, True) and equal
        del acc
    return checked, max_err


def check_conv_kernel() -> dict:
    """conv3d_int8 against conv3d_int8_plain (torch.equal), both routes: the
    int32 sums, and the fused rescale, cast and bias in float32 and
    bfloat16, with and without a bias (replay_calls):
    (1) at every convolution of the registry models in ZOO, on the codes
        those models' int8 forwards give on 4 frames of 1ubq (2 for
        DenseCPD): every call of the kernel is recorded and replayed on a
        CPU copy;
    (2) at the main path's batch of 512: registry TIMED_rotamer's int8
        forward of 1ubq's frames tiled to 512, each call replayed on the card;
    (3) at each of registry TIMED's convolutions at batch 512 on random
        codes, held to the plain version on the card, then timed: the fused
        kernel's device time in bfloat16 with a bias (a CUDA graph of 5
        calls) and the int32 route alone, each against its bound (2 and 4
        bytes an output value), the plain
        version's time (one call, after one warm-up), the library call's
        (one float64 F.conv3d of the codes, the same integer sums, a CUDA
        graph of 1 call) and, as context only, cuDNN's bfloat16 F.conv3d of
        the same shape (not the same function)."""
    import torch
    import torch.nn.functional as F

    import timed_design_tpu_torch.models.quantize as quantize
    from timed_design_tpu_torch.models import MODEL_REGISTRY, quantized_convs
    from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8, conv3d_int8_plain

    calls = []

    def record(xq, wq, padding=0, scale=None, bias=None, out_dtype=None):
        out = conv3d_int8(xq, wq, padding, scale, bias, out_dtype)
        calls.append((xq, wq, padding, scale, bias, out_dtype, out))
        return out

    def forward(name: str, x) -> None:
        torch.manual_seed(SEED)
        model = MODEL_REGISTRY[name].build().to("cuda").eval()
        with torch.inference_mode(), quantized_convs("int8"):
            model(x)

    checked, max_err = {}, 0.0
    quantize.conv3d_int8 = record
    try:
        for name in ZOO:
            forward(name, ubq_frames(2 if name == "DenseCPD" else 4))
            got, err = replay_calls(calls, on_cpu=True)
            calls.clear()
            max_err = max(max_err, err)
            checked.update({k: checked.get(k, True) and v for k, v in got.items()})
        forward("TIMED_rotamer", torch.cat([ubq_frames(76)] * 7)[:512])
        at_batch, err = replay_calls(calls, on_cpu=False)
        calls.clear()
        max_err = max(max_err, err)
    finally:
        quantize.conv3d_int8 = conv3d_int8
        calls.clear()
    routes = "int32 and fused (" + ", ".join(f"{d}{' + bias' if b else ''}"
                                            for d, b in FUSED_ROUTES) + ")"
    log(f"conv3d_int8: {len(checked)} convolution shapes (Cin, Cout, k, pad, D) of {', '.join(ZOO)} "
        f"on 1ubq's int8 codes, {routes} equal to the plain version on the CPU: "
        f"{sum(checked.values())} of {len(checked)}; {sorted(checked)}")
    log(f"conv3d_int8: TIMED_rotamer's int8 forward at batch 512 (1ubq's frames tiled), "
        f"{len(at_batch)} calls, {routes} equal to the plain version on the card: "
        f"{sum(at_batch.values())} of {len(at_batch)}")
    assert all(checked.values()), f"kernel differs at {[k for k, v in checked.items() if not v]}"
    assert len(at_batch) == PER_FORWARD and all(at_batch.values()), f"batch 512: {at_batch}"

    shapes = []
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for cin, cout, k, pad in TIMED_CONVS:
        x = torch.randint(-127, 128, (512, 21, 21, 21, cin), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (cout, k, k, k, cin), generator=gen, device="cuda",
                          dtype=torch.int8)
        # scales of the size quantize.py makes (s_x s_w), a bias in bfloat16
        scale = torch.rand(cout, generator=gen, device="cuda") * 1e-4 + 1e-5
        bias = torch.randn(cout, generator=gen, device="cuda").to(torch.bfloat16)
        fused = conv3d_int8(x, w, pad, scale, bias, torch.bfloat16)
        equal, err = replay_calls([(x, w, pad, scale, bias, torch.bfloat16, fused)], on_cpu=False)
        max_err = max(max_err, err)
        del fused
        assert all(equal.values()), f"kernel differs from plain at batch 512: {cin}->{cout} k={k}"
        ms = graph_ms(lambda: conv3d_int8(x, w, pad, scale, bias, torch.bfloat16), reps=5)
        int32_ms = graph_ms(lambda: conv3d_int8(x, w, pad), reps=5)
        xb = x.permute(0, 4, 1, 2, 3).to(torch.bfloat16)
        wb = w.permute(0, 4, 1, 2, 3).to(torch.bfloat16)
        cudnn_ms = graph_ms(lambda: F.conv3d(xb, wb, padding=pad), reps=5)
        del xb, wb
        plain_ms = time_ms(lambda: conv3d_int8_plain(x, w, pad, scale, bias, torch.bfloat16),
                           reps=1, warmup=1)
        xd = x.permute(0, 4, 1, 2, 3).to(torch.float64)
        wd = w.permute(0, 4, 1, 2, 3).to(torch.float64)
        library_ms = graph_ms(lambda: F.conv3d(xd, wd, padding=pad), reps=1)
        del xd, wd
        bound_ms, bound_by = conv_bound(512, 21, cin, cout, k, pad, 2)
        int32_bound_ms, int32_bound_by = conv_bound(512, 21, cin, cout, k, pad, 4)
        shapes.append({"cin": cin, "cout": cout, "k": k, "pad": pad, "batch": 512, "ms": ms,
                       "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms,
                       "int32_ms": int32_ms,
                       "int32_bound_ms": int32_bound_ms, "int32_bound_by": int32_bound_by,
                       "int32_bound_share": int32_bound_ms / int32_ms,
                       "cudnn_bf16_ms": cudnn_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                       "equal_to_plain": True})
        log(f"conv3d_int8 {cin}->{cout} k={k} pad={pad}, batch 512 at 21^3: both routes equal to "
            f"the plain version on the card; fused bf16 + bias {ms:.3f} ms (a graph of 5), bound "
            f"{bound_ms:.3f} ms ({bound_by}), share {bound_ms / ms:.3f}; int32 route "
            f"{int32_ms:.3f} ms, bound {int32_bound_ms:.3f} ms ({int32_bound_by}), share "
            f"{int32_bound_ms / int32_ms:.3f}; library (float64 F.conv3d of the codes) "
            f"{library_ms:.3f} ms; plain {plain_ms:.1f} ms; cuDNN bf16 conv3d (context) "
            f"{cudnn_ms:.3f} ms; {gpu_name_and_power()}")
        del x, w
        torch.cuda.empty_cache()
    five = sum(s["ms"] for s in shapes[:PER_FORWARD])
    log(f"conv3d_int8: TIMED's five fused launches per forward at batch 512 {five:.3f} ms; cuDNN "
        f"bf16 (context) {sum(s['cudnn_bf16_ms'] for s in shapes[:PER_FORWARD]):.3f} ms; bound "
        f"{sum(s['bound_ms'] for s in shapes[:PER_FORWARD]):.3f} ms")
    return {"shapes_checked": len(checked), "batch_512_calls_checked": len(at_batch),
            "max_abs_err": max_err, "per_shape": shapes}


def td_predict_argv(model: str, inputs: Path, out: Path, dtype: str, quantize: str | None):
    argv = ["--voxelize", "--path_to_dataset", str(inputs), "--path_to_model", model,
            "--allow-random-weights", "--batch_size", "512", "--compute_dtype", dtype,
            "--device", "cuda", "--path_to_output", str(out), "--path_to_datasetmap",
            str(out / "datasetmap.txt"), "--is_structure_nmr"]
    argv += ["--predict_rotamers"] if model.endswith("rotamer") else []
    return argv + (["--quantize", quantize] if quantize else [])


# td-predict as a subprocess of its CLI module, printing the int8 kernel's
# launches in that process at the end
PREDICT_CLI = """
import runpy, sys
from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8
sys.argv = ["td-predict", *sys.argv[1:]]
runpy.run_module("timed_design_tpu_torch.cli.predict", run_name="__main__")
print(f"conv3d_int8 launches: {conv3d_int8.launches}")
"""


def design_modes(dtype: str, device: str, batch: int, model=None) -> dict:
    """1ubq's probabilities from DesignSession(quantize=m) of registry
    TIMED_rotamer (random weights from its seed) for m in None and
    QUANT_MODES; ``model``: that module instead."""
    from timed_design_tpu_torch.engine import DesignSession

    src = model if model is not None else "TIMED_rotamer"
    kw = {"codec": "CNOCACB"} if model is not None else {"allow_random_weights": True}
    return {m: DesignSession(src, compute_dtype=dtype, batch_size=batch, device=device,
                             quantize=m, **kw).design(UBQ)[0] for m in (None, *QUANT_MODES)}


def check_quantize() -> dict:
    """Quantized inference on the card (models/quantize.py, the int8 kernel
    and BatchNorm folding):
    (1) check_conv_kernel;
    (2) /design 1ubq through DesignSession(quantize=m) of registry
        TIMED_rotamer, float32 (TF32 off) and bfloat16, each mode against
        the unquantized run (argmax agreement >= 0.95, the JAX package's
        pin) and moving it (max |dlog p| > 0); in float32 at batch 80, each
        mode on the card against the CPU within QUANT_CPU_SHARE of its move,
        and the move over QUANT_MOVE_OVER_NOISE x the unquantized distance;
    (3) td-predict --voxelize --quantize int8 as a CLI subprocess over the
        988 frames, TIMED and TIMED_rotamer in bfloat16: the artifact set,
        and PER_FORWARD launches per batch per model;
    (4) warm td-predict frames/s of registry TIMED in bfloat16 in-process,
        unquantized and in each mode; each mode's probabilities against the
        unquantized ones (argmax agreement >= 0.95, and moved);
    (5) td-serve --quantize int8: one /design with 100 samples launches the
        sampling kernel once and the int8 kernel PER_FORWARD times;
    (6) timed_inference_apply against registry TIMED's forward at batch 512
        (BatchNorm moved off the identity from the seed): float32 within
        1e-4, bfloat16 argmax agreement, and ms per batch of each."""
    import copy
    import os
    import tempfile

    import numpy as np
    import torch

    from timed_design_tpu_torch.cli.predict import main as predict_main
    from timed_design_tpu_torch.cli.serve import build_designers, build_parser, make_server
    from timed_design_tpu_torch.models import MODEL_REGISTRY, fold_timed_bn, timed_inference_apply
    from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8
    from timed_design_tpu_torch.ops.sample import sample_inverse_cdf, sample_inverse_cdf_batched

    t_phase = time.perf_counter()
    out = {"kernel": check_conv_kernel()}

    # (2) each mode on the card, and the card against the CPU in float32
    modes = {}
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        for dtype in ("float32", "bfloat16"):
            got = design_modes(dtype, "cuda", 512)
            logp = {m: np.log(np.maximum(p, 1e-30)) for m, p in got.items()}
            modes[dtype] = {m: {"argmax_agreement": float((got[m].argmax(1) == got[None].argmax(1))
                                                           .mean()),
                                "max_abs_dp": float(np.abs(got[m] - got[None]).max()),
                                "max_abs_dlogp": float(np.abs(logp[m] - logp[None]).max())}
                            for m in QUANT_MODES}
            if dtype == "float32":
                # card and CPU at one batch (80: one batch of 1ubq's 76
                # frames), since the activation scale spans the padded batch
                torch.manual_seed(0)
                cpu_model = MODEL_REGISTRY["TIMED_rotamer"].build()  # the seed's weights
                cpu = {m: np.log(np.maximum(p, 1e-30))
                       for m, p in design_modes(dtype, "cpu", 80, cpu_model).items()}
                card = {m: np.log(np.maximum(p, 1e-30))
                        for m, p in design_modes(dtype, "cuda", 80).items()}
                for m in (None, *QUANT_MODES):
                    row = modes[dtype].setdefault(m or "none", {})
                    row["card_vs_cpu_max_abs_dp"] = float(np.abs(np.exp(card[m])
                                                                 - np.exp(cpu[m])).max())
                    row["card_vs_cpu_max_abs_dlogp"] = float(np.abs(card[m] - cpu[m]).max())
                    row["batch_80_max_abs_dlogp"] = float(np.abs(card[m] - card[None]).max())
                noise = modes[dtype]["none"]["card_vs_cpu_max_abs_dlogp"]
                log(f"quantize none float32: card against CPU max |dp| "
                    f"{modes[dtype]['none']['card_vs_cpu_max_abs_dp']:.3g}, max |dlog p| "
                    f"{noise:.3g}")
            for m in QUANT_MODES:
                row = modes[dtype][m]
                log(f"quantize {m} {dtype}: TIMED_rotamer 1ubq against unquantized: argmax "
                    f"agreement {row['argmax_agreement']:.4f}, max |dp| {row['max_abs_dp']:.3g}, "
                    f"max |dlog p| {row['max_abs_dlogp']:.3g}" + (
                        f"; batch 80, card against CPU max |dp| "
                        f"{row['card_vs_cpu_max_abs_dp']:.3g}, max |dlog p| "
                        f"{row['card_vs_cpu_max_abs_dlogp']:.3g} (limit {QUANT_CPU_SHARE} x the "
                        f"move {row['batch_80_max_abs_dlogp']:.3g})"
                        if dtype == "float32" else ""))
                assert row["argmax_agreement"] >= 0.95, (dtype, m)
                assert row["max_abs_dlogp"] > 0, f"{m} {dtype} did not move the output"
                if dtype == "float32":
                    move = row["batch_80_max_abs_dlogp"]
                    assert move > QUANT_MOVE_OVER_NOISE * noise, (dtype, m, move, noise)
                    assert row["card_vs_cpu_max_abs_dlogp"] <= QUANT_CPU_SHARE * move, (dtype, m)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    out["modes"] = modes

    work = Path(tempfile.mkdtemp(prefix=".chip_smoke_quantize_", dir=ROOT))
    try:
        inputs = work / "in"
        write_structures(inputs)
        # (3) the CLI as a subprocess, its own launch count
        cli = {}
        for model in ("TIMED", "TIMED_rotamer"):
            dest = work / f"cli_{model}"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", PREDICT_CLI,
                 *td_predict_argv(model, inputs, dest, "bfloat16", "int8")],
                cwd=work, capture_output=True, text=True, timeout=600,
                env={**os.environ, "PYTHONPATH": str(ROOT)})
            assert proc.returncode == 0, proc.stdout + proc.stderr
            n = check_td_predict_outputs(dest, model, model.endswith("rotamer"), True)
            launches = int(proc.stdout.rsplit("conv3d_int8 launches: ", 1)[1].split()[0])
            batches = -(-n // 512)
            cli[model] = {"frames": n, "launches": launches, "wall_s": time.perf_counter() - t0}
            log(f"td-predict --quantize int8 CLI subprocess, {model} bf16: rc 0, {n} frames, "
                f"{launches} launches of conv3d_int8 ({PER_FORWARD} x {batches} batches), "
                f"{cli[model]['wall_s']:.1f} s")
            assert launches == PER_FORWARD * batches, (model, launches)
        out["td_predict_cli"] = cli

        # (4) warm frames/s per mode, in-process
        conv3d_int8.launches = 0
        fps, probs = {}, {}
        for m in (None, *QUANT_MODES):
            for run in range(2):
                dest = work / f"fps_{m}_{run}"
                result = predict_main(td_predict_argv("TIMED", inputs, dest, "bfloat16", m))
            n = check_td_predict_outputs(dest, "TIMED", False, True)
            fps[m or "none"] = n / result.timings["predict"]
            probs[m] = np.concatenate([result.pdb_to_probability[k]
                                       for k in sorted(result.pdb_to_probability)])
        in_process = conv3d_int8.launches
        assert in_process == 2 * PER_FORWARD * -(-n // 512), in_process
        log("td-predict TIMED bf16, 988 frames, batch 512, warm predict frames/s: " + ", ".join(
            f"{k} {v:.0f}" for k, v in fps.items()) + f"; {gpu_name_and_power()}")
        moved = {m: (float((probs[m].argmax(1) == probs[None].argmax(1)).mean()),
                     float(np.abs(probs[m] - probs[None]).max())) for m in QUANT_MODES}
        log("td-predict TIMED bf16 against unquantized, argmax agreement and max |dp|: " + ", ".join(
            f"{m} {a:.4f} {d:.3g}" for m, (a, d) in moved.items()))
        assert all(a >= 0.95 and d > 0 for a, d in moved.values()), moved
        out["td_predict_frames_per_s"] = fps
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # (5) td-serve --quantize int8
    designers = build_designers(build_parser().parse_args([
        "--model", "TIMED_rotamer", "--allow-random-weights", "--batch_size", "512",
        "--quantize", "int8"]))
    d = designers["TIMED_rotamer"]
    server = make_server(d, "127.0.0.1", 0, "TIMED_rotamer")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        pdb = gzip.decompress(UBQ.read_bytes()).decode()
        conv3d_int8.launches = sample_inverse_cdf.launches = sample_inverse_cdf_batched.launches = 0
        status, body, dt = post(f"http://127.0.0.1:{server.server_address[1]}/design",
                                {"pdb": pdb, "n_samples": 100, "temperature": 0.2, "seed": 7})
        serve = {"conv3d_int8": conv3d_int8.launches, "sample_inverse_cdf": sample_inverse_cdf.launches,
                 "latency_s": dt}
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)
        d.close()
    p = np.array(body["probabilities"])
    assert status == 200 and p.shape == (76, 20) and np.isfinite(p).all()
    assert np.abs(p.sum(1) - 1).max() <= 1e-3 and len(body["samples"]) == 100
    assert all(len(s["sequence"]) == 76 for s in body["samples"])
    log(f"td-serve --quantize int8: /design 1ubq n=100 in {dt * 1e3:.1f} ms (first, "
        f"{stages(body['timings_s'])}); launches: conv3d_int8 {serve['conv3d_int8']}, "
        f"sample_inverse_cdf {serve['sample_inverse_cdf']}")
    assert serve["conv3d_int8"] == PER_FORWARD and serve["sample_inverse_cdf"] == 1
    assert sample_inverse_cdf_batched.launches == 0
    out["serve"] = serve

    # (6) BatchNorm folding on the card
    torch.manual_seed(SEED)
    module = MODEL_REGISTRY["TIMED"].build()
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for block in module.blocks:
            block.bn.weight.uniform_(0.5, 1.5, generator=gen)
            block.bn.bias.normal_(0, 0.1, generator=gen)
            block.bn.running_mean.normal_(0, 0.1, generator=gen)
            block.bn.running_var.uniform_(0.5, 1.5, generator=gen)
    module = module.to("cuda").eval()
    folded, n_blocks = fold_timed_bn(module)
    folded = {k: v.to("cuda") for k, v in folded.items()}
    x = torch.cat([ubq_frames(76)] * 7)[:512]
    fold = {}
    try:
        torch.backends.cudnn.allow_tf32 = False
        with torch.inference_mode():
            want = module(x)
            got = timed_inference_apply(folded, x, n_blocks)
        fold["f32_max_abs_dp"] = float((got - want).abs().max())
        torch.backends.cudnn.allow_tf32 = tf32
        half = copy.deepcopy(module)
        half.compute_dtype = torch.bfloat16
        with torch.inference_mode():
            want16 = half(x)
            got16 = timed_inference_apply(folded, x, n_blocks, torch.bfloat16)
            fold["bf16_argmax_agreement"] = float((got16.argmax(1) == want16.argmax(1))
                                                  .float().mean())
            fold["bf16_max_abs_dp"] = float((got16 - want16).abs().max())
            fold["unfolded_bf16_ms"] = time_ms(lambda: half(x), reps=10)
            fold["folded_bf16_ms"] = time_ms(
                lambda: timed_inference_apply(folded, x, n_blocks, torch.bfloat16), reps=10)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    log(f"fold_timed_bn: registry TIMED, batch 512 of 1ubq's frames: float32 folded against "
        f"unfolded max |dp| {fold['f32_max_abs_dp']:.3g}; bfloat16 argmax agreement "
        f"{fold['bf16_argmax_agreement']:.4f} (max |dp| {fold['bf16_max_abs_dp']:.3g}); bf16 "
        f"forward {fold['unfolded_bf16_ms']:.3f} ms unfolded, {fold['folded_bf16_ms']:.3f} ms "
        f"folded, per batch of 512; {gpu_name_and_power()}")
    assert fold["f32_max_abs_dp"] <= 1e-4 and fold["bf16_argmax_agreement"] >= 0.95
    out["fold"] = fold
    out["launches"] = {"td_predict_cli": sum(c["launches"] for c in cli.values()),
                       "td_predict": in_process, "serve": serve["conv3d_int8"]}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"quantize: phase passed in {out['phase_s']:.1f} s; launches of conv3d_int8 "
        f"{out['launches']}")
    return out


# --------------------------------------------------------------------------
# property-constrained design, the scatter voxelizer, the design report, and
# the sampling kernel past C = 341

LARGE_C = (512, 1024, 4096)  # and the kernel's limit, read from the card
LARGE_C_BATCH = [76, 129, 1, 33]  # the batched entry's structures at large C


def large_class_map(C: int):
    """A class map at C classes: codes 0..22, three of them not counted."""
    import numpy as np
    import torch

    return torch.from_numpy((np.random.default_rng(C).permutation(C) % 23).astype(np.uint8))


def check_large_classes() -> dict:
    """The sampling kernel past the 341 classes of a 48 KB tile: single and
    batched entries at C = 512, 1024, 4096 and the largest C the wrapper
    takes on this card, with a class map and without, codes and counts held
    to the plain version on a CPU copy; each timed as the check shapes are
    (with the map: host-inclusive, device time from a CUDA graph, bound,
    torch.searchsorted, the plain version on the card). One class past the
    limit raises in both entries."""
    import numpy as np
    import torch

    from timed_design_tpu_torch.ops.sample import (
        N_COUNTED,
        _host_offsets,
        _launch_batched,
        _tile_rows,
        max_classes,
        philox_uniforms,
        philox_uniforms_batched,
        sample_codes_plain,
        sample_codes_plain_batched,
        sample_inverse_cdf,
        sample_inverse_cdf_batched,
    )

    dev = torch.device("cuda")
    limit = max_classes(dev)
    L, n = 76, 100
    offsets = np.concatenate([[0], np.cumsum(LARGE_C_BATCH)])
    total = int(offsets[-1])
    shapes, max_err = [], 0
    for C in (*LARGE_C, limit):
        rows = _tile_rows(C, torch.cuda.current_device())
        probs_cpu = torch.from_numpy(random_probs(max(L, total), C, C))
        probs = probs_cpu.to(dev)
        one, packed = probs[:L], probs[:total]
        u = torch.from_numpy(philox_uniforms(SEED, n, L))
        ub = torch.from_numpy(philox_uniforms_batched(SEED, n, offsets))
        equal = True
        for cmap in (None, large_class_map(C)):
            dmap = None if cmap is None else cmap.to(dev)
            got = sample_inverse_cdf(one, n, SEED, dmap)
            want = sample_codes_plain(probs_cpu[:L], u, cmap)
            gotb = sample_inverse_cdf_batched(packed, offsets, n, SEED, dmap)
            wantb = sample_codes_plain_batched(probs_cpu[:total], offsets, ub, cmap)
            torch.cuda.synchronize()
            err = max(int((a.cpu().long() - b.long()).abs().max())
                      for a, b in zip((*got, *gotb), (*want, *wantb)))
            assert got[0].dtype == want[0].dtype and gotb[0].dtype == wantb[0].dtype
            max_err, equal = max(max_err, err), equal and err == 0
            log(f"sample_inverse_cdf C={C} ({rows} row(s) a tile) map={cmap is not None}: "
                f"single (L={L}, n={n}) and batched (B={len(LARGE_C_BATCH)}, sum L={total}) "
                f"codes {got[0].dtype} and counts equal to the plain version on the CPU: "
                f"{err == 0}")
        smap = large_class_map(C).to(dev)
        ud, ubd = u.to(dev), ub.to(dev)
        cdf, ut = torch.cumsum(one, -1), ud.T.contiguous()
        cdfb, ubt = torch.cumsum(packed, -1), ubd.T.contiguous()
        dev_offsets = torch.from_numpy(_host_offsets(offsets, total).astype(np.int32)).to(dev)
        for entry, Lx, run, launch, library, plain, extra in (
                ("single", L, lambda: sample_inverse_cdf(one, n, SEED, smap),
                 lambda: sample_inverse_cdf(one, n, SEED, smap),
                 lambda: torch.searchsorted(cdf, ut, right=True),
                 lambda: sample_codes_plain(one, ud, smap), n * N_COUNTED * 4),
                ("batched", total,
                 lambda: sample_inverse_cdf_batched(packed, offsets, n, SEED, smap),
                 lambda: _launch_batched(packed, dev_offsets, n, SEED, smap, rows),
                 lambda: torch.searchsorted(cdfb, ubt, right=True),
                 lambda: sample_codes_plain_batched(packed, offsets, ubd, smap),
                 len(LARGE_C_BATCH) * n * N_COUNTED * 4 + (len(offsets)) * 4)):
            host_ms = time_ms(run)
            ms = graph_ms(launch)
            library_ms = graph_ms(library)
            plain_ms = graph_ms(plain, reps=5)
            bound_ms, bound_by = bound(Lx, C, n, n * Lx + extra + C)
            shapes.append({"entry": entry, "L": Lx, "C": C, "n": n, "map": True,
                           "tile_rows": rows, "equal_to_plain": equal, "host_ms": host_ms,
                           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by,
                           "bound_share": bound_ms / ms})
            log(f"sample_inverse_cdf {entry} L={Lx} C={C} n={n} map=True: (a) host-inclusive "
                f"{host_ms:.4f} ms/call; (b) device {ms * 1e3:.2f} us/call; (c) bound "
                f"{bound_ms * 1e3:.3f} us ({bound_by}), share {bound_ms / ms:.3f}; (d) "
                f"searchsorted {library_ms * 1e3:.2f} us; (e) plain {plain_ms * 1e3:.2f} us")
        assert equal, f"the kernel disagrees with its plain version at C={C}"
    for fn in (lambda p: sample_inverse_cdf(p, 4, SEED),
               lambda p: sample_inverse_cdf_batched(p, [0, 3], 4, SEED)):
        try:
            fn(torch.ones((3, limit + 1), device=dev))
        except ValueError as e:
            assert f"limit of {limit}" in str(e), e
        else:
            raise AssertionError(f"C={limit + 1} was not refused")
    log(f"sample_inverse_cdf: C={limit + 1}, one past the limit, refused by both entries")
    return {"shapes": shapes, "max_abs_err": max_err, "limit": limit}


def property_structures() -> dict:
    """PDB text of 1ubq and of the 760-residue multichain, by name."""
    text = gzip.decompress(UBQ.read_bytes()).decode()
    return {"1ubq": text, "multichain": multichain_pdb(text)}


def parse(text: str, name: str):
    from timed_design_tpu_torch.structure import parse_pdb_string

    return parse_pdb_string(text, name=name)[0]


def check_property_design() -> dict:
    """Property-constrained design at registry widths: 1ubq and the
    multichain rewritten by ``modify_structure_with_property``, once with the
    charge map zeroed and once with a map from the seed, designed by
    TIMED_Charge (CNOCACBQ, random weights from the seed, bfloat16, batch
    512) through DesignSession with 100 samples each (one sampling launch a
    design, counted); TIMED_Polar (CNOCACBP) once on 1ubq. Checks: the Q
    channel of the neutralized frames is empty on the card and the CPU; the
    float32 probabilities of 1ubq on the card within 1e-4 of the CPU's (TF32
    off); every sample's metrics recomputed from its sequence to 1e-4
    (relative; absolute below 1)."""
    import copy

    import numpy as np
    import torch

    from timed_design_tpu_torch.engine import DesignSession
    from timed_design_tpu_torch.ops.sample import sample_inverse_cdf, sample_inverse_cdf_batched
    from timed_design_tpu_torch.sample.metrics import sequence_metrics
    from timed_design_tpu_torch.sample.sampler import apply_temperature, sample_structure
    from timed_design_tpu_torch.structure import modify_structure_with_property
    from timed_design_tpu_torch.voxel import structure_to_frame_atoms, voxelize_frame_atoms

    texts = property_structures()
    rng = np.random.default_rng(SEED)
    sessions = {}
    for name in ("TIMED_Charge", "TIMED_Polar"):
        torch.manual_seed(SEED)
        sessions[name] = DesignSession(name, compute_dtype="bfloat16", batch_size=512,
                                       allow_random_weights=True, device="cuda")
    charge = sessions["TIMED_Charge"]
    assert charge.codec.channels[-1] == "Q" and sessions["TIMED_Polar"].codec.channels[-1] == "P"
    cases = []  # (model, structure name, map name, property, map)
    for sname in texts:
        R = len(parse(texts[sname], sname).sequence1())
        cases.append(("TIMED_Charge", sname, "zeroed", "charge", np.zeros(R, np.int64)))
        cases.append(("TIMED_Charge", sname, "seeded", "charge", rng.integers(-1, 2, R)))
    cases.append(("TIMED_Polar", "1ubq", "seeded", "polarity", rng.integers(0, 2, 76)))

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    sample_inverse_cdf.launches = sample_inverse_cdf_batched.launches = 0
    results, worst_metric, f32_err = [], 0.0, 0.0
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        for model, sname, mname, prop, pmap in cases:
            session = sessions[model]
            structure = modify_structure_with_property(parse(texts[sname], sname), pmap, prop)
            t0 = time.perf_counter()
            probs, fa = session.design(structure)
            p = apply_temperature(torch.as_tensor(probs, device=session.device), 0.2)
            samples = sample_structure(p, 100, SEED, rotamer_mode=False)
            wall = time.perf_counter() - t0
            assert probs.shape == (len(pmap), 20) and np.isfinite(probs).all()
            assert np.abs(probs.sum(1) - 1).max() <= 1e-3 and len(samples) == 100
            for seq, *metrics in samples:
                want = sequence_metrics(seq)
                worst_metric = max(worst_metric, float(np.max(
                    np.abs(np.subtract(metrics, want)) / np.maximum(np.abs(want), 1.0))))
            entry = {"model": model, "structure": sname, "map": mname, "residues": len(pmap),
                     "design_and_samples_s": wall}
            if mname == "zeroed":  # the Q channel of the neutralized frames
                frames, _ = session.voxelize(structure)
                cpu = voxelize_frame_atoms(structure_to_frame_atoms(structure, session.codec),
                                           session.codec, device="cpu")
                entry["q_channel_max"] = max(float(frames[..., -1].abs().max()),
                                             float(cpu[..., -1].abs().max()))
                assert entry["q_channel_max"] < 1e-6, entry
            if sname == "1ubq" and model == "TIMED_Charge":  # float32, card against CPU
                module = copy.deepcopy(session.predictor.model).float()
                module.compute_dtype = torch.float32
                kw = {"codec": session.codec, "batch_size": 128, "compute_dtype": "float32"}
                got = DesignSession(module, device="cuda", **kw).design(structure)[0]
                want = DesignSession(copy.deepcopy(module).cpu(), device="cpu",
                                     **kw).design(structure)[0]
                entry["f32_card_vs_cpu_max_abs_dp"] = float(np.abs(got - want).max())
                f32_err = max(f32_err, entry["f32_card_vs_cpu_max_abs_dp"])
                assert entry["f32_card_vs_cpu_max_abs_dp"] <= 1e-4, entry
            results.append(entry)
            checks = {k: v for k, v in entry.items() if k.endswith(("max", "dp"))}
            log(f"property design {model} {sname} ({len(pmap)} residues) {prop} map "
                f"{mname}: design + 100 samples {wall * 1e3:.1f} ms; {checks}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    launches = sample_inverse_cdf.launches
    log(f"property design: {len(cases)} designs, launches of sample_inverse_cdf = "
        f"{launches}; sampled metrics against the sequences' at most {worst_metric:.3g} "
        "relative")
    assert launches == len(cases) and sample_inverse_cdf_batched.launches == 0
    assert worst_metric <= 1e-4
    return {"launches": launches, "designs": results, "f32_card_vs_cpu_max_abs_dp": f32_err,
            "worst_metric_rel_err": worst_metric}


def check_scatter_voxelizer() -> dict:
    """The scatter voxelizer on the card: 1ubq and the multichain, codecs
    CNOCACB and CNOCACBQ, gaussian and boolean, against the card's matmul
    voxelizer (2e-5) and against itself on the CPU (1e-6: atomic adds in
    another order; 1ubq in every case, the multichain once); the pdf spread
    against the integral (below 2e-3); ms per structure of both voxelizers
    on the card (CUDA events, 5 calls)."""
    import functools

    from timed_design_tpu_torch.voxel import Codec, structure_to_frame_atoms, voxelize_frame_atoms

    texts = property_structures()
    out, worst = [], {"matmul": 0.0, "cpu": 0.0}
    for sname, text in texts.items():
        structure = parse(text, sname)
        for codec in ("CNOCACB", "CNOCACBQ"):
            c = Codec.from_string(codec)
            fa = structure_to_frame_atoms(structure, c)
            for gaussian in (True, False):
                def vox(impl, device="cuda", spread="integral", _fa=fa, _c=c, _g=gaussian):
                    return voxelize_frame_atoms(_fa, _c, gaussian=_g, impl=impl,
                                                spread=spread, device=device)

                scatter = vox("scatter")
                entry = {"structure": sname, "codec": codec, "gaussian": gaussian,
                         "residues": int(scatter.shape[0]),
                         "vs_matmul": float((scatter - vox("matmul")).abs().max())}
                if sname == "1ubq" or (codec == "CNOCACBQ" and gaussian):
                    entry["vs_cpu"] = float((scatter.cpu() - vox("scatter", "cpu")).abs().max())
                    worst["cpu"] = max(worst["cpu"], entry["vs_cpu"])
                if gaussian:
                    entry["pdf_vs_integral"] = float(
                        (vox("scatter", spread="pdf") - scatter).abs().max())
                    assert 0 < entry["pdf_vs_integral"] < 2e-3, entry
                    for impl in ("matmul", "scatter"):
                        entry[f"{impl}_ms"] = time_ms(functools.partial(vox, impl), reps=5,
                                                      warmup=1)
                worst["matmul"] = max(worst["matmul"], entry["vs_matmul"])
                out.append(entry)
                log(f"scatter voxelizer {sname} {codec} {'gaussian' if gaussian else 'boolean'}: "
                    + ", ".join(f"{k} {v:.4g}" for k, v in entry.items()
                                if isinstance(v, float)))
    assert worst["matmul"] <= 2e-5 and worst["cpu"] <= 1e-6, worst
    return {"cases": out, "max_vs_matmul": worst["matmul"], "max_vs_cpu": worst["cpu"]}


def check_report() -> dict:
    """The design report from the card. Where matplotlib imports: ``/report``
    of a TIMED_Charge server, ``td-predict --report`` and ``td-report`` on
    its outputs as subprocesses, each with its sections and images. Where it
    does not (the card's machine): ``td-report`` and ``td-predict --report``
    as subprocesses exit non-zero naming matplotlib before reading their
    (absent) inputs; ``/report`` answers an error naming matplotlib before
    the designer sees the request; ``/design`` answers 200 right after."""
    import importlib.util
    import os
    import tempfile
    import urllib.error

    from timed_design_tpu_torch.cli.serve import make_server
    from timed_design_tpu_torch.engine import DesignSession
    from timed_design_tpu_torch.engine.coalescer import SerialDesigner

    import torch

    has_mpl = importlib.util.find_spec("matplotlib") is not None
    work = Path(tempfile.mkdtemp(prefix=".chip_smoke_report_", dir=ROOT))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    pdb = gzip.decompress(UBQ.read_bytes()).decode()
    torch.manual_seed(SEED)
    d = SerialDesigner(DesignSession("TIMED_Charge", allow_random_weights=True,
                                     batch_size=512, device="cuda"))
    server = make_server(d, "127.0.0.1", 0, "TIMED_Charge")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    result = {"matplotlib": has_mpl}
    try:
        req = urllib.request.Request(url + "/report", data=pdb.encode(), method="POST")
        if has_mpl:
            with urllib.request.urlopen(req, timeout=300) as r:
                doc = r.read().decode()
            assert r.status == 200 and "<h2>queryA</h2>" in doc
            assert doc.count("data:image/png;base64,") == 3
        else:
            try:
                urllib.request.urlopen(req, timeout=300)
                raise AssertionError("/report answered without matplotlib")
            except urllib.error.HTTPError as e:
                body = json.loads(e.read())
                assert e.code == 422 and "matplotlib" in body["error"], body
            assert d.stats["requests"] == 0, "/report reached the designer"
        status, body, _ = post(url + "/design", {"pdb": pdb, "n_samples": 10, "seed": 1})
        assert status == 200 and body["n_residues"] == 76 and len(body["samples"]) == 10
        result["report_status"] = 200 if has_mpl else 422
        out = work / "out"
        predict = [sys.executable, "-m", "timed_design_tpu_torch.cli.predict", "--voxelize",
                   "--path_to_model", "TIMED_Charge", "--allow-random-weights",
                   "--codec", "CNOCACBQ", "--report", "--device", "cuda",
                   "--path_to_output", str(out),
                   "--path_to_datasetmap", str(out / "datasetmap.txt")]
        report = [sys.executable, "-m", "timed_design_tpu_torch.cli.report",
                  "--path_to_output", str(out)]
        if has_mpl:
            runs = [predict + ["--path_to_dataset", str(UBQ)],
                    report + ["--path_to_pred_matrix", str(out / "TIMED_Charge.csv"),
                              "--path_to_datasetmap", str(out / "TIMED_Charge.txt")]]
        else:
            missing = str(work / "missing")
            runs = [predict + ["--path_to_dataset", missing + ".pdb"],
                    report + ["--path_to_pred_matrix", missing + ".csv",
                              "--path_to_datasetmap", missing + ".txt"]]
        for argv in runs:
            proc = subprocess.run(argv, cwd=work, capture_output=True, text=True,
                                  timeout=600, env=env)
            if has_mpl:
                assert proc.returncode == 0, proc.stdout + proc.stderr
            else:
                assert proc.returncode != 0 and "matplotlib" in proc.stderr, proc.stderr
                assert "missing" not in proc.stderr and not out.exists(), proc.stderr
                log(f"report: {argv[2]} without matplotlib exits {proc.returncode}: "
                    f"{proc.stderr.strip().splitlines()[-1]}")
        if has_mpl:
            doc = (out / "TIMED_Charge_report.html").read_text()
            assert "<h2>1ubqA</h2>" in doc and doc.count("data:image/png;base64,") == 3
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)
        d.close()
        shutil.rmtree(work, ignore_errors=True)
    log("report: " + ("matplotlib present: /report, td-predict --report and td-report rendered"
                       if has_mpl else "matplotlib missing: td-report, td-predict --report and "
                       "/report refused before any work, /design answered 200 after"))
    return result


def check_properties() -> dict:
    """The phase of property-constrained design, the scatter voxelizer, the
    design report and the sampling kernel past C = 341; its launches are
    the property designs'."""
    t0 = time.perf_counter()
    large = check_large_classes()
    design = check_property_design()
    scatter = check_scatter_voxelizer()
    report = check_report()
    phase_s = time.perf_counter() - t0
    log(f"properties: phase passed in {phase_s:.1f} s")
    return {"launches": design["launches"], "large_c": large, "design": design,
            "scatter": scatter, "report": report, "phase_s": phase_s}


# --------------------------------------------------------------------------
# HDF5 frame datasets: td-voxelize, td-convert-dataset, td-predict on .hdf5,
# td-train, through the port's own HDF5 reader and writer (no h5py here)

HDF5_OVERFIT_EPOCHS = 400  # td-train steps of the 1ubq overfit (batch 76)
HDF5_REPEATS = 8  # copies of the 988 frames' files: 7904 frames, 16 batches of 512


def repeated_structures(inputs: Path, dest: Path, copies: int) -> list[Path]:
    """``copies`` of each file in ``inputs`` under names of their own in
    ``dest``: a dataset of many batches from the same structures."""
    dest.mkdir()
    out = []
    for src in sorted(inputs.iterdir()):
        stem, dot, ext = src.name.partition(".")
        for i in range(copies):
            out.append(dest / f"{stem}x{i}{dot}{ext}")
            shutil.copy(src, out[-1])
    return out


def argmax_rows(out: Path, model: str) -> "np.ndarray":
    """The argmax per residue of a td-predict run's matrix, as its fasta
    decodes it (the float16 values)."""
    import numpy as np

    name = f"{model}_rot.csv" if model.endswith("rotamer") else f"{model}.csv"
    return np.loadtxt(out / name, delimiter=",", ndmin=2).astype(np.float16).argmax(1)


def check_hdf5(keep_flat_bf16: Path | None = None) -> dict:
    """HDF5 frame datasets on the card, through the port's own reader and
    writer (``io/hdf5.py``; this machine has no h5py). (1) ``td-voxelize``
    of the td-predict phase's 988 frames (every NMR state) into the tree
    layout (this call warms the card up), then of HDF5_REPEATS copies of
    their files (7904 frames, 16 batches of 512: what the rest reads):
    frames/s, split into voxelization on the card and gzip plus write on the
    host. (2) ``td-convert-dataset`` to flat float32 and bfloat16; the frames
    read back from the tree file equal the card's own voxelization
    (FrameBatchSource) to 2e-5; the loader alone, each layout to the card,
    frames/s. (3) ``td-predict`` of TIMED and TIMED_rotamer (registry widths,
    after one unrecorded warm-up run of each,
    random weights from a seed, bfloat16, batch 512, ``--is_structure_nmr``)
    from each layout and with ``--voxelize``: frames/s and the share of the
    predict phase spent waiting on the loader; the files without a
    probability byte-equal everywhere; every file byte-equal across the
    three layouts (bfloat16 frames are the engine's own cast), or within the
    distance between two runs of one layout; against ``--voxelize``, argmax
    equal at 99% of the residues at least (its frames differ in the last
    bits). (4) ``td-predict --quantize int8`` from the flat bfloat16 file:
    exactly PER_FORWARD int8 launches per batch per model. (5) one epoch of
    ``fit`` of registry TIMED in bfloat16 fed by FrameBatchLoader from the
    tree and the flat bfloat16 file (fit_one_epoch). (6)
    ``td-train --bf16 --lr_schedule cosine`` from a tree file of 1ubq, an
    overfit, then ``td-predict`` from its checkpoint on that file: recovery
    of at least 0.9. No path launches the sampling kernel; only (4) the int8 one.
    ``keep_flat_bf16``: where the flat bfloat16 file is moved to, for
    check_keras, instead of being deleted with the rest."""
    import tempfile

    import numpy as np
    import torch

    from timed_design_tpu_torch.cli import convert_dataset, train, voxelize
    from timed_design_tpu_torch.cli.predict import main as predict_main
    from timed_design_tpu_torch.io import FrameBatchLoader
    from timed_design_tpu_torch.io import create_flat_dataset_map as h5_map
    from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8
    from timed_design_tpu_torch.ops.sample import sample_inverse_cdf, sample_inverse_cdf_batched
    from timed_design_tpu_torch.voxel import FrameBatchSource, create_flat_dataset_map, make_frame_set

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix=".chip_smoke_hdf5_", dir=ROOT))
    sample_inverse_cdf.launches = sample_inverse_cdf_batched.launches = 0
    conv3d_int8.launches = 0
    out: dict = {}
    try:
        write_structures(work / "in")
        inputs = work / "many"
        paths = repeated_structures(work / "in", inputs, HDF5_REPEATS)
        n_frames = 988 * HDF5_REPEATS
        # (1) td-voxelize
        vox = {}
        for tag, src, n in (("first", work / "in", 988), ("warm", inputs, n_frames)):
            t0 = time.perf_counter()
            path, phases = voxelize.main([str(src), "-e", ".pdb*", "-n", f"tree_{tag}", "-o",
                                          str(work), "--voxelise_all_states"])
            wall = time.perf_counter() - t0
            vox[tag] = {"frames": n, "wall_s": wall, "phases_s": phases,
                        "frames_per_s": n / wall, "mb": path.stat().st_size / 1e6}
            log(f"td-voxelize ({tag}) {n} frames, tree gzip: {wall:.3f} s, "
                f"{n / wall:.0f} frames/s; " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                                        phases.items())
                + f"; {vox[tag]['mb']:.1f} MB; {gpu_name_and_power()}")
        tree = work / "tree_warm.hdf5"
        out["td_voxelize"] = vox
        # (2) td-convert-dataset, and the frames read back
        files = {"tree": tree}
        conv = {}
        for dt in ("float32", "bfloat16"):
            files[f"flat_{dt}"] = work / f"flat_{dt}.hdf5"
            t0 = time.perf_counter()
            convert_dataset.main([str(tree), str(files[f"flat_{dt}"]), "--frame-dtype", dt])
            conv[dt] = {"wall_s": time.perf_counter() - t0,
                        "mb": files[f"flat_{dt}"].stat().st_size / 1e6}
            log(f"td-convert-dataset tree -> flat {dt}: {conv[dt]['wall_s']:.3f} s, "
                f"{n_frames / conv[dt]['wall_s']:.0f} frames/s, {conv[dt]['mb']:.1f} MB")
        out["td_convert_dataset"] = conv
        dmap, _ = h5_map(tree)
        fs = make_frame_set(paths, voxelise_all_states=True)
        assert create_flat_dataset_map(fs).entries == dmap.entries
        assert len(dmap.entries) == n_frames
        err = 0.0
        for (Xf, yf, nf), (Xs, ys, ns) in zip(FrameBatchLoader(tree, dmap, 512, device="cuda"),
                                              FrameBatchSource(fs, dmap, 512, device="cuda")):
            assert nf == ns and (yf == ys).all() and Xf.device.type == "cuda"
            err = max(err, float((Xf[:nf] - Xs[:ns]).abs().max()))
        log(f"hdf5: frames read back from the tree file against the card's voxelization: "
            f"max |d| {err:.3g}")
        assert err <= 2e-5
        out["frames_max_abs_err"] = err
        # the loader alone, each layout to the card (the tree's gzip chunks
        # inflated by csrc/inflate_pool.cpp): the first pass of a loader (a
        # tree file's chunk index looked up) and its second
        alone = {}
        for name, path in files.items():
            loader = FrameBatchLoader(path, dmap, 512, device="cuda")
            for p in ("first", "second"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for X, _, _ in loader:
                    pass
                torch.cuda.synchronize()
                alone[f"{name}_{p}"] = n_frames / (time.perf_counter() - t0)
        log("hdf5: FrameBatchLoader alone to the card, batch 512: " + ", ".join(
            f"{k} {v:.0f} frames/s" for k, v in alone.items()) + f"; {gpu_name_and_power()}")
        out["loader_frames_per_s"] = alone

        # (3) td-predict from each layout, and with --voxelize
        def run(model, src, dest, extra=()):
            argv = ["--path_to_dataset", str(src), "--path_to_model", model,
                    "--allow-random-weights", "--batch_size", "512", "--compute_dtype",
                    "bfloat16", "--device", "cuda", "--path_to_output", str(dest),
                    "--path_to_datasetmap", str(dest / "datasetmap.txt"), "--is_structure_nmr",
                    *extra]
            argv += ["--predict_rotamers"] if model.endswith("rotamer") else []
            result = predict_main(argv)
            n = check_td_predict_outputs(dest, model, model.endswith("rotamer"), True)
            t = result.timings
            return {"frames": n, "predict_frames_per_s": n / t["predict"],
                    "loader_wait_share": result.loader_wait_s / t["predict"], "timings_s": t}

        predict = {}
        for model in ("TIMED", "TIMED_rotamer"):
            # a first run of the model in this process, not recorded: cuDNN's
            # warm-up would land on whichever layout came first
            run(model, files["flat_bfloat16"], work / f"{model}_warmup")
            runs = {"voxelize": run(model, inputs, work / f"{model}_voxelize", ["--voxelize"])}
            for name, path in files.items():
                runs[name] = run(model, path, work / f"{model}_{name}")
            dirs = {k: work / f"{model}_{k}" for k in runs}
            names = sorted(p.name for p in dirs["tree"].iterdir())
            for k, d in dirs.items():
                assert sorted(p.name for p in d.iterdir()) == names, k
            structural = PREDICT_STRUCTURAL + (f"{model}.txt", f"{model}_consensus.txt")
            for name in structural:
                assert len({(d / name).read_bytes() for d in dirs.values()}) == 1, name
            unequal = [(k, n) for k in ("flat_float32", "flat_bfloat16") for n in names
                       if (dirs[k] / n).read_bytes() != (dirs["tree"] / n).read_bytes()]
            layouts = {"byte_equal": not unequal}
            if unequal:  # another cuDNN algorithm: hold them to two runs of one layout
                again = work / f"{model}_tree_again"
                run(model, tree, again)
                matrix = f"{model}_rot.csv" if model.endswith("rotamer") else f"{model}.csv"
                load = lambda d: np.loadtxt(d / matrix, delimiter=",", ndmin=2)  # noqa: E731
                ref = load(dirs["tree"])
                noise = float(np.abs(load(again) - ref).max())
                dist = max(float(np.abs(load(dirs[k]) - ref).max()) for k, _ in unequal)
                layouts.update(unequal=unequal, max_abs_dp=dist, run_to_run_max_abs_dp=noise)
                log(f"hdf5 td-predict {model}: layouts differ in {unequal}: max |dp| {dist:.3g} "
                    f"against two tree runs' {noise:.3g}")
                assert dist <= noise, "the layouts differ by more than two runs of one layout"
            vox_argmax, tree_argmax = argmax_rows(dirs["voxelize"], model), argmax_rows(
                dirs["tree"], model)
            agree = float((vox_argmax == tree_argmax).mean())
            layouts["voxelize_fasta_byte_equal"] = all(
                (dirs["voxelize"] / n).read_bytes() == (dirs["tree"] / n).read_bytes()
                for n in names if n.endswith(".fasta"))
            layouts["voxelize_argmax_agreement"] = agree
            assert agree >= 0.99, f"{model}: argmax agreement {agree:.4f} with --voxelize"
            predict[model] = {"runs": runs, "layouts": layouts}
            log(f"hdf5 td-predict {model} bf16, {n_frames} frames, batch 512: " + "; ".join(
                f"{k} {r['predict_frames_per_s']:.0f} frames/s (loader wait "
                f"{r['loader_wait_share']:.3f} of predict)" for k, r in runs.items())
                + f"; layouts byte-equal: {layouts['byte_equal']}; fasta against --voxelize "
                f"byte-equal: {layouts['voxelize_fasta_byte_equal']} (argmax agreement "
                f"{agree:.4f}); {gpu_name_and_power()}")
        out["td_predict"] = predict
        assert conv3d_int8.launches == 0, "an unquantized HDF5 path launched int8"

        # (4) td-predict --quantize int8 from the flat bfloat16 file
        quant = {}
        for model in ("TIMED", "TIMED_rotamer"):
            conv3d_int8.launches = 0
            r = run(model, files["flat_bfloat16"], work / f"{model}_int8", ["--quantize", "int8"])
            r["launches"] = conv3d_int8.launches
            batches = -(-r["frames"] // 512)
            log(f"hdf5 td-predict --quantize int8 {model} from the flat bfloat16 file: "
                f"{r['predict_frames_per_s']:.0f} frames/s, conv3d_int8 launches {r['launches']} "
                f"({batches} batches)")
            assert r["launches"] == PER_FORWARD * batches
            quant[model] = r
        out["td_predict_int8"] = quant
        int8_launches = sum(q["launches"] for q in quant.values())

        # (5) fit fed from the files
        feed = {}
        for name in ("tree", "flat_bfloat16"):
            loader = FrameBatchLoader(files[name], dmap, 256, shuffle=True, shuffle_seed=0,
                                      device="cuda")
            feed[name] = fit_one_epoch(loader, torch.bfloat16)
        out["fit_steps_from_file"] = feed

        # (6) td-train: the 1ubq overfit, then td-predict from its checkpoint
        ubq, _ = voxelize.main([str(work / "in" / "1ubq.pdb1.gz"), "-n", "ubq", "-o", str(work)])
        ckpt = work / "overfit.npz"
        t0 = time.perf_counter()
        # a cosine schedule: the weights come to rest, so that BatchNorm's
        # running statistics catch up with them (at a constant 3e-3 they lag
        # Adam's moves, and evaluation mode recovered 0.789)
        state = train.main(["--path_to_dataset", str(ubq), "--model", "TIMED", "--bf16",
                            "--batch_size", "76", "--epochs", str(HDF5_OVERFIT_EPOCHS),
                            "--learning_rate", "3e-3", "--lr_schedule", "cosine",
                            "--bn_momentum", "0.9", "--output", str(ckpt)])
        train_s = time.perf_counter() - t0
        dest = work / "overfit_predict"
        predict_main(["--path_to_dataset", str(ubq), "--path_to_model", f"TIMED@{ckpt}",
                      "--compute_dtype", "bfloat16", "--device", "cuda", "--path_to_output",
                      str(dest), "--path_to_datasetmap", str(dest / "datasetmap.txt")])
        check_td_predict_outputs(dest, "TIMED", rotamer=False, nmr=False)
        designed = (dest / "TIMED.fasta").read_text().splitlines()[1::2]
        native = (dest / "dataset.fasta").read_text().splitlines()[1::2]
        recovery = float(np.mean([a == b for d, r in zip(designed, native)
                                  for a, b in zip(d, r)]))
        log(f"td-train --bf16 from the tree file of 1ubq: {state.step} steps in {train_s:.1f} s "
            f"({76 * state.step / train_s:.0f} frames/s with the CLI's set-up); td-predict from "
            f"its checkpoint: recovery {recovery:.3f}")
        assert recovery >= 0.9, f"recovery {recovery:.3f} from the td-train checkpoint"
        out["td_train"] = {"steps": state.step, "wall_s": train_s, "recovery": recovery}
        launches = sample_inverse_cdf.launches + sample_inverse_cdf_batched.launches
        assert launches == 0, "an HDF5 path launched the sampling kernel"
        if keep_flat_bf16 is not None:
            shutil.move(files["flat_bfloat16"], keep_flat_bf16)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["launches"] = launches
    out["int8_launches"] = int8_launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"hdf5: phase passed in {out['phase_s']:.1f} s; launches of the sampling kernel 0, "
        f"of conv3d_int8 {int8_launches}")
    return out


KERAS_FIXTURES = ROOT / "tests" / "testing_files" / "keras"
KERAS_FIXTURE_SEED = 20261017  # tests/test_torch_keras.py::FIXTURE_SEED, the fixtures' frames
KERAS_CONVS = 5  # convolutions of the fixtures' graph (tests/test_torch_keras.py::_geometry)
KERAS_TRAIN_EPOCHS = 3  # td-train steps from TIMED.h5 (batch 76, 1ubq)


def keras_release(name: str, dest: Path, seed: int = SEED, stem: str | None = None):
    """Registry ``name`` with weights from ``seed`` (BatchNorm running
    statistics perturbed), written as ``{stem}.h5`` by the port's exporter
    and as ``{stem}.npz`` (``stem`` defaults to ``name``): (module on the
    CPU, the .h5, the .npz)."""
    import types

    import torch

    from timed_design_tpu_torch.models import MODEL_REGISTRY, export_timed_to_h5
    from timed_design_tpu_torch.train import save_checkpoint
    from timed_design_tpu_torch.train.train import flax_variables

    spec = MODEL_REGISTRY[name]
    stem = stem or name
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = spec.build().eval()
        for block in module.blocks:
            block.bn.running_mean.normal_(0.0, 0.1)
            block.bn.running_var.uniform_(0.5, 2.0)
    tree = flax_variables(module)
    h5 = export_timed_to_h5(tree["params"], tree["batch_stats"], dest / f"{stem}.h5",
                            n_classes=spec.n_classes)
    npz = dest / f"{stem}.npz"
    save_checkpoint(types.SimpleNamespace(module=module), npz)
    return module, h5, npz


def check_keras(flat_bf16: Path) -> dict:
    """Keras ``.h5`` release files on the card (``models/keras_import.py``,
    ``models/keras_export.py``). This machine has no TF: the release files
    are written by the port's exporter, and the TF-written fixtures of
    ``tests/testing_files/keras/`` are read. (a) Registry TIMED and
    TIMED_rotamer from seeded weights as ``.h5`` and ``.npz``. (b) float32
    (TF32 off) on 1ubq: the imported graph against the native module with
    the same weights, 1e-5; the card against the CPU, 1e-4. (c) bf16 at
    batch 512 (1ubq tiled): argmax agreement >= 0.99 with the native module.
    (d) ``td-serve --model TIMED_rotamer.h5`` in process (bf16, batch 512)
    answers ``/design`` on 1ubq with 100 samples: 200, one sampling launch a
    design, codes and counts equal to the plain version on a CPU copy; warm
    latency against the ``TIMED_rotamer@.npz`` server's (A B B A). (e)
    ``td-predict --path_to_model TIMED.h5`` (bf16, batch 512) on the HDF5
    phase's flat bf16 file against ``TIMED@.npz`` (after a warm-up run of
    each, A B B A, frames/s),
    argmax agreement >= 0.99; then ``--quantize int8``: PER_FORWARD launches
    a batch. (f) The TF fixtures: float32 against TF's stored predictions,
    1e-4; under ``int8`` each launch equal to ``conv3d_int8_plain`` on a CPU
    copy (``torch.equal``), the strided, dilated and even-kernel
    convolutions included. (g) ``td-train --bf16 --init_from TIMED.h5
    --output out.h5`` on 1ubq; ``out.h5`` imported predicts as the trained
    module, float32, 1e-5."""
    import copy
    import tempfile

    import numpy as np
    import torch

    import timed_design_tpu_torch.models.quantize as quantize
    import timed_design_tpu_torch.sample.sampler as sampler
    from timed_design_tpu_torch.cli import train, voxelize
    from timed_design_tpu_torch.cli.predict import main as predict_main
    from timed_design_tpu_torch.cli.serve import build_designers, build_parser, make_server
    from timed_design_tpu_torch.models import MODEL_REGISTRY, load_keras_model, quantized_convs
    from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8, conv3d_int8_plain
    from timed_design_tpu_torch.ops.sample import sample_inverse_cdf, sample_inverse_cdf_batched

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix=".chip_smoke_keras_", dir=ROOT))
    sample_inverse_cdf.launches = sample_inverse_cdf_batched.launches = 0
    conv3d_int8.launches = 0
    out: dict = {}
    torch.backends.cudnn.allow_tf32 = False

    def forward(model, x):
        with torch.inference_mode():
            return model(x)

    try:
        # (a) the release files
        native, files = {}, {}
        for name in ("TIMED", "TIMED_rotamer"):
            native[name], *files[name] = keras_release(name, work)
        x = ubq_frames(76)
        x512 = torch.cat([x] * 7)[:512]
        # (b) float32: imported against native on the card, card against CPU
        f32 = {}
        for name, (h5, _) in files.items():
            imported = load_keras_model(h5).to("cuda").eval()
            assert imported.name == name and imported.n_classes == native[name].n_classes
            card = forward(imported, x)
            want = forward(copy.deepcopy(native[name]).to("cuda"), x)
            cpu = forward(load_keras_model(h5).eval(), x.cpu())
            f32[name] = {"imported_vs_native": float((card - want).abs().max()),
                         "card_vs_cpu": float((card.cpu() - cpu).abs().max())}
            assert f32[name]["imported_vs_native"] <= 1e-5, f32
            assert f32[name]["card_vs_cpu"] <= 1e-4, f32
            # (c) bf16 at batch 512
            half = load_keras_model(h5, torch.bfloat16).to("cuda").eval()
            ref = MODEL_REGISTRY[name].build(compute_dtype=torch.bfloat16)
            ref.load_state_dict(native[name].state_dict())
            got, base = forward(half, x512), forward(ref.to("cuda").eval(), x512)
            f32[name]["bf16_argmax_agreement"] = float(
                (got.argmax(1) == base.argmax(1)).float().mean())
            assert f32[name]["bf16_argmax_agreement"] >= 0.99, f32
        out["forward"] = f32
        log("keras: imported registry models against the native modules (1ubq): " + "; ".join(
            f"{n} float32 max |dp| {v['imported_vs_native']:.3g}, card against CPU "
            f"{v['card_vs_cpu']:.3g}, bf16 batch 512 argmax agreement "
            f"{v['bf16_argmax_agreement']:.4f}" for n, v in f32.items()))

        # (d) td-serve --model TIMED_rotamer.h5, beside the npz server
        draws = []
        real_sample = sampler.sample_inverse_cdf

        def recording(probs, n, seed, class_map=None):
            codes, counts = real_sample(probs, n, seed, class_map)
            draws.append((probs.cpu(), n, seed, None if class_map is None else class_map.cpu(),
                          codes.cpu(), counts.cpu()))
            return codes, counts

        pdb = gzip.decompress(UBQ.read_bytes()).decode()
        req = {"pdb": pdb, "n_samples": 100, "temperature": 0.2, "seed": 7}
        h5_rot, npz_rot = files["TIMED_rotamer"]
        latency: dict[str, list[float]] = {}
        servers = {}
        for tag, model in (("h5", str(h5_rot)), ("npz", f"TIMED_rotamer@{npz_rot}")):
            designers = build_designers(build_parser().parse_args(
                ["--model", model, "--batch_size", "512"]))
            assert list(designers) == ["TIMED_rotamer"]
            server = make_server(designers["TIMED_rotamer"], "127.0.0.1", 0, "TIMED_rotamer")
            th = threading.Thread(target=server.serve_forever, daemon=True)
            th.start()
            servers[tag] = (designers, server, th)
        sampler.sample_inverse_cdf = recording
        try:
            urls = {k: f"http://127.0.0.1:{v[1].server_address[1]}/design"
                    for k, v in servers.items()}
            for tag in urls:  # warm-up, not recorded
                post(urls[tag], req)
            draws.clear()
            sample_inverse_cdf.launches = 0
            bodies = {}
            for tag in ("h5", "npz", "npz", "h5"):
                for _ in range(3):
                    status, body, dt = post(urls[tag], req)
                    assert status == 200 and len(body["samples"]) == 100
                    latency.setdefault(tag, []).append(dt)
                    bodies.setdefault(tag, body)
            design_launches = sample_inverse_cdf.launches
        finally:
            sampler.sample_inverse_cdf = real_sample
            for designers, server, th in servers.values():
                server.shutdown()
                server.server_close()
                th.join(timeout=10)
                for des in designers.values():
                    des.close()
        assert design_launches == len(draws) == 12, (design_launches, len(draws))
        for probs, n, seed, cmap, codes, counts in draws:
            want_codes, want_counts = sample_inverse_cdf(probs, n, seed, cmap)  # the plain version
            assert torch.equal(codes, want_codes) and torch.equal(counts, want_counts)
        agree = float((np.array(bodies["h5"]["probabilities"]).argmax(1)
                       == np.array(bodies["npz"]["probabilities"]).argmax(1)).mean())
        med = {k: float(np.median(v)) for k, v in latency.items()}
        out["serve"] = {"launches": design_launches, "latency_s": latency, "median_s": med,
                        "argmax_agreement_h5_npz": agree}
        log(f"keras: td-serve --model TIMED_rotamer.h5 bf16, /design 1ubq n=100: median "
            f"{med['h5'] * 1e3:.2f} ms against TIMED_rotamer@.npz {med['npz'] * 1e3:.2f} ms "
            f"(6 each, A B B A); {design_launches} sampling launches, codes and counts equal to "
            f"the plain version on a CPU copy; argmax agreement {agree:.4f}; "
            f"{gpu_name_and_power()}")

        # (e) td-predict on the HDF5 phase's flat bf16 file
        def run(model, dest, extra=()):
            argv = ["--path_to_dataset", str(flat_bf16), "--path_to_model", model,
                    "--batch_size", "512", "--compute_dtype", "bfloat16", "--device", "cuda",
                    "--path_to_output", str(dest), "--path_to_datasetmap",
                    str(dest / "datasetmap.txt"), "--is_structure_nmr", *extra]
            result = predict_main(argv)
            n = check_td_predict_outputs(dest, "TIMED", False, True)
            return n, n / result.timings["predict"]

        h5_timed, npz_timed = files["TIMED"]
        for model in (str(h5_timed), f"TIMED@{npz_timed}"):  # warm-up, not recorded
            run(model, work / f"predict_warmup_{Path(model).stem}")
        rates: dict[str, list[float]] = {}
        for i, (tag, model) in enumerate((("h5", str(h5_timed)), ("npz", f"TIMED@{npz_timed}"),
                                          ("npz", f"TIMED@{npz_timed}"), ("h5", str(h5_timed)))):
            n_frames, rate = run(model, work / f"predict_{tag}_{i}")
            rates.setdefault(tag, []).append(rate)
        agree = float((argmax_rows(work / "predict_h5_0", "TIMED")
                       == argmax_rows(work / "predict_npz_1", "TIMED")).mean())
        assert agree >= 0.99, f"td-predict .h5 against .npz: argmax agreement {agree:.4f}"
        conv3d_int8.launches = 0
        _, int8_rate = run(str(h5_timed), work / "predict_h5_int8", ["--quantize", "int8"])
        batches = -(-n_frames // 512)
        predict_int8_launches = conv3d_int8.launches
        assert predict_int8_launches == PER_FORWARD * batches, predict_int8_launches
        out["td_predict"] = {"frames": n_frames, "frames_per_s": rates,
                             "argmax_agreement_h5_npz": agree, "int8_frames_per_s": int8_rate,
                             "int8_launches": predict_int8_launches}
        log(f"keras: td-predict bf16 from the flat bf16 file ({n_frames} frames, batch 512): "
            f"TIMED.h5 {', '.join(f'{r:.0f}' for r in rates['h5'])} frames/s against TIMED@.npz "
            f"{', '.join(f'{r:.0f}' for r in rates['npz'])} (A B B A); argmax agreement "
            f"{agree:.4f}; --quantize int8 with TIMED.h5 {int8_rate:.0f} frames/s, "
            f"{predict_int8_launches} conv3d_int8 launches ({batches} batches); "
            f"{gpu_name_and_power()}")

        # (f) the TF-written fixtures
        calls = []

        def record(xq, wq, padding=0, scale=None, bias=None, out_dtype=None):
            y = conv3d_int8(xq, wq, padding, scale, bias, out_dtype)
            calls.append([t.cpu() if isinstance(t, torch.Tensor) else t
                          for t in (xq, wq, padding, scale, bias, out_dtype, y)])
            return y

        xf = torch.from_numpy(np.random.default_rng(KERAS_FIXTURE_SEED).random(
            (4, 21, 21, 21, 5), np.float32)).to("cuda")
        fixtures = {}
        conv3d_int8.launches = 0
        for path in sorted(KERAS_FIXTURES.glob("*.h5")):
            model = load_keras_model(path).to("cuda").eval()
            stored = torch.from_numpy(np.load(path.with_suffix(".npy")))
            err = float((forward(model, xf).cpu() - stored).abs().max())
            assert err <= 1e-4, f"{path.name}: {err:.3g} from TF's predictions"
            quantize.conv3d_int8 = record
            try:
                with quantized_convs("int8"):
                    q = forward(model, xf)
            finally:
                quantize.conv3d_int8 = conv3d_int8
            shapes = []
            for xq, wq, padding, scale, bias, out_dtype, y in calls:
                want = conv3d_int8_plain(xq, wq, padding, scale, bias, out_dtype)
                assert torch.equal(y, want), (path.name, tuple(xq.shape), tuple(wq.shape))
                shapes.append([list(xq.shape), list(wq.shape), padding])
            assert len(calls) == KERAS_CONVS, len(calls)
            calls.clear()
            fixtures[path.name] = {"max_abs_err_f32": err, "int8_calls_equal_to_plain": shapes,
                                   "int8_max_abs_dp": float((q.cpu() - stored).abs().max())}
        fixture_launches = conv3d_int8.launches
        assert len(fixtures) == 2 and fixture_launches == 2 * KERAS_CONVS, fixture_launches
        out["fixtures"] = fixtures
        log("keras: the TF fixtures on the card, float32 against TF's predictions: " + ", ".join(
            f"{k} {v['max_abs_err_f32']:.3g}" for k, v in fixtures.items())
            + f"; int8: {fixture_launches} launches, each equal to the plain version on a CPU "
            "copy (kernel inputs (B, D, H, W, C) after the rewrite, weights, padding): "
            + json.dumps({k: v["int8_calls_equal_to_plain"] for k, v in fixtures.items()}))

        # (g) td-train --init_from TIMED.h5 --output out.h5
        ubq, _ = voxelize.main([str(UBQ), "-n", "ubq", "-o", str(work)])
        trained_h5 = work / "trained.h5"
        t0 = time.perf_counter()
        state = train.main(["--path_to_dataset", str(ubq), "--model", "TIMED", "--bf16",
                            "--batch_size", "76", "--epochs", str(KERAS_TRAIN_EPOCHS),
                            "--init_from", str(h5_timed), "--output", str(trained_h5)])
        train_s = time.perf_counter() - t0
        trained = MODEL_REGISTRY["TIMED"].build()
        trained.load_state_dict(state.module.state_dict())
        err = float((forward(load_keras_model(trained_h5).to("cuda").eval(), x)
                     - forward(trained.to("cuda").eval(), x)).abs().max())
        moved = float((state.module.blocks[0].conv.weight.detach().cpu()
                       - native["TIMED"].blocks[0].conv.weight.detach()).abs().max())
        assert err <= 1e-5 and moved > 0, (err, moved)
        out["td_train"] = {"steps": state.step, "wall_s": train_s, "max_abs_dp": err}
        log(f"keras: td-train --bf16 --init_from TIMED.h5 --output trained.h5, {state.step} "
            f"steps on 1ubq in {train_s:.1f} s; trained.h5 imported against the trained module, "
            f"float32: max |dp| {err:.3g}")
        assert sample_inverse_cdf_batched.launches == 0
    finally:
        shutil.rmtree(work, ignore_errors=True)
        flat_bf16.unlink(missing_ok=True)
    out["launches"] = design_launches
    out["int8_launches"] = predict_int8_launches + fixture_launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"keras: phase passed in {out['phase_s']:.1f} s; launches of the sampling kernel "
        f"{out['launches']}, of conv3d_int8 {out['int8_launches']}")
    return out


UI_UPLOAD = "Upload your backbone/PDB of interest"
UI_PROMPT = "Upload a backbone (or give a PDB code) and press Design!"
# The figures of a design page: the CA trace (py3Dmol is missing), the
# heatmap, the 338-class chart of a rotamer head, the logo, the confusion matrix.
UI_FIGURES = {False: 4, True: 5}


class _PageCtx:
    """What a layout element returns: a context manager whose attributes
    are the recorder's (``col.metric(...)``)."""

    def __init__(self, st):
        self._st = st

    def __enter__(self):
        return self._st

    def __exit__(self, *a):
        return False

    def __getattr__(self, name):
        return getattr(self._st, name)


class PageUpload:
    """An uploaded file as streamlit hands it over: a name and its bytes."""

    def __init__(self, path: Path):
        self.name = path.name
        self._data = path.read_bytes()

    def read(self):
        return self._data


class PageRecorder:
    """A stand-in for streamlit (the card's machine has none), as
    ``timed_design_tpu_torch/ui.py`` calls it: widgets answer from
    ``responses`` or their default, every call is recorded as (kind, its
    text or None), and the Monte-Carlo tables are kept. ``session_state``
    passed on from one page to the next is a rerun of one browser session."""

    def __init__(self, responses=None, session_state=None):
        import types

        self.responses = dict(responses or {})
        self.session_state = {} if session_state is None else session_state
        self.calls: list = []
        self.tables: list = []
        self.sidebar = _PageCtx(self)
        self.components = types.SimpleNamespace(v1=types.SimpleNamespace(
            html=lambda *a, **k: self.calls.append(("html", None))))

    def _widget(self, kind, label, default):
        self.calls.append((kind, label))
        return self.responses.get(label, default)

    def text_input(self, label, value="", **k):
        return self._widget("text_input", label, value)

    def file_uploader(self, label, **k):
        return self._widget("file_uploader", label, None)

    def selectbox(self, label, options, **k):
        value = self._widget("selectbox", label, list(options)[0])
        assert value in list(options), (value, list(options))
        return value

    def multiselect(self, label, options, default=None, **k):
        return self._widget("multiselect", label, default or [])

    def checkbox(self, label, value=False, **k):
        return self._widget("checkbox", label, value)

    def number_input(self, label, lo=None, hi=None, value=None, **k):
        return self._widget("number_input", label, value)

    def slider(self, label, lo=None, hi=None, value=None, **k):
        return self._widget("slider", label, value)

    def button(self, label, **k):
        return self._widget("button", label, False)

    def dataframe(self, data, **k):
        self.calls.append(("dataframe", None))
        self.tables.append(dict(data))

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)

        def element(*args, **kwargs):
            self.calls.append((name, args[0] if args and isinstance(args[0], str) else None))
            if name == "columns":
                return [_PageCtx(self) for _ in range(args[0])]
            if name == "tabs":
                return [_PageCtx(self) for _ in args[0]]
            return _PageCtx(self)

        return element

    def kinds(self) -> list:
        return [k for k, _ in self.calls]

    def texts(self, kind: str) -> list:
        return [a for k, a in self.calls if k == kind]


def ui_figures_in_place(rec: PageRecorder, rotamer: bool) -> int:
    """(g): every figure of the page drawn, or in its place one error naming
    matplotlib; no other error. Returns the errors naming matplotlib."""
    errors = rec.texts("error")
    named = [e for e in errors if "matplotlib" in e]
    assert named == errors, f"the page showed another error: {errors}"
    assert len(named) + rec.kinds().count("pyplot") == UI_FIGURES[rotamer], rec.calls
    return len(named)


def check_ui() -> dict:
    """The Streamlit design app (``timed_design_tpu_torch/ui.py``) on the
    card, through ``PageRecorder`` installed as ``sys.modules["streamlit"]``
    (removed afterwards). Registry-width ``TIMED.h5``, ``TIMED_rotamer.h5``
    and a second 20-class ``OTHER.h5`` (weights from SEED and SEED + 1,
    written by ``keras_release``) in a ``--path_to_models``; the app's
    defaults, ``--device cuda`` and batch 512. (a) 1ubq uploaded,
    ``TIMED_rotamer.h5``, Monte-Carlo on (200 samples, T 0.2): a cold page,
    then 5 warm ones (the design cache emptied before each): the page's
    probabilities equal to a new ``DesignSession`` on the card on the same
    file, one sampling launch a page, codes and counts equal to the plain
    version on a CPU copy, the table the ranking of ``sample_structure(...,
    seed 0)`` on the card. (b) A rerun with the button off: no forward, one
    cached design, one more launch. (c) A two-state NMR file with
    ``TIMED.h5``: the consensus of the two states designed directly. (d)
    ``TIMED.h5`` + ``OTHER.h5``: the page's matrix within 2e-6 of the
    members' float64 mean. (e) ``TIMED_Charge`` in demo mode, default charge
    map, Monte-Carlo on: one launch; the rewritten structure's Q channel on
    the card against the CPU's (1e-5) and the page's probabilities equal to
    the session's design of it. (f) The script run as ``streamlit run``
    runs it (``runpy``, ``__main__``): the idle prompt. (g) On every design
    page each figure is drawn or has one error naming matplotlib in its
    place, and no other error is shown."""
    import copy
    import re
    import runpy
    import tempfile

    import numpy as np
    import torch

    import timed_design_tpu_torch.sample.sampler as sampler
    from timed_design_tpu_torch.engine import DesignSession
    from timed_design_tpu_torch.io.decode import consensus_running_average
    from timed_design_tpu_torch.ops.sample import sample_inverse_cdf, sample_inverse_cdf_batched
    from timed_design_tpu_torch.sample.metrics import sequence_metrics
    from timed_design_tpu_torch.structure import (
        convert_seq_to_property,
        create_residue_map,
        load_pdb,
        modify_structure_with_property,
        parse_pdb_string,
    )
    from timed_design_tpu_torch.voxel import structure_to_frame_atoms, voxelize_frame_atoms

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix=".chip_smoke_ui_", dir=ROOT))
    models = work / "models"
    models.mkdir()
    keras_release("TIMED_rotamer", models)
    keras_release("TIMED", models)
    keras_release("TIMED", models, seed=SEED + 1, stem="OTHER")
    argv = ["--path_to_models", str(models)]
    saved_streamlit = sys.modules.get("streamlit")
    sys.modules["streamlit"] = PageRecorder()
    import timed_design_tpu_torch.ui as ui

    draws = []
    real_sample = sampler.sample_inverse_cdf

    def recording(probs, n, seed, class_map=None):
        codes, counts = real_sample(probs, n, seed, class_map)
        draws.append((probs.cpu(), n, seed, None if class_map is None else class_map.cpu(),
                      codes.cpu(), counts.cpu()))
        return codes, counts

    # host seconds of each section of the last page (the sections end on the
    # host: the samples and the metric passes are copied back)
    sections = ("_draw_structure_view", "_draw_output_section", "_draw_performance_section",
                "_draw_optimisation_section")
    real_sections = {name: getattr(ui, name) for name in sections}
    section_s: dict = {}

    def timed(name):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            real_sections[name](*args, **kwargs)
            section_s[name.removeprefix("_draw_")] = time.perf_counter() - t0
        return run

    launches: dict = {}
    out: dict = {}

    def page(flow, responses, state):
        """One run of the page: (recorder, host seconds around main()); the
        sampling launches it made are added to the flow's."""
        rec = PageRecorder(responses, state)
        ui.st = rec
        section_s.clear()
        sample_inverse_cdf.launches = sample_inverse_cdf_batched.launches = 0
        t0 = time.perf_counter()
        ui.main(list(argv))
        wall = time.perf_counter() - t0
        assert sample_inverse_cdf_batched.launches == 0
        launches[flow] = launches.get(flow, 0) + sample_inverse_cdf.launches
        return rec, wall

    def design_entry(state):
        (entry,) = state["design_cache"].values()
        return entry

    sampler.sample_inverse_cdf = recording
    for name in sections:
        setattr(ui, name, timed(name))
    try:
        # (a) the main design flow, cold then warm
        mc = {"Optimize sequences using Monte Carlo": True, "Number of samples": 200,
              "Temperature": 0.2}
        a = {UI_UPLOAD: PageUpload(UBQ), "Choose your Model": "TIMED_rotamer", "Design!": True,
             **mc}
        state: dict = {}
        rec, cold_s = page("a", a, state)
        session = state[f"session::{models / 'TIMED_rotamer.h5'}"]
        assert session.device.type == "cuda" and launches["a"] == 1
        warm = []
        for _ in range(5):
            state["design_cache"].clear()
            draws.clear()
            rec, wall = page("a", a, state)
            line = rec.texts("success")[0]
            warm.append({"success_line_s": float(re.search(r" in ([0-9.]+)s", line).group(1)),
                         "voxelisation_s": session.last_timings["voxelisation"],
                         "prediction_s": session.last_timings["prediction"],
                         "page_s": wall, **{f"{k}_s": v for k, v in section_s.items()}})
        assert launches["a"] == 6 and len(draws) == 1
        ui_figures_in_place(rec, rotamer=True)
        (probs,), native, _ = design_entry(state)
        direct = DesignSession(str(models / "TIMED_rotamer.h5"), codec="CNOCACB",
                               batch_size=512, device="cuda")
        want = direct.design(load_pdb(UBQ))[0].astype(np.float32)
        assert probs.shape == (76, 338) and np.array_equal(probs, want), \
            float(np.abs(probs - want).max())
        p, n, seed, cmap, codes, counts = draws[0]
        assert (n, seed) == (200, 0) and cmap is not None
        want_codes, want_counts = sample_inverse_cdf(p, n, seed, cmap)  # the plain version
        assert torch.equal(codes, want_codes) and torch.equal(counts, want_counts)
        samples = sampler.sample_structure(probs, 200, 0, rotamer_mode=True, temperature=0.2,
                                           device="cuda")
        ref = np.array(sequence_metrics(native))
        mae = [np.abs((np.array(s[1:]) - ref) / np.where(ref == 0, 1, ref)).sum()
               for s in samples]
        order = np.argsort(mae, kind="stable")[:25]
        table = rec.tables[-1]
        assert table["sequence"] == [samples[i][0] for i in order]
        assert table["MAE"] == [mae[i] for i in order]
        out["a"] = {"cold_page_s": cold_s, "warm": warm}
        med = {k: float(np.median([w[k] for w in warm])) for k in warm[0]}
        out["a"]["warm_median"] = med
        log(f"ui (a): 1ubq, TIMED_rotamer.h5 bf16 batch 512, Monte-Carlo 200 samples T 0.2: "
            f"cold page {cold_s:.3f} s; warm (median of 5): success line "
            f"{med['success_line_s']:.2f} s, voxelisation "
            f"{med['voxelisation_s'] * 1e3:.2f} ms + prediction "
            f"{med['prediction_s'] * 1e3:.2f} ms, page (host clock around main) "
            f"{med['page_s'] * 1e3:.2f} ms, of which the sections: "
            + ", ".join(f"{k.removesuffix('_s')} {v * 1e3:.2f} ms" for k, v in med.items()
                        if k.endswith(("view_s", "section_s")))
            + "; probabilities equal to a DesignSession; "
            f"one launch a page, codes and counts equal to the plain version; the table is "
            f"sample_structure's ranking; {gpu_name_and_power()}")

        # (b) a rerun with the button off: from the design cache
        forwards = []
        session_design = session.design
        session.design = lambda s: forwards.append(1) or session_design(s)
        rec, rerun_s = page("b", {**a, "Design!": False}, state)
        del session.design
        assert not forwards and launches["b"] == 1 and len(state["design_cache"]) == 1
        assert "success" in rec.kinds() and UI_PROMPT not in rec.texts("info")
        ui_figures_in_place(rec, rotamer=True)
        out["b"] = {"page_s": rerun_s, **{f"{k}_s": v for k, v in section_s.items()}}
        log(f"ui (b): rerun with Design! off: page {rerun_s * 1e3:.2f} ms (no forward, one "
            "cached design), of which the sections: "
            + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in section_s.items())
            + f"; 1 launch; {gpu_name_and_power()}")

        # (c) NMR consensus
        nmr = work / "2nmr.pdb"
        nmr.write_text(nmr_pdb(gzip.decompress(UBQ.read_bytes()).decode()))
        state = {}
        rec, nmr_s = page("c", {UI_UPLOAD: PageUpload(nmr), "Choose your Model": "TIMED",
                                "Design all NMR states (consensus)": True, "Design!": True},
                          state)
        assert "2 NMR states" in rec.texts("success")[0] and launches["c"] == 0
        ui_figures_in_place(rec, rotamer=False)
        per_state, _, _ = design_entry(state)
        session = state[f"session::{models / 'TIMED.h5'}"]
        states = parse_pdb_string(nmr.read_text(), name="2nmr", all_states=True)
        want = consensus_running_average(
            [session.design(s)[0].astype(np.float32) for s in states])
        assert len(per_state) == 2 and np.array_equal(ui._nmr_consensus(per_state), want)
        out["c"] = {"page_s": nmr_s}

        # (d) ensemble
        state = {}
        rec, ens_s = page("d", {UI_UPLOAD: PageUpload(UBQ), "Choose your Model": "TIMED",
                                "Ensemble: average several models (optional)": ["TIMED", "OTHER"],
                                "Design!": True}, state)
        assert "TIMED + OTHER ensemble" in rec.texts("success")[0] and launches["d"] == 0
        ui_figures_in_place(rec, rotamer=False)
        (probs,), _, _ = design_entry(state)
        s = load_pdb(UBQ)
        members = [state[f"session::{models / f'{m}.h5'}"].design(s)[0].astype(np.float64)
                   for m in ("TIMED", "OTHER")]
        ens_err = float(np.abs(probs - np.mean(members, axis=0)).max())
        assert ens_err <= 2e-6 and np.abs(members[0] - members[1]).max() > 0, ens_err
        out["d"] = {"page_s": ens_s, "max_abs_err_mean": ens_err}

        # (e) property-constrained design, demo mode
        state = {}
        torch.manual_seed(SEED)
        rec, prop_s = page("e", {UI_UPLOAD: PageUpload(UBQ), "Choose your Model": "TIMED_Charge",
                                 "Demo mode (random weights)": True, "Design!": True, **mc},
                           state)
        assert launches["e"] == 1 and "Constrain charge" in rec.texts("subheader")
        assert any("RANDOM weights" in w for w in rec.texts("warning"))
        ui_figures_in_place(rec, rotamer=False)
        (native_states,) = state["parse_cache"].values()
        _, full_native = create_residue_map(native_states[0])
        pmap = np.asarray(convert_seq_to_property(full_native, "charge"), int)
        rewritten = modify_structure_with_property(copy.deepcopy(native_states[0]), pmap,
                                                   "charge")
        session = state["session::TIMED_Charge"]
        frames, _ = session.voxelize(rewritten)
        cpu = voxelize_frame_atoms(structure_to_frame_atoms(rewritten, session.codec),
                                   session.codec, device="cpu")
        q_err = float((frames[..., -1].cpu() - cpu[..., -1]).abs().max())
        assert session.codec.channels[-1] == "Q" and float(cpu[..., -1].abs().max()) > 0
        assert q_err <= 1e-5, q_err
        (probs,), _, _ = design_entry(state)
        assert np.array_equal(probs, session.design(rewritten)[0].astype(np.float32))
        out["e"] = {"page_s": prop_s, "q_channel_card_vs_cpu": q_err}

        # (f) the script started as `streamlit run` starts it
        rec = PageRecorder()
        sys.modules["streamlit"] = rec
        saved_path, saved_argv = list(sys.path), sys.argv
        try:
            sys.argv = [str(ROOT / "timed_design_tpu_torch" / "ui.py")]
            sample_inverse_cdf.launches = 0
            runpy.run_path(sys.argv[0], run_name="__main__")
        finally:
            sys.path[:], sys.argv = saved_path, saved_argv
        assert rec.texts("info") == [UI_PROMPT] and sample_inverse_cdf.launches == 0
    finally:
        sampler.sample_inverse_cdf = real_sample
        for name in sections:
            setattr(ui, name, real_sections[name])
        if saved_streamlit is None:
            sys.modules.pop("streamlit", None)
        else:
            sys.modules["streamlit"] = saved_streamlit
        shutil.rmtree(work, ignore_errors=True)
    out["launches_by_flow"] = launches
    out["launches"] = sum(launches.values())
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"ui: (c) NMR consensus page {nmr_s * 1e3:.2f} ms, (d) ensemble page "
        f"{ens_s * 1e3:.2f} ms (max |p - mean| {ens_err:.3g}), (e) TIMED_Charge page "
        f"{prop_s * 1e3:.2f} ms (Q channel card against CPU {q_err:.3g}), (f) the script's "
        f"idle prompt; launches of the sampling kernel by flow {json.dumps(launches)}; "
        f"each figure's place holds an error naming matplotlib where it is missing; phase "
        f"{out['phase_s']:.1f} s; {gpu_name_and_power()}")
    return out


# The scale-out phase (check_scale_out): registry models over a mesh of one
# process per card, on the td-predict phase's 988 frames.
SCALE_OUT_MODELS = ("TIMED", "TIMED_rotamer")

# td-predict under torchrun: every int8 launch recorded (8 rows of each) and,
# after the run, held to the plain version on a CPU copy; the launches of
# both kernels in that process printed
PREDICT_CLI_CHECKED = """
import runpy, sys
import chip_smoke
import timed_design_tpu_torch.models.quantize as quantize
from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8
from timed_design_tpu_torch.ops.sample import sample_inverse_cdf, sample_inverse_cdf_batched
calls = []
def record(xq, wq, padding=0, scale=None, bias=None, out_dtype=None):
    y = conv3d_int8(xq, wq, padding, scale, bias, out_dtype)
    calls.append((xq[:8].clone(), wq, padding, scale, bias, out_dtype, y[:8].clone()))
    return y
quantize.conv3d_int8 = record
sys.argv = ["td-predict", *sys.argv[1:]]
runpy.run_module("timed_design_tpu_torch.cli.predict", run_name="__main__")
print(f"conv3d_int8 launches: {conv3d_int8.launches}")
print(f"sample_inverse_cdf launches: "
      f"{sample_inverse_cdf.launches + sample_inverse_cdf_batched.launches}")
checked, err = chip_smoke.replay_calls(calls, on_cpu=True)
print(f"conv3d_int8 replayed: {len(calls)} calls, {sum(checked.values())} of {len(checked)} "
      f"shapes equal to plain, max_abs_err {err}")
"""

# td-train under torchrun, and a rank of the two-card world of
# check_scale_out (e), whose results go under the directory it is given
SCALE_OUT_RANK = """
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.scale_out_rank(chip_smoke.Path(sys.argv[2]))
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun(nproc: int, target: list, cwd: Path, timeout: int = 600):
    """``python -m torch.distributed.run`` of ``target`` (a script and its
    arguments, or ``-m module ...``) on ``nproc`` ranks of this machine,
    rendezvous on a free local port; the completed process, rc 0 asserted."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node",
         str(nproc), "--master_addr", "127.0.0.1", "--master_port", str(free_port()), *target],
        cwd=cwd, capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return proc


def scale_out_probs(mesh, frames: list, quantize=None, dtype="bfloat16", name="TIMED"):
    """Probabilities of registry ``name`` (random weights from SEED) on
    ``frames``, (device batch of 512, n_valid) pairs, by a Predictor over
    ``mesh`` (None: one card)."""
    import numpy as np
    import torch

    from timed_design_tpu_torch.engine import Predictor
    from timed_design_tpu_torch.models import MODEL_REGISTRY

    torch.manual_seed(SEED)
    module = MODEL_REGISTRY[name].build(compute_dtype=getattr(torch, dtype))
    p = Predictor(module, batch_size=512, device="cuda", quantize=quantize, mesh=mesh)
    return np.concatenate(list(p.predict_stream(frames)))


def mesh_train_steps(mesh, x, y) -> tuple:
    """One float32 train step of registry TIMED (dropout off, TF32 off) from
    the same weights: float64 on the card (the reference), float32 on one
    card, and float32 over ``mesh`` (this rank's rows, BatchNorm over the
    global batch, gradients summed over the data axis)."""
    import copy

    import torch

    from timed_design_tpu_torch.models import MODEL_REGISTRY

    torch.manual_seed(SEED)
    module = MODEL_REGISTRY["TIMED"].build(dropout_rate=0.0)
    witness = copy.deepcopy(module).double()
    witness.compute_dtype = torch.float64
    f64 = one_train_step(witness, "cuda", x.double(), y.double())
    one = one_train_step(copy.deepcopy(module), "cuda", x, y)
    over = one_train_step(copy.deepcopy(module), "cuda", x, y, mesh=mesh)
    return f64, one, over


def mesh_step_errors(f64: dict, one: dict, over: dict, what: str) -> dict:
    """The mesh's step against float64 to the train phase's tolerances
    (STEP_TOL), or 4x the one-card float32 step's own distance to float64
    where that is larger (a bias ahead of a BatchNorm is rounding noise in
    float32 on one card too)."""
    err_one, err = step_errors(one, f64), step_errors(over, f64)
    tol = {k: max(STEP_TOL[k], 4 * err_one[k]) for k in ("loss", "bn")}
    leaf_tol = {k: max(STEP_TOL["grad"], 4 * err_one["grad"][k]) for k in err["grad"]}
    worst = max(err["grad"], key=lambda k: err["grad"][k] / leaf_tol[k])
    direct = step_errors(over, one)
    out = {"loss": err["loss"], "loss_one_card": err_one["loss"], "loss_tol": tol["loss"],
           "bn": err["bn"], "bn_one_card": err_one["bn"], "bn_tol": tol["bn"],
           "grad_nearest_limit": {"leaf": worst, "mesh": err["grad"][worst],
                                  "one_card": err_one["grad"][worst], "tol": leaf_tol[worst]},
           "mesh_against_one_card": {"loss": direct["loss"], "bn": direct["bn"],
                                     "grad_largest": max(direct["grad"].values())}}
    log(f"scale-out {what}: float32 step of registry TIMED against float64 on the card: loss "
        f"rel {err['loss']:.2e} (one card {err_one['loss']:.2e}, limit {tol['loss']:.2e}); "
        f"gradients nearest their limit {worst} {err['grad'][worst]:.2e} (one card "
        f"{err_one['grad'][worst]:.2e}, limit {leaf_tol[worst]:.2e}); running statistics "
        f"{err['bn']:.2e} (one card {err_one['bn']:.2e}); the mesh against one card: loss "
        f"{direct['loss']:.2e}, largest gradient {out['mesh_against_one_card']['grad_largest']:.2e}"
        f", statistics {direct['bn']:.2e}")
    for k in ("loss", "bn"):
        assert err[k] <= tol[k], f"{what}: {k} {err[k]:.3g} from float64 (limit {tol[k]:.3g})"
    bad = sorted(k for k, v in err["grad"].items() if v > leaf_tol[k])
    assert not bad, f"{what}: the gradients of {bad} lie outside their tolerance"
    return out


def scale_out_rank(work: Path) -> None:
    """A rank of the two-card world of check_scale_out (e), launched by
    torchrun: TIMED's float32 and int8 probabilities over the mesh on the
    saved frames and the float32 step on the saved batch; rank 0 saves
    them."""
    import torch
    import torch.distributed as dist

    from timed_design_tpu_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed()
    try:
        mesh = make_mesh()
        saved = torch.load(work / "inputs.pt")
        frames = [(x.cuda(), n) for x, n in saved["frames"]]
        probs = {str(q): scale_out_probs(mesh, frames, q, "float32") for q in (None, "int8")}
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        steps = mesh_train_steps(mesh, saved["x"].cuda(), saved["y"].cuda())
        if mesh.rank == 0:
            torch.save({"probs": probs, "steps": steps, "shape": mesh.shape}, work / "two.pt")
    finally:
        dist.destroy_process_group()


def check_scale_out() -> dict:
    """Scale-out on the card (``parallel/``): a mesh of one process per card
    over NCCL. (a) World size 1 joined in this process
    (``initialize_distributed`` on a local port, left at the end):
    ``Predictor(mesh=make_mesh())`` of registry TIMED and TIMED_rotamer,
    bf16, batch 512, on the 988 frames, equal (``torch.equal``) to the
    single-card Predictor's; ``int8`` over the mesh equal to one card's,
    each of one batch's launches held to the plain version on a CPU copy of
    its first 8 frames; td-predict's engine with and without the mesh
    (frames/s, A B B A) and the voxelization of a batch alone (a rank
    voxelizes its own rows). (c) One float32 train step of registry
    TIMED at batch 256 over the mesh against float64 (mesh_step_errors),
    and one epoch of ``fit`` in bf16 with and without the mesh. (b)
    ``torchrun --nproc_per_node 1`` of td-predict, bf16, with and without
    ``--quantize int8``: every file byte-equal to the plain td-predict
    run's, the int8 launches counted in the child (5 a batch), each held
    to the plain version on a CPU copy of 8 rows there. (d)
    ``torchrun -m timed_design_tpu_torch.cli.train`` for one epoch from an
    HDF5 file of the frames; its checkpoint through td-predict. (e) With two
    cards, the same at two ranks over NCCL against world size 1: float32
    probabilities within 1e-4, int8 equal, the step within (c)'s
    tolerances; with one card, a line says the run was not made. The
    sampling kernel's launches are counted over the phase (in this process
    and td-predict's children) and must be 0."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    import timed_design_tpu_torch.models.quantize as quantize
    from timed_design_tpu_torch.cli.predict import main as predict_main
    from timed_design_tpu_torch.engine import load_dataset_and_predict
    from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8
    from timed_design_tpu_torch.ops.sample import sample_inverse_cdf, sample_inverse_cdf_batched
    from timed_design_tpu_torch.parallel import initialize_distributed, make_mesh
    from timed_design_tpu_torch.voxel import (
        FrameBatchSource,
        create_flat_dataset_map,
        make_frame_dataset,
        make_frame_set,
    )

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix=".chip_smoke_scale_out_", dir=ROOT))
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    out: dict = {}
    int8_launches = {}
    two_cards = torch.cuda.device_count() >= 2
    # scale-out reaches no sampling: its count is read, not assumed
    sample_inverse_cdf.launches = sample_inverse_cdf_batched.launches = 0
    child_sample_launches = 0
    try:
        inputs = work / "in"
        write_structures(inputs)
        fs = make_frame_set(sorted(inputs.glob("*.pdb*")), voxelise_all_states=True)
        dmap = create_flat_dataset_map(fs)
        source = FrameBatchSource(fs, dmap, 512, device="cuda")
        list(source)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = [(X, n) for X, _, n in source]
        torch.cuda.synchronize()
        out["voxelize_ms_per_batch"] = (time.perf_counter() - t0) / len(frames) * 1e3
        assert sum(n for _, n in frames) == 988
        log(f"scale-out: the batch source voxelizes a batch of 512 in "
            f"{out['voxelize_ms_per_batch']:.2f} ms (host clock, synchronized; a rank of n "
            f"voxelizes b/n of it through FrameBatchSource(rows=); fit's source still "
            f"voxelizes the whole batch)")

        assert initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0) == (0, 1)
        try:
            mesh = make_mesh()
            assert dist.get_backend() == "nccl" and mesh.shape == {"data": 1, "model": 1}
            # (a) the Predictor over a world of one
            out["predictor_equal"] = {}
            for name in SCALE_OUT_MODELS:
                one = scale_out_probs(None, frames, name=name)
                over = scale_out_probs(mesh, frames, name=name)
                out["predictor_equal"][name] = bool(torch.equal(torch.from_numpy(over),
                                                                torch.from_numpy(one)))
                assert out["predictor_equal"][name], f"{name}: the mesh's probabilities differ"
            calls = []

            def record(xq, wq, padding=0, scale=None, bias=None, out_dtype=None):
                y = conv3d_int8(xq, wq, padding, scale, bias, out_dtype)
                calls.append((xq[:8], wq, padding, scale, bias, out_dtype, y[:8]))
                return y

            conv3d_int8.launches = 0
            quantize.conv3d_int8 = record
            try:
                int8_over = scale_out_probs(mesh, frames[:1], "int8")
            finally:
                quantize.conv3d_int8 = conv3d_int8
            int8_launches["mesh_predictor"] = conv3d_int8.launches
            assert conv3d_int8.launches == PER_FORWARD, conv3d_int8.launches
            checked, max_err = replay_calls(calls, on_cpu=True)
            calls.clear()
            assert all(checked.values()), checked
            int8_one = scale_out_probs(None, frames[:1], "int8")
            out["int8"] = {"launches": int8_launches["mesh_predictor"],
                           "equal_to_plain": all(checked.values()),
                           "max_abs_err": max_err,
                           "equal_to_one_card": bool(np.array_equal(int8_over, int8_one))}
            assert out["int8"]["equal_to_one_card"], "int8 over the mesh differs from one card"
            log(f"scale-out (a), world size 1 over NCCL: Predictor probabilities of "
                f"{', '.join(SCALE_OUT_MODELS)} (bf16, batch 512, 988 frames) torch.equal to one "
                f"card's; int8 over the mesh {PER_FORWARD} launches on one batch, each equal to "
                f"the plain version on a CPU copy of 8 frames, probabilities equal to one card's")
            fps = []
            # a first, cold run (cuDNN's set-up) is not counted
            for label, m in (("cold", None), ("one card", None), ("mesh", mesh),
                             ("mesh", mesh), ("one card", None)):
                dest = work / f"engine_{len(fps)}"
                dest.mkdir()
                r = load_dataset_and_predict(["TIMED"], fs, batch_size=512, path_to_output=dest,
                                             dataset_map_path=dest / "datasetmap.txt",
                                             device="cuda", compute_dtype=torch.bfloat16,
                                             allow_random_weights=True, mesh=m)
                fps.append((label, 988 / r.timings["predict"]))
            fps = fps[1:]
            out["engine_frames_per_s"] = fps
            log("scale-out: td-predict's engine, TIMED bf16, 988 frames, batch 512, predict "
                "frames/s (A B B A): " + ", ".join(f"{k} {v:.0f}" for k, v in fps)
                + f"; {gpu_name_and_power()}")

            # (c) training over the mesh
            src256 = FrameBatchSource(fs, dmap, 256, device="cuda", shuffle=True, shuffle_seed=0)
            X, y, _ = next(iter(src256))
            x, yt = X[:256], torch.from_numpy(y[:256]).cuda()
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            steps = mesh_train_steps(mesh, x, yt)
            out["train_step"] = mesh_step_errors(*steps, "world size 1")
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
            out["fit_steps_bf16"] = {"one_card": fit_one_epoch(src256, torch.bfloat16),
                                     "mesh": fit_one_epoch(src256, torch.bfloat16, mesh=mesh)}
            if two_cards:
                refs = {str(q): scale_out_probs(mesh, frames, q, "float32") for q in (None, "int8")}
        finally:
            dist.destroy_process_group()

        # (b) td-predict under torchrun, against the plain run
        script = work / "td_predict.py"
        script.write_text(PREDICT_CLI_CHECKED)
        out["torchrun_td_predict"] = {}
        for q in (None, "int8"):
            plain, ran = work / f"plain_{q}", work / f"torchrun_{q}"
            predict_main(td_predict_argv("TIMED", inputs, plain, "bfloat16", q))
            t0 = time.perf_counter()
            proc = torchrun(1, [str(script), *td_predict_argv("TIMED", inputs, ran, "bfloat16", q)],
                            work)
            wall = time.perf_counter() - t0
            launches = int(proc.stdout.rsplit("conv3d_int8 launches: ", 1)[1].split()[0])
            assert launches == (PER_FORWARD * 2 if q else 0), (q, launches)
            child_sample_launches += int(
                proc.stdout.rsplit("sample_inverse_cdf launches: ", 1)[1].split()[0])
            replayed = proc.stdout.rsplit("conv3d_int8 replayed: ", 1)[1].splitlines()[0]
            n_calls, n_equal, n_shapes = (int(replayed.split()[i]) for i in (0, 2, 4))
            replay_err = float(replayed.rsplit("max_abs_err ", 1)[1])
            assert n_calls == launches and n_equal == n_shapes, f"torchrun int8: {replayed}"
            names = sorted(p.name for p in plain.iterdir())
            assert names == sorted(p.name for p in ran.iterdir()), (q, names)
            unequal = [n for n in names if (plain / n).read_bytes() != (ran / n).read_bytes()]
            assert not unequal, f"torchrun td-predict {q}: {unequal} differ from the plain run's"
            n = check_td_predict_outputs(ran, "TIMED", False, True)
            predict_s = float(proc.stdout.split("  predict: ", 1)[1].split("s")[0])
            out["torchrun_td_predict"][str(q)] = {
                "files_byte_equal": len(names), "launches": launches, "wall_s": wall,
                "predict_frames_per_s": n / predict_s, "launches_equal_to_plain": n_calls,
                "max_abs_err": replay_err}
            if q:
                int8_launches["torchrun_td_predict"] = launches
            log(f"scale-out (b): torchrun --nproc_per_node 1 td-predict TIMED bf16 "
                f"{'--quantize ' + q if q else 'unquantized'}: {len(names)} files byte-equal to "
                f"the plain run's, {launches} conv3d_int8 launches, each equal to the plain "
                f"version on a CPU copy of 8 rows, cold process "
                f"{n / predict_s:.0f} frames/s, wall {wall:.1f} s")

        # (d) td-train under torchrun, its checkpoint through td-predict
        h5 = work / "frames.hdf5"
        make_frame_dataset(sorted(inputs.glob("*.pdb*")), h5, voxelise_all_states=True,
                           device="cuda")
        ckpt = work / "torchrun.npz"
        t0 = time.perf_counter()
        proc = torchrun(1, ["-m", "timed_design_tpu_torch.cli.train", "--path_to_dataset",
                            str(h5), "--model", "TIMED", "--epochs", "1", "--batch_size", "256",
                            "--bf16", "--output", str(ckpt)], work)
        train_wall = time.perf_counter() - t0
        assert ckpt.exists() and "Saved checkpoint" in proc.stdout, proc.stdout[-2000:]
        dest = work / "from_checkpoint"
        result = predict_main(td_predict_argv(f"TIMED@{ckpt}", inputs, dest, "bfloat16", None))
        n = check_td_predict_outputs(dest, "TIMED", False, True)
        probs = np.concatenate(list(result.pdb_to_probability.values()))
        assert np.isfinite(probs).all() and np.allclose(probs.sum(1), 1, atol=1e-3)
        out["torchrun_td_train"] = {"wall_s": train_wall, "predicted_frames": n}
        log(f"scale-out (d): torchrun -m timed_design_tpu_torch.cli.train, one epoch of 988 "
            f"frames from HDF5, bf16: rc 0 in {train_wall:.1f} s; its checkpoint through "
            f"td-predict: {n} residues, rows sum to 1")

        # (e) two ranks over NCCL
        if two_cards:
            torch.save({"frames": [(X.cpu(), n) for X, n in frames], "x": x.cpu(),
                        "y": yt.cpu()}, work / "inputs.pt")
            rank = work / "rank.py"
            rank.write_text(SCALE_OUT_RANK)
            torchrun(2, [str(rank), str(ROOT), str(work)], work)
            two = torch.load(work / "two.pt", weights_only=False)
            assert two["shape"] == {"data": 2, "model": 1}
            dp = float(np.abs(two["probs"]["None"] - refs["None"]).max())
            assert dp <= 1e-4, f"two ranks: float32 probabilities {dp:.3g} from world size 1"
            assert np.array_equal(two["probs"]["int8"], refs["int8"]), "two ranks: int8 differs"
            out["two_ranks"] = {"float32_max_abs_dp": dp, "int8_equal": True,
                                "train_step": mesh_step_errors(*two["steps"], "two ranks")}
            log(f"scale-out (e): two ranks over NCCL: float32 probabilities {dp:.2e} from world "
                "size 1, int8 equal, the step within its tolerances")
        else:
            out["two_ranks"] = None
            log(f"scale-out (e): the two-rank run over NCCL was not made: this machine has "
                f"{torch.cuda.device_count()} card, and NCCL takes one rank per card")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        shutil.rmtree(work, ignore_errors=True)
    out["int8_launches"] = int8_launches
    out["launches"] = (sample_inverse_cdf.launches + sample_inverse_cdf_batched.launches
                       + child_sample_launches)
    assert out["launches"] == 0, f"scale-out launched the sampling kernel {out['launches']} times"
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"scale-out: phase {out['phase_s']:.1f} s; {gpu_name_and_power()}")
    return out


# The front-end phase (check_front_end): td-serve and the design app through
# parallel/frontend.py, and the analysis scripts of timed_design_tpu_torch/scripts.
FRONT_END_ARGS = ["--model", "TIMED_rotamer", "--allow-random-weights", "--batch_size", "512",
                  "--port", "0"]
FRONT_END_INT8 = ["--quantize", "int8", "--no-coalesce"]
FRONT_END_ROUNDS = 5  # of A B B A: the one-card server, the front end's twice, one card

# td-serve in a child, under torchrun (argv[2] "torchrun"), with argv[2]
# followers started by the server itself, or as one process ("plain", the
# one-card server): every sampling and int8 launch
# recorded; once the file argv[1] exists the server stops as Ctrl-C stops it,
# and the child prints its launches and holds each recorded call to the
# plain version on a CPU copy
SERVE_CLI_CHECKED = """
import _thread, runpy, sys, threading, time
from pathlib import Path
import torch
import chip_smoke
import timed_design_tpu_torch.models.quantize as quantize
import timed_design_tpu_torch.sample.sampler as sampler
from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8
from timed_design_tpu_torch.ops.sample import sample_inverse_cdf, sample_inverse_cdf_batched
convs, draws = [], []
def record_conv(xq, wq, padding=0, scale=None, bias=None, out_dtype=None):
    y = conv3d_int8(xq, wq, padding, scale, bias, out_dtype)
    convs.append((xq[:8].clone(), wq, padding, scale, bias, out_dtype, y[:8].clone()))
    return y
def record_draw(probs, n, seed, class_map=None):
    codes, counts = sample_inverse_cdf(probs, n, seed, class_map)
    draws.append((probs.cpu(), n, seed, None if class_map is None else class_map.cpu(),
                  codes.cpu(), counts.cpu()))
    return codes, counts
quantize.conv3d_int8, sampler.sample_inverse_cdf = record_conv, record_draw
stop, mode, argv = Path(sys.argv[1]), sys.argv[2], sys.argv[3:]
def watch():
    while not stop.exists():
        time.sleep(0.02)
    _thread.interrupt_main()
threading.Thread(target=watch, daemon=True).start()
if mode == "torchrun":
    sys.argv = ["td-serve", *argv]
    runpy.run_module("timed_design_tpu_torch.cli.serve", run_name="__main__")
else:
    from timed_design_tpu_torch.cli.serve import build_parser, serve
    from timed_design_tpu_torch.parallel.frontend import lead
    args = build_parser().parse_args(argv)
    lead(args.device, lambda front: serve(args, front),
         followers=None if mode == "plain" else int(mode))
print(f"sample_inverse_cdf launches: {sample_inverse_cdf.launches} "
      f"batched {sample_inverse_cdf_batched.launches}")
print(f"conv3d_int8 launches: {conv3d_int8.launches}")
equal = 0
for probs, n, seed, cmap, codes, counts in draws:
    want_codes, want_counts = sample_inverse_cdf(probs, n, seed, cmap)  # the plain version
    equal += bool(torch.equal(codes, want_codes) and torch.equal(counts, want_counts))
print(f"sample_inverse_cdf replayed: {len(draws)} calls, {equal} equal to plain")
checked, err = chip_smoke.replay_calls(convs, on_cpu=True)
print(f"conv3d_int8 replayed: {len(convs)} calls, {sum(checked.values())} of {len(checked)} "
      f"shapes equal to plain, max_abs_err {err}")
"""


class ChildServer:
    """A td-serve child (SERVE_CLI_CHECKED): its output read on a thread,
    its URL once it prints it, stopped through its stop file."""

    def __init__(self, script: Path, mode: str, argv: list, work: Path, name: str):
        self.stop_file = work / f"stop_{name}"
        cmd = [str(script), str(self.stop_file), mode, *argv]
        if mode == "torchrun":
            cmd = ["-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node", "1",
                   "--master_addr", "127.0.0.1", "--master_port", str(free_port()), *cmd]
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, *cmd], cwd=work, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True, start_new_session=True,
                                     env={**os.environ, "PYTHONPATH": str(ROOT)})
        self.lines: list = []
        threading.Thread(target=self._read, daemon=True).start()
        self.url = None
        self.ready_s = None

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)

    @property
    def output(self) -> str:
        return "".join(self.lines)

    def wait_ready(self, timeout: float = 300) -> str:
        deadline = time.perf_counter() + timeout
        while self.url is None:
            for line in list(self.lines):
                if line.startswith("Serving ") and " on http://" in line:
                    self.url = line.split(" on ", 1)[1].split()[0]
                    self.ready_s = time.perf_counter() - self.t0
            assert self.proc.poll() is None or self.url, self.output[-4000:]
            assert time.perf_counter() < deadline, f"no server within {timeout} s"
            time.sleep(0.05)
        return self.url

    def kill(self) -> None:
        """Stop the child and what it started: SIGTERM to its process group,
        which torchrun passes on to its worker (in a session of its own),
        then SIGKILL."""
        import signal

        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGTERM)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()

    def finish(self, timeout: float = 120) -> dict:
        """Stop the server; its launches and replays."""
        self.stop_file.touch()
        self.proc.wait(timeout=timeout)
        out = self.output
        assert "sample_inverse_cdf replayed" in out, out[-4000:]

        def after(key):
            return out.rsplit(key, 1)[1].splitlines()[0]

        draws = after("sample_inverse_cdf replayed: ")
        convs = after("conv3d_int8 replayed: ")
        return {"sample_launches": int(after("sample_inverse_cdf launches: ").split()[0]),
                "sample_batched": int(after("sample_inverse_cdf launches: ").split()[2]),
                "sample_replayed": int(draws.split()[0]),
                "sample_equal": int(draws.split()[2]),
                "int8_launches": int(after("conv3d_int8 launches: ").split()[0]),
                "int8_replayed": int(convs.split()[0]),
                "int8_shapes_equal": int(convs.split()[2]) == int(convs.split()[4]),
                "int8_max_abs_err": float(convs.rsplit("max_abs_err ", 1)[1])}


def post_ok(url: str, payload: dict) -> tuple[dict, float]:
    """``post``, asserting 200 with the server's error in the message."""
    try:
        status, body, dt = post(url, payload)
    except urllib.error.HTTPError as e:
        raise AssertionError(f"{url}: HTTP {e.code}: {e.read()[:2000]!r}") from None
    assert status == 200, body
    return body, dt


def af2_outputs(dest: Path) -> Path:
    """An AlphaFold2 output folder for 1ubq: a refold moved by 25 A in x,
    one cut to 50 residues and an unranked file; returns the reference."""
    text = gzip.decompress(UBQ.read_bytes()).decode()
    job = dest / "af2" / "job_0"
    job.mkdir(parents=True)
    moved, cut = [], []
    for line in text.splitlines():
        if line.startswith(("ATOM", "HETATM")):
            x = float(line[30:38]) + 25.0
            moved.append(f"{line[:30]}{x:8.3f}{line[38:]}")
            if int(line[22:26]) <= 50:
                cut.append(line)
        else:
            moved.append(line)
    (job / "designA_rank_001_model_1.pdb").write_text("\n".join(moved) + "\n")
    (job / "designB_rank_001_model_1.pdb").write_text("\n".join(cut) + "\nEND\n")
    (job / "not_ranked.pdb").write_text(text)
    ref = dest / "1ubq.pdb"
    ref.write_text(text)
    return ref


def script_run(name: str, args: list, cwd: Path, device: str = "cuda") -> subprocess.Popen:
    """``python -m timed_design_tpu_torch.scripts.<name> ... --device``,
    started; its output on a pipe."""
    cwd.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [sys.executable, "-m", f"timed_design_tpu_torch.scripts.{name}", *map(str, args),
         "--device", device], cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": str(ROOT)})


def finished(proc: subprocess.Popen, t0: float, timeout: float = 300) -> tuple[str, float]:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-2000:] + err[-4000:]
    return out, time.perf_counter() - t0


def tree_bytes(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def front_end_split(front, session, reps: int = 20) -> dict:
    """Median ms of the front end's own work on a padded batch of
    ``session``'s predictor: the header over gloo (host clock), the scatter of the
    batch over the data group and the forward of one rank's rows alone, and
    the front end's whole forward (CUDA events on the stream, each after a
    synchronize)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from timed_design_tpu_torch.engine import Predictor
    from timed_design_tpu_torch.parallel.frontend import BEAT, _wire

    predictor = session.predictor
    x = torch.zeros((predictor.batch_size, 21, 21, 21, len(session.codec.channels)),
                    dtype=predictor.dtype, device="cuda")
    n = front.mesh.shape["data"]
    mine = torch.empty_like(x[: x.shape[0] // n])

    def header():
        with front.lock:
            front._header(BEAT)

    def scatter():
        dist.scatter(_wire(mine), [_wire(p) for p in x.chunk(n)], src=front.mesh.ranks[0],
                     group=front.mesh.data_group)

    def alone():
        Predictor.fetch(Predictor.run_device_batch(predictor, mine), 0)

    def whole():
        Predictor.fetch(predictor.run_device_batch(x), 0)

    out = {}
    for name, fn in (("header", header), ("scatter", scatter), ("forward_alone", alone),
                     ("front_end_forward", whole)):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append((start.elapsed_time(end), (time.perf_counter() - t0) * 1e3))
        out[name] = {"device_ms": float(np.median([t[0] for t in times])),
                     "host_ms": float(np.median([t[1] for t in times]))}
    return out


def check_front_end() -> dict:
    """td-serve and the design app through the rank-0 front end
    (``parallel/frontend.py``) on the card, world size 1 over NCCL, at
    full TIMED_rotamer width (random weights from a seed, bf16, batch 512),
    and the four analysis scripts (``timed_design_tpu_torch/scripts``).
    (a) ``torchrun --nproc_per_node 1 -m timed_design_tpu_torch.cli.serve``:
    /design of 1ubq with 100 samples at T 0.2 gives the probabilities and
    samples of the in-process one-card server, byte for byte; one sampling
    launch a request, counted in the child and each held to the plain
    version there; /design latency A B B A against the one-card server, and
    the child's start until it serves. (b) The same with ``--quantize int8
    --no-coalesce``, against the one-card int8 server: 5 int8 launches a
    request, each replayed against the plain version in the child. (c)
    td-serve with no launcher through ``start_followers`` with 0 followers,
    equal to (a). (d) The design app through ``shared_front_end`` (a world
    of one): the page's design of 1ubq with TIMED_rotamer.h5 equal to one
    card's DesignSession, its Monte-Carlo launch equal to the plain version.
    (e) The scripts as ``python -m`` on the card and with ``--device cpu``:
    run_benchmark_models (TIMED.h5 from the port's exporter, over an
    ``.hdf5`` that td-voxelize makes of tests/testing_files), run_sampling
    on its output (5 batched launches, each held to the plain version),
    make_af2_jobs on a fasta of its samples, analyse_af2_results; outputs
    equal to the CPU's (argmax agreement >= 0.99 where a float argmax
    decides; the sampled fastas too)."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    import timed_design_tpu_torch.parallel.frontend as frontend
    import timed_design_tpu_torch.sample.sampler as sampler
    from timed_design_tpu_torch.cli import voxelize
    from timed_design_tpu_torch.cli.serve import build_designers, build_parser, make_server
    from timed_design_tpu_torch.engine import DesignSession
    from timed_design_tpu_torch.ops.sample import sample_inverse_cdf, sample_inverse_cdf_batched
    from timed_design_tpu_torch.scripts import run_sampling
    from timed_design_tpu_torch.structure import load_pdb

    t_phase = time.perf_counter()
    # the children share the card with this process: hand back what the
    # earlier phases left in its allocator's cache
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix=".chip_smoke_front_end_", dir=ROOT))
    script = work / "serve.py"
    script.write_text(SERVE_CLI_CHECKED)
    out: dict = {}
    launches = {"sample": {}, "int8": {}}
    children = {"a": ChildServer(script, "torchrun", FRONT_END_ARGS, work, "a"),
                "b": ChildServer(script, "torchrun", FRONT_END_ARGS + FRONT_END_INT8, work, "b"),
                "c": ChildServer(script, "0", FRONT_END_ARGS, work, "c"),
                "p": ChildServer(script, "plain", FRONT_END_ARGS, work, "p")}
    servers, designers = [], []
    pdb = gzip.decompress(UBQ.read_bytes()).decode()
    req = {"pdb": pdb, "n_samples": 100, "temperature": 0.2, "seed": 7}
    urls: dict = {}

    def one_card(key: str, extra: list) -> None:
        """A one-card server in this process, warmed (cuDNN's set-up)."""
        ds = build_designers(build_parser().parse_args(FRONT_END_ARGS + extra))
        server = make_server(ds["TIMED_rotamer"], "127.0.0.1", 0, "TIMED_rotamer")
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)
        designers.extend(ds.values())
        urls[key] = f"http://127.0.0.1:{server.server_address[1]}"
        post_ok(urls[key] + "/design", req)

    def close_servers() -> None:
        for server in servers:
            server.shutdown()
            server.server_close()
        for d in designers:
            d.close()
        servers.clear()
        designers.clear()

    results: dict = {}
    try:
        # (b) int8 first, and its child stopped before the others run: six
        # servers at their peak do not fit the card's memory together
        one_card("one_int8", FRONT_END_INT8)
        for key, child in children.items():
            urls[key] = child.wait_ready()
        out["ready_s"] = {k: c.ready_s for k, c in children.items()}
        got = [post_ok(urls["b"] + "/design", req)[0] for _ in range(2)]
        ref_body = post_ok(urls["one_int8"] + "/design", req)[0]
        for body in got:
            assert body["probabilities"] == ref_body["probabilities"], "(b) differs"
            assert body["samples"] == ref_body["samples"], "(b): samples differ"
        results["b"] = children["b"].finish()
        close_servers()
        torch.cuda.empty_cache()

        # (a), (c) A B B A: the in-process one-card server against torchrun's
        # front end, and a one-card server in a child against the front end
        # in a child with no launcher (the same kind of process)
        one_card("one", [])
        bodies: dict = {k: [] for k in ("one", "a", "p", "c")}
        latency: dict = {k: [] for k in ("one", "a", "p", "c")}
        for _ in range(FRONT_END_ROUNDS):
            for key in ("one", "a", "a", "one", "p", "c", "c", "p"):
                body, dt = post_ok(urls[key] + "/design", req)
                bodies[key].append(body)
                latency[key].append(dt)
        want = bodies["one"][0]
        for body in [b for v in bodies.values() for b in v]:
            assert body["probabilities"] == want["probabilities"], "(a), (c): probabilities differ"
            assert body["samples"] == want["samples"], "(a), (c): samples differ"
        requests = {"a": 2 * FRONT_END_ROUNDS, "b": 2, "c": 2 * FRONT_END_ROUNDS,
                    "p": 2 * FRONT_END_ROUNDS}
        for key, child in children.items():
            r = results[key] if key in results else child.finish()
            assert r["sample_launches"] == r["sample_replayed"] == requests[key], (key, r)
            assert r["sample_equal"] == r["sample_replayed"] and r["sample_batched"] == 0, r
            assert r["int8_launches"] == r["int8_replayed"] == (
                PER_FORWARD * requests[key] if key == "b" else 0), (key, r)
            assert r["int8_shapes_equal"], (key, r)
            launches["sample"][key] = r["sample_launches"]
            launches["int8"][key] = r["int8_launches"]
            out[key] = r
        med = {k: float(np.median(v)) for k, v in latency.items()}
        out["design_latency_s"] = latency
        out["design_median_s"] = med
        log(f"front end (a)-(c): torchrun td-serve TIMED_rotamer bf16 (world size 1 over NCCL) "
            f"ready in {out['ready_s']['a']:.1f} s (int8 {out['ready_s']['b']:.1f} s, no "
            f"launcher {out['ready_s']['c']:.1f} s, one card in a child "
            f"{out['ready_s']['p']:.1f} s, started together); /design 1ubq n=100 median "
            f"{med['a'] * 1e3:.2f} ms through torchrun's front end against "
            f"{med['one'] * 1e3:.2f} ms on one card in this process; the front end with no "
            f"launcher {med['c'] * 1e3:.2f} ms against one card in a child "
            f"{med['p'] * 1e3:.2f} ms ({FRONT_END_ROUNDS} rounds A B B A each); "
            f"probabilities and samples byte-equal to one card's; launches counted in the "
            f"children, each equal to the plain version: sampling {launches['sample']}, "
            f"int8 {launches['int8']}; {gpu_name_and_power()}")
    except BaseException:
        for key, child in children.items():
            log(f"front end: the output of child ({key}):\n{child.output[-3000:]}")
        raise
    finally:
        close_servers()
        for child in children.values():
            child.kill()

    bench: dict = {}
    try:
        # (e) started now, beside (d): the scripts' inputs, run_benchmark_models
        models = work / "models"
        models.mkdir()
        keras_release("TIMED", models)
        h5, _ = voxelize.main([str(ROOT / "tests" / "testing_files"), "-e", ".pdb1.gz", "-n",
                               "data", "-o", str(work)])
        t_bench = time.perf_counter()
        bench = {dev: script_run("run_benchmark_models", [h5, work / f"bench_{dev}", "--models-dir",
                                                      models], work, dev)
                 for dev in ("cuda", "cpu")}

        # (d) the design app through the front end, a world of one
        keras_release("TIMED_rotamer", models)
        saved_streamlit = sys.modules.get("streamlit")
        sys.modules["streamlit"] = PageRecorder()
        import timed_design_tpu_torch.ui as ui

        draws = []
        real_sample = sampler.sample_inverse_cdf

        def recording(probs, n, seed, class_map=None):
            codes, counts = real_sample(probs, n, seed, class_map)
            draws.append((probs.cpu(), n, seed, None if class_map is None else class_map.cpu(),
                          codes.cpu(), counts.cpu()))
            return codes, counts

        # the app's phase (check_ui) kept the one-card answer of this process
        # (no front end); a world of one is asked for here
        frontend._SHARED.pop("cuda", None)
        front = frontend.shared_front_end("cuda", followers=0)
        sampler.sample_inverse_cdf = recording
        try:
            assert front.n_ranks == 1 and frontend.shared_front_end("cuda") is front
            responses = {UI_UPLOAD: PageUpload(UBQ), "Choose your Model": "TIMED_rotamer",
                         "Design!": True, "Optimize sequences using Monte Carlo": True,
                         "Number of samples": 200, "Temperature": 0.2}
            rec = PageRecorder(responses)
            ui.st = rec
            sample_inverse_cdf.launches = 0
            t0 = time.perf_counter()
            ui.main(["--path_to_models", str(models)])
            page_s = time.perf_counter() - t0
            launches["sample"]["d"] = sample_inverse_cdf.launches
            session = rec.session_state[f"session::{models / 'TIMED_rotamer.h5'}"]
            assert session.predictor.mesh is front.mesh
            out["split_ms"] = front_end_split(front, session)
        finally:
            sampler.sample_inverse_cdf = real_sample
            frontend._SHARED.pop("cuda").close()
            if saved_streamlit is None:
                sys.modules.pop("streamlit", None)
            else:
                sys.modules["streamlit"] = saved_streamlit
        ui_figures_in_place(rec, rotamer=True)
        ((probs,), _, _), = rec.session_state["design_cache"].values()
        direct = DesignSession(str(models / "TIMED_rotamer.h5"), codec="CNOCACB",
                               batch_size=512, device="cuda")
        want = direct.design(load_pdb(UBQ))[0].astype(np.float32)
        assert probs.shape == (76, 338) and np.array_equal(probs, want), \
            float(np.abs(probs - want).max())
        assert launches["sample"]["d"] == len(draws) == 1
        p, n, seed, cmap, codes, counts = draws[0]
        want_codes, want_counts = sample_inverse_cdf(p, n, seed, cmap)  # the plain version
        assert torch.equal(codes, want_codes) and torch.equal(counts, want_counts)
        out["d"] = {"page_s": page_s, "equal_to_one_card": True}
        log("front end (d): what the front end adds to a forward at world size 1, batch of 512 "
            "bf16 frames, median ms: " + json.dumps(out["split_ms"]))
        log(f"front end (d): the design app through shared_front_end (world size 1 over NCCL): "
            f"1ubq page with TIMED_rotamer.h5 and 200 samples in {page_s * 1e3:.1f} ms (cold), "
            f"the design equal to one card's DesignSession, 1 sampling launch equal to the "
            f"plain version")

        # (e) the scripts: run_benchmark_models
        runs = {dev: finished(proc, t_bench) for dev, proc in bench.items()}
        walls = {"run_benchmark_models": runs["cuda"][1],
                 "run_benchmark_models_cpu": runs["cpu"][1]}
        got, want = (json.loads("{" + runs[d][0].partition("{")[2]) for d in ("cuda", "cpu"))
        assert list(got) == list(want) == [str(models / "TIMED.h5")], (got, want)
        tag = work / "bench_cuda" / "TIMED", work / "bench_cpu" / "TIMED"
        for name in ("datasetmap.txt", "dataset.fasta", "encoded_labels.csv"):
            assert (tag[0] / name).read_bytes() == (tag[1] / name).read_bytes(), name
        rows = [np.loadtxt(t / "TIMED.csv", delimiter=",") for t in tag]
        agree = float((rows[0].argmax(1) == rows[1].argmax(1)).mean())
        assert rows[0].shape == (76, 20) and agree >= 0.99, agree
        for key in ("accuracy_1", "accuracy_3", "precision", "recall"):
            assert abs(got[str(models / "TIMED.h5")][key] - want[str(models / "TIMED.h5")][key]) \
                <= 1 - agree + 1e-9, key

        # run_sampling: in this process on the card (its launches counted
        # and replayed), as a subprocess on the CPU
        samp_cpu = script_run("run_sampling", [tag[0] / "TIMED.csv", tag[0] / "TIMED.txt", 50],
                          work / "sampling_cpu", "cpu")
        batched = []
        real_batched = sampler.sample_inverse_cdf_batched

        def recording_batched(packed, offsets, n, seed, class_map=None):
            codes, counts = real_batched(packed, offsets, n, seed, class_map)
            batched.append((packed.cpu(), offsets.cpu() if torch.is_tensor(offsets)
                            else offsets, n, seed,
                            None if class_map is None else class_map.cpu(), codes.cpu(),
                            counts.cpu()))
            return codes, counts

        (work / "sampling_cuda").mkdir()
        sampler.sample_inverse_cdf_batched = recording_batched
        sample_inverse_cdf_batched.launches = 0
        cwd, printed = os.getcwd(), io.StringIO()
        try:
            os.chdir(work / "sampling_cuda")
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                run_sampling.main([str(tag[0] / "TIMED.csv"), str(tag[0] / "TIMED.txt"), "50"])
            walls["run_sampling"] = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
            sampler.sample_inverse_cdf_batched = real_batched
        launches["sample"]["e"] = sample_inverse_cdf_batched.launches
        assert launches["sample"]["e"] == len(batched) == 5, launches["sample"]["e"]
        for packed, offsets, n, seed, cmap, codes, counts in batched:
            want_codes, want_counts = sample_inverse_cdf_batched(packed, offsets, n, seed, cmap)
            assert torch.equal(codes, want_codes) and torch.equal(counts, want_counts)
        cpu_printed, walls["run_sampling_cpu"] = finished(samp_cpu, time.perf_counter())
        assert printed.getvalue() == cpu_printed, (printed.getvalue(), cpu_printed)
        fastas = sorted((work / "sampling_cuda").glob("*.fasta"))
        assert len(fastas) == 5
        seqs = [[line for line in (d / f.name).read_text().splitlines()
                 if not line.startswith(">")] for f in fastas
                for d in (work / "sampling_cuda", work / "sampling_cpu")]
        pairs = list(zip(seqs[0::2], seqs[1::2]))
        same = sum(a == b for x, y in pairs for a, b in zip(x, y, strict=True))
        sample_agree = same / sum(len(x) for x, _ in pairs)
        assert sample_agree >= 0.99, sample_agree

        # make_af2_jobs on the samples at T 0.1, analyse_af2_results
        ref = af2_outputs(work)
        t0 = time.perf_counter()
        jobs = {dev: script_run("make_af2_jobs", [fastas[0], "jobs"], work / f"af2jobs_{dev}", dev)
                for dev in ("cuda", "cpu")}
        scores = {dev: script_run("analyse_af2_results", [ref, work / "af2"],
                              work / f"af2scores_{dev}", dev) for dev in ("cuda", "cpu")}
        jobs_out = {dev: finished(p, t0) for dev, p in jobs.items()}
        scores_out = {dev: finished(p, t0) for dev, p in scores.items()}
        walls["make_af2_jobs"], walls["analyse_af2_results"] = (
            jobs_out["cuda"][1], scores_out["cuda"][1])
        assert jobs_out["cuda"][0] == jobs_out["cpu"][0] and "sbatch " in jobs_out["cpu"][0]
        assert tree_bytes(work / "af2jobs_cuda") == tree_bytes(work / "af2jobs_cpu")
        lines = scores_out["cuda"][0].splitlines()
        assert lines == scores_out["cpu"][0].splitlines() and len(lines) == 3, lines
        out["e"] = {"walls_s": walls, "benchmark_argmax_agreement": agree,
                    "sampling_agreement": sample_agree, "af2_lines": lines}
        log(f"front end (e): the scripts as python -m on the card (and --device cpu, started "
            f"together): run_benchmark_models of TIMED.h5 over 76 frames {walls['run_benchmark_models']:.1f} s "
            f"(cpu {walls['run_benchmark_models_cpu']:.1f} s; maps and fastas byte-equal, argmax "
            f"agreement {agree:.4f}); run_sampling in-process {walls['run_sampling']:.2f} s, "
            f"5 batched launches each equal to the plain version, the sampled residues "
            f"{sample_agree:.4f} equal to the cpu's; make_af2_jobs and analyse_af2_results "
            f"outputs equal ({walls['make_af2_jobs']:.1f}, {walls['analyse_af2_results']:.1f} s "
            f"of wall, started together); {gpu_name_and_power()}")
    finally:
        for proc in list(bench.values()):
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(work, ignore_errors=True)
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"front end: phase {out['phase_s']:.1f} s; {gpu_name_and_power()}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 1
    import timed_design_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, GPU: {gpu_name_and_power()}")
    from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8

    build_kernels(["sample_inverse_cdf", "conv3d_int8", "dense_block"])
    conv3d_int8.launches = 0
    kernel = check_sampling_kernel()
    batched = check_batched_kernel()
    check_reference("TIMED_rotamer", 338)
    serving = check_serving()
    td_sample = check_td_sample()
    families = check_families()
    td_predict = check_td_predict()
    analyse = check_analyse()
    properties = check_properties()
    train = check_train()
    assert conv3d_int8.launches == 0, "an unquantized path launched the int8 kernel"
    dense = check_dense_block()  # its int8 forward launches the int8 kernel
    quantize = check_quantize()
    flat_bf16 = ROOT / f".chip_smoke_keras_flat_bf16_{os.getpid()}.hdf5"
    hdf5 = check_hdf5(keep_flat_bf16=flat_bf16)
    keras = check_keras(flat_bf16)
    ui = check_ui()
    scale_out = check_scale_out()
    front_end = check_front_end()
    log(json.dumps({"families": families["per_family"], "td_sample": td_sample,
                    "td_predict": td_predict, "analyse": analyse, "properties": properties,
                    "train": train, "quantize": quantize, "hdf5": hdf5, "keras": keras,
                    "ui": ui, "scale_out": scale_out, "front_end": front_end}))
    main_shape = kernel["shapes"][0]
    # TIMED's 64 -> 128 block: the largest of its int8 convolutions
    conv_main = quantize["kernel"]["per_shape"][3]
    # td-predict, training and the HDF5 flow reach no TPU kernel (voxelizer
    # and convs are plain torch); the analysis reaches the sampler through its
    # sweep, property-constrained design, the Keras phase's /design and the
    # design app's Monte-Carlo tab through each design's samples; scale-out
    # reaches the int8 kernel only, under --quantize int8; the front end
    # reaches both, each launch of its children counted there
    launches = {"serve": serving["launches"], "td_sample": td_sample["launches"],
                "families": families["launches"], "td_predict": td_predict["launches"],
                "analyse": analyse["launches"], "properties": properties["launches"],
                "train": train["launches"], "hdf5": hdf5["launches"], "keras": keras["launches"],
                "ui": ui["launches"], "scale_out": scale_out["launches"],
                "front_end": sum(front_end["launches"]["sample"].values())}
    int8_launches = {**quantize["launches"], "hdf5": hdf5["int8_launches"],
                     "keras": keras["int8_launches"],
                     "scale_out": sum(scale_out["int8_launches"].values()),
                     "front_end": sum(front_end["launches"]["int8"].values())}
    print(json.dumps({"kernels": [{
        "name": "sample_inverse_cdf",
        "route": "cuda",
        "source": "timed_design_tpu_torch/csrc/sample_inverse_cdf.cu",
        "replaces": "timed_design_tpu/ops/pallas_sample.py:88",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(kernel["max_abs_err"], batched["max_abs_err"],
                           properties["large_c"]["max_abs_err"]),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "shape": [main_shape["L"], main_shape["C"], main_shape["n"]],
        "equal_to_plain": all(s["equal_to_plain"]
                              for s in kernel["shapes"] + properties["large_c"]["shapes"]),
        "per_shape": kernel["shapes"] + properties["large_c"]["shapes"],
        "max_classes": properties["large_c"]["limit"],
        "batched": batched,
    }, {
        "name": "conv3d_int8",
        "route": "cuda",
        "source": "timed_design_tpu_torch/csrc/conv3d_int8.cu",
        # no Pallas kernel: the counterpart of XLA's int8 conv_general_dilated
        "replaces": "timed_design_tpu/models/quantize.py:125",
        "launches": sum(int8_launches.values()),
        "launches_by_path": int8_launches,
        "max_abs_err": max(quantize["kernel"]["max_abs_err"], scale_out["int8"]["max_abs_err"],
                           *(r["max_abs_err"] for r in scale_out["torchrun_td_predict"].values()),
                           front_end["b"]["int8_max_abs_err"]),
        "ms": conv_main["ms"],
        "plain_ms": conv_main["plain_ms"],
        "bound_ms": conv_main["bound_ms"],
        "bound_by": conv_main["bound_by"],
        # one float64 F.conv3d of the codes: the same int32 sums
        "library_ms": conv_main["library_ms"],
        "cudnn_bf16_ms": conv_main["cudnn_bf16_ms"],
        "shape": [conv_main["batch"], 21, conv_main["cin"], conv_main["cout"], conv_main["k"]],
        "shapes_equal_to_plain": quantize["kernel"]["shapes_checked"],
        "per_shape": quantize["kernel"]["per_shape"],
    }, {
        "name": "dense_block",
        "route": "cuda",
        "source": "timed_design_tpu_torch/csrc/dense_block.cu",
        # no TPU kernel: the JAX package leaves these passes to XLA
        "replaces": None,
        "launches_by_path": {
            "td_predict_densecpd_bf16": td_predict["per_model"]["DenseCPD"][
                "dense_block_launches"],
            "serve_design": families["dense_block_launches"],
            "module_forward": dense["launches_a_forward"]},
        "equal_to_plain": True,
        "per_shape": dense["kernels"],
        "forward_ms": dense["forward_ms"],
    }]}), flush=True)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
