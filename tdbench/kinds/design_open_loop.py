"""``/design`` of ``td-serve`` under open-loop Poisson load.

The server is the port's own (``cli/serve.py::make_server``) over a
coalescing designer (``engine/coalescer.py``) of the configuration's model
in its compute dtype, batch ``batch_inference``, on a loopback port of
this process. The client is ``tdbench/loadgen.py`` in a child process.
Request i is due at the i-th arrival of a Poisson process of ``rate``
designs a second (the gaps, and the lengths drawn from a log-normal law of
``median_length`` and ``sigma`` clipped to [``min_length``,
``max_length``], are the same multiset for every seed, in an order drawn
from the seed). Its body is ``{"pdb", "n_samples", "temperature", "seed"}``,
the PDB text of that many residues of noisy ubiquitin chains. Every
request due in the window is timed from its due time to the last byte of
its response, and the run waits up to ``drain_s`` past the window for the
last of them.

Correctness: ``check_requests`` of the answered requests, drawn from the
seed with the longest among them, against the reference: the served
20-class probabilities and designed sequence, and each of the
``n_samples`` sampled sequences against the reference's draws from its own
tempered probabilities with the same uniforms (the request's seed keys
Philox4x32-10; counter (position, sample, 0, 0))."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

from .. import compare, loadgen, peaks, structures
from ..harness import ROOT, DeviceTrace
from ..reference import model as ref_model
from . import Outcome, Run, free, peak_bytes, program_model, sync

# the latency a failed request counts as: longer than any run lasts
FAILED_S = 1e6


def plan(run: Run, port: int) -> dict:
    t = run.cell.traffic
    rng = np.random.default_rng(run.seed)
    n = max(1, int(round(t["rate"] * run.seconds)))
    gaps = structures.exponential_gaps(rng, n, t["rate"])
    lengths = structures.lognormal_lengths(rng, n, t["median_length"], t["sigma"],
                                           t["min_length"], t["max_length"])
    at = np.cumsum(gaps) - gaps[0]
    seeds = rng.integers(0, 2 ** 32, n)
    longest = int(np.argmax(lengths))
    others = rng.choice(np.delete(np.arange(n), longest), min(n - 1, t["check_requests"] - 1),
                        replace=False)
    return {"host": "127.0.0.1", "port": port, "seed": run.seed, "noise": t["noise"],
            "spacing": t["spacing"], "n_samples": t["n_samples"],
            "temperature": t["temperature"], "timeout_s": t["drain_s"] + run.seconds,
            "max_in_flight": t["max_in_flight"], "at": at.tolist(),
            "lengths": lengths.tolist(), "request_seeds": seeds.tolist(),
            "keep": sorted([longest, *others.tolist()])}


def _warm_up(port: int, t: dict, seed: int) -> None:
    """Rounds of concurrent requests at the traffic's sizes, so that every
    group size the coalescer packs and the sampling kernel are ready."""
    rng = np.random.default_rng([seed, 3])
    chain = structures.chain_atoms()
    lengths = [t["min_length"], t["median_length"], t["max_length"]]
    for round_ in range(t["warmup_rounds"]):
        bodies = [json.dumps({"pdb": structures.backbone_text(
            rng, int(lengths[(round_ + i) % 3]), t["noise"], t["spacing"], chain),
            "n_samples": t["n_samples"], "temperature": t["temperature"],
            "seed": i}).encode() for i in range(t["warmup_concurrency"])]
        threads = [threading.Thread(target=loadgen.send, args=("127.0.0.1", port, b, 600))
                   for b in bodies]
        for th in threads:
            th.start()
        for th in threads:
            th.join()


def run(run: Run) -> Outcome:
    from timed_design_tpu_torch.cli.serve import make_server
    from timed_design_tpu_torch.engine import DesignSession
    from timed_design_tpu_torch.engine.coalescer import CoalescingDesigner

    cfg, t = run.cell.config, run.cell.traffic
    module, weights = program_model(cfg, run.seed, run.device)
    session = DesignSession(module, codec=cfg["codec"], batch_size=cfg["batch_inference"],
                            device=run.device, compute_dtype=cfg["compute_dtype"],
                            quantize=run.quantize)
    designer = CoalescingDesigner(session)
    server = make_server(designer, "127.0.0.1", 0, cfg["model"])
    serving = threading.Thread(target=server.serve_forever, name="server", daemon=True)
    serving.start()
    port = server.server_address[1]
    p = plan(run, port)
    plan_path, results_path = run.work / "plan.json", run.work / "results.json"
    plan_path.write_text(json.dumps(p))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    child = subprocess.Popen([sys.executable, "-m", "tdbench.loadgen", str(plan_path),
                              str(results_path)], cwd=ROOT, env=env, text=True,
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    try:
        _warm_up(port, t, run.seed)
        sync(run.device)
        if child.stdout.readline().strip() != "ready":
            raise RuntimeError("the load generator did not start")
        setup_s = run.setup_clock()
        with DeviceTrace(run.trace, run.device) as trace:
            start = time.monotonic()
            child.stdin.write(f"go {start!r}\n")
            child.stdin.flush()
            child.wait(timeout=run.seconds + t["drain_s"] + 60)
        if child.returncode != 0:
            raise RuntimeError(f"the load generator exited with {child.returncode}")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        server.shutdown()
        server.server_close()
        designer.close()
    results = json.loads(results_path.read_text())
    memory = peak_bytes(run.device)
    del module, session, designer
    free(run.device)

    ok = [r for r in results if r["status"] == 200]
    latencies = sorted(r["latency"] for r in ok)
    failed = len(results) - len(ok)
    kept = [(i, r["response"]) for i, r in enumerate(results) if "response" in r]
    readings = _compare(run, p, kept, weights)
    readings["failed_requests"] = failed
    rot = cfg["n_classes"]
    record = {
        "kind": "design", "window_s": trace.window_s, "requests": results,
        "flop_per_frame": peaks.forward_flop_per_frame(cfg), "config": cfg,
        "sample_least_s": sum(peaks.sample_least_s(r["n_residues"], rot, t["n_samples"])
                              for r in ok),
        "frames": sum(r["n_residues"] for r in ok), "kernels": trace.kernel_seconds(),
        "busy_s": trace.summary()["busy_s"] if run.trace else None,
    }
    by_length = {}
    for r in ok:
        by_length.setdefault(min(r["n_residues"] // 100, 5), []).append(r["latency"])
    print("latency ms: " + ", ".join(f"p{q} {_percentile(latencies, q) * 1e3:.1f}"
                                     for q in (50, 90, 95, 99, 100)) + "; median by length: " +
          ", ".join(f"{k * 100}+ {1e3 * _percentile(sorted(v), 50):.1f} ({len(v)})"
                    for k, v in sorted(by_length.items())), file=sys.stderr)
    # a request that failed is missing every latency limit: it counts as
    # slower than all others in the percentiles
    slow = latencies + [FAILED_S] * failed
    end_to_end = {"design_p50_ms": _percentile(slow, 50) * 1e3,
                  "design_p95_ms": _percentile(slow, 95) * 1e3, "setup_s": setup_s}
    return Outcome(end_to_end=end_to_end, record=record,
                   checks=compare.checks(readings, run.cell.limits), attempted=len(results),
                   failed=failed, memory_peak_bytes=memory, trace=trace, readings=readings)


def _percentile(sorted_values: list, pct: float) -> float:
    """The ``pct`` percentile of all values (linear between order
    statistics, as ``statistics.quantiles`` with the inclusive method)."""
    if not sorted_values:
        return float("nan")
    x = (len(sorted_values) - 1) * pct / 100
    lo = int(x)
    hi = min(lo + 1, len(sorted_values) - 1)
    a, b = sorted_values[lo], sorted_values[hi]
    return a if a == b else a + (b - a) * (x - lo)


def _compare(run: Run, p: dict, kept: list, weights: dict) -> dict:
    """The kept responses against the reference: ``prob_err``, ``kl``,
    ``logit_err`` and ``argmax_gap`` of the served 20-class rows and
    designed sequence; ``sample_mismatch``, the share of sampled residues
    that differ from the reference's draw with the same uniform, and
    ``sample_gap``, the widest distance (in probability) by which a
    uniform lies outside the reference's CDF block of the residue served
    for it."""
    import torch

    t = run.cell.traffic
    chain = structures.chain_atoms()
    got, want, served, mismatched, drawn, widest = [], [], [], 0, 0, 0.0
    for i, resp in kept:
        text = loadgen.request_text(p["seed"], i, p["lengths"][i], p["noise"], p["spacing"],
                                    chain)
        keys = [("q", r[0], r[1:]) for r in resp["residues"]]
        p338 = compare.reference_probs({"q": text}, keys, weights, run.device)
        p20 = ref_model.compress(torch.from_numpy(p338)).numpy()
        got.append(np.asarray(resp["probabilities"]))
        want.append(p20)
        served.append(np.array([ref_model.AA1.index(a) for a in resp["sequence"]]))
        tempered = ref_model.tempered(torch.from_numpy(p338).float(), t["temperature"])
        u = ref_model.philox_uniforms(int(resp["seed"]), t["n_samples"], len(keys))
        classes = ref_model.inverse_cdf_draws(tempered, u)
        letters = np.array(list(ref_model.AA1))[ref_model.ROTAMER_TO_AA[classes]]
        samples = np.array([list(s["sequence"]) for s in resp["samples"]])
        if samples.shape != letters.shape:
            mismatched += letters.size
            widest = max(widest, 1.0)
        else:
            mismatched += int((samples != letters).sum())
            # each amino acid's rotamers are one block of the CDF: how far
            # each uniform lies outside the block of the residue served
            p20 = ref_model.compress(tempered.double()).numpy()
            hi = np.cumsum(p20, 1)
            served_aa = np.vectorize(ref_model.AA1.index)(samples)
            rows = np.arange(len(keys))[None, :]
            lo_s, hi_s = (hi - p20)[rows, served_aa], hi[rows, served_aa]
            widest = max(widest, float(np.maximum(np.maximum(lo_s - u, u - hi_s), 0).max()))
        drawn += letters.size
    if not kept:
        return {}
    readings = compare.answer_gaps(np.concatenate(got), np.concatenate(want))
    rows = np.concatenate(want)
    best = np.log(rows.max(1) + 1e-30)
    chosen = np.log(rows[np.arange(len(rows)), np.concatenate(served)] + 1e-30)
    readings["argmax_gap"] = float((best - chosen).max())
    readings["sample_mismatch"] = mismatched / max(drawn, 1)
    readings["sample_gap"] = widest
    return readings
