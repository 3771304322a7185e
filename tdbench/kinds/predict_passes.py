"""``td-predict --voxelize`` as a dataset user runs it, pass after pass.

Set-up writes a pool of seeded PDB files (``pool_files`` structures of
``chains_min``..``chains_max`` noisy ubiquitin chains, the same multiset of
chain counts for every seed) under the run's directory. A pass is one
invocation's work on ``files_per_pass`` files drawn from the pool:
``make_frame_set`` over them, then ``load_dataset_and_predict``, which
voxelizes each batch of ``batch`` frames on the card, runs the model and
writes the artifact set (the rotamer head's full-precision ``_rot.csv``
too). Passes run back to back; none starts after the window's mark, and
the rate is the frames of every pass over their wall time.

Correctness: ``check_rows_per_pass`` rows of every pass, drawn from the
seed, of the probabilities the pass returned, against the reference run
again from the same PDB text and weights."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

from .. import compare, peaks, structures
from ..harness import DeviceTrace
from . import Outcome, Run, free, peak_bytes, program_model, sync


def _pass(run: Run, module, paths: list[Path], out: Path, rotamer: bool) -> dict:
    from timed_design_tpu_torch.engine.predictor import load_dataset_and_predict
    from timed_design_tpu_torch.voxel import make_frame_set

    (out / "datasetmap.txt").unlink(missing_ok=True)
    t0 = time.perf_counter()
    frame_set = make_frame_set(paths)
    t1 = time.perf_counter()
    result = load_dataset_and_predict(
        [module], frame_set, batch_size=run.cell.config["batch_inference"],
        dataset_map_path=Path("datasetmap.txt"), predict_rotamers=rotamer,
        path_to_output=out, device=run.device, quantize=run.quantize)
    t2 = time.perf_counter()
    return {"result": result, "frame_set_s": t1 - t0, "wall_s": t2 - t0,
            "frames": len(result.flat_dataset_map.entries), "timings": result.timings}


def _sample(rng: np.random.Generator, result, k: int) -> list:
    """``k`` rows of a pass drawn from ``rng``: (name, chain, residue id,
    the returned probability row)."""
    entries = result.flat_dataset_map.entries
    pick = set(rng.choice(len(entries), min(k, len(entries)), replace=False).tolist())
    seen: dict[str, int] = {}
    rows = []
    for i, (name, chain, rid, _) in enumerate(entries):
        j = seen.get(name + chain, 0)
        seen[name + chain] = j + 1
        if i in pick:
            rows.append((name, chain, rid,
                         np.asarray(result.pdb_to_probability[name + chain][j], np.float64)))
    return rows


def run(run: Run) -> Outcome:
    cfg, t = run.cell.config, run.cell.traffic
    rng = np.random.default_rng(run.seed)
    chain = structures.chain_atoms()
    counts = structures.balanced(rng, range(t["chains_min"], t["chains_max"] + 1),
                                 t["pool_files"])
    pool = run.work / "pool"
    pool.mkdir(parents=True)
    texts = {}
    for k, c in enumerate(counts):
        name = f"s{k:04d}"
        texts[name] = structures.backbone_text(
            rng, structures.RESIDUES_PER_CHAIN * int(c), t["noise"], t["spacing"], chain)
        (pool / f"{name}.pdb").write_text(texts[name])
    paths = sorted(pool.glob("*.pdb"))
    module, weights = program_model(cfg, run.seed, run.device)
    rotamer = cfg["n_classes"] == 338
    out = run.work / "out"
    out.mkdir()
    _pass(run, module, paths[: t["warmup_files"]], out, rotamer)
    sync(run.device)

    passes, sampled = [], []
    check_rng = np.random.default_rng([run.seed, 1])
    setup_s = run.setup_clock()
    with DeviceTrace(run.trace, run.device) as trace:
        deadline = time.perf_counter() + run.seconds
        while time.perf_counter() < deadline:
            pick = sorted(rng.choice(len(paths), t["files_per_pass"], replace=False))
            start = trace.now_us()
            p = _pass(run, module, [paths[i] for i in pick], out, rotamer)
            trace.span("td-predict pass", start, trace.now_us())
            sampled += _sample(check_rng, p.pop("result"), t["check_rows_per_pass"])
            passes.append(p)
            print(f"pass {len(passes)}: {p['frames']} frames in {p['wall_s']:.3f} s, frame set "
                  f"{p['frame_set_s']:.3f} s, " + ", ".join(
                      f"{k} {v:.3f}" for k, v in p["timings"].items()), file=sys.stderr)
    window_s = trace.window_s
    memory = peak_bytes(run.device)
    del module
    free(run.device)

    frames = sum(p["frames"] for p in passes)
    wanted = [(n, c, r) for n, c, r, _ in sampled]
    want = compare.reference_probs(texts, wanted, weights, run.device)
    got = np.stack([row for *_, row in sampled]) if sampled else np.zeros((0, want.shape[1]))
    readings = compare.answer_gaps(got, want)
    record = {
        "kind": "predict", "frames": frames, "window_s": window_s, "passes": passes,
        "batch": cfg["batch_inference"],
        "device_frames": sum(-(-p["frames"] // cfg["batch_inference"]) for p in passes)
        * cfg["batch_inference"],
        "flop_per_frame": peaks.forward_flop_per_frame(cfg), "config": cfg,
        "kernels": trace.kernel_seconds(), "busy_s": trace.summary()["busy_s"]
        if run.trace else None,
    }
    return Outcome(
        end_to_end={"predict_frames_per_s": frames / window_s, "setup_s": setup_s},
        record=record, checks=compare.checks(readings, run.cell.limits),
        attempted=len(passes), failed=0, memory_peak_bytes=memory, trace=trace, readings=readings)
