"""``td-train``: ``fit`` over a shuffled ``FrameBatchSource``.

Set-up writes ``files`` seeded PDB files (``chains_min``..``chains_max``
noisy ubiquitin chains, the same multiset of chain counts for every seed),
makes their frame set and map, and builds one model with the benchmark's
seeded weights in the configuration's compute dtype. One call of ``fit``
(batch ``batch_training``, Adam at ``learning_rate``, dropout masks from
the seed) then runs everything: its first ``checked_steps`` steps, which
the comparison reads; ``warmup_steps`` more; then the measured window, as
many epochs of the source as it takes to pass ``run.seconds``, every batch
voxelized on the card as ``fit`` asks for it. The rate is every frame
trained in the window over the window's wall time, which ends in a
synchronize.

Correctness, by the first ``checked_steps`` steps of that same call, with
the reference (float32, TF32 off) stepping from the same weights over the
same rows and dropout masks: each step's loss, each leaf's gradient at the
first step (from Adam's first moment, which is (1 - b1) g after one step)
and each leaf's change after the last, compared by their norms."""
from __future__ import annotations

import sys
import time

import numpy as np

from .. import compare, peaks, structures
from ..harness import DeviceTrace
from ..reference import frames as ref_frames
from ..reference import model as ref_model
from . import Outcome, Run, free, peak_bytes, program_model


class _Steps:
    """``make_train_step`` wrapped from the outside: CUDA events around
    each step in the window, and what the comparison reads after the first
    and the last checked step."""

    def __init__(self, checked: int, cuda: bool):
        self.checked, self.cuda = checked, cuda
        self.count, self.losses, self.events = 0, [], []
        self.timing = False
        self.first_grads = self.params_after = None

    def wrap(self, make_step):
        def make(module, optimizer, *args, **kw):
            step = make_step(module, optimizer, *args, **kw)

            def run(x, y, generator=None):
                import torch

                if self.timing and self.cuda:
                    e0, e1 = torch.cuda.Event(enable_timing=True), \
                        torch.cuda.Event(enable_timing=True)
                    e0.record()
                    out = step(x, y, generator)
                    e1.record()
                    self.events.append((e0, e1))
                    return out
                out = step(x, y, generator)
                self.count += 1
                if self.count <= self.checked:
                    self.losses.append(float(out["loss"]))
                    if self.count == 1:
                        # a step that moved nothing left no first moment: no gradient
                        b1 = optimizer.defaults["betas"][0]
                        self.first_grads = {
                            k: (optimizer.state[p]["exp_avg"] / (1 - b1)).double().norm().item()
                            if "exp_avg" in optimizer.state[p] else 0.0
                            for k, p in module.named_parameters()}
                    if self.count == self.checked:
                        self.params_after = {k: p.detach().float().clone()
                                             for k, p in module.named_parameters()}
                return out

            return run

        return make


class _Feed:
    """The batches ``fit`` asks for: the source's epochs, one after another,
    until the window closes. The window opens, after a synchronize, when
    the first batch past the checked and warm-up steps is asked for."""

    def __init__(self, source, before_window: int, run: Run, steps: _Steps, trace):
        self.source, self.before, self.run = source, before_window, run
        self.steps, self.trace = steps, trace
        self.n_batches = source.n_batches
        self.frames, self.steps_in_window, self.setup_s, self.opened = 0, 0, None, False

    def __iter__(self):
        given, deadline = 0, None
        while True:
            for X, y, n_valid in self.source:
                if given == self.before:
                    self.setup_s = self.run.setup_clock()
                    self.trace.__enter__()
                    self.opened = True
                    self.steps.timing = self.run.trace
                    deadline = time.perf_counter() + self.run.seconds
                elif deadline is not None and time.perf_counter() >= deadline:
                    return
                if deadline is not None:
                    self.frames += n_valid
                    self.steps_in_window += 1
                given += 1
                yield X, y, n_valid


def run(run: Run) -> Outcome:
    import timed_design_tpu_torch.train.train as train_mod
    from timed_design_tpu_torch.voxel import FrameBatchSource, create_flat_dataset_map
    from timed_design_tpu_torch.voxel import make_frame_set

    cfg, t = run.cell.config, run.cell.traffic
    rng = np.random.default_rng(run.seed)
    chain = structures.chain_atoms()
    counts = structures.balanced(rng, range(t["chains_min"], t["chains_max"] + 1), t["files"])
    files = run.work / "files"
    files.mkdir(parents=True)
    texts = {}
    for k, c in enumerate(counts):
        texts[f"s{k:04d}"] = structures.backbone_text(
            rng, structures.RESIDUES_PER_CHAIN * int(c), t["noise"], t["spacing"], chain)
        (files / f"s{k:04d}.pdb").write_text(texts[f"s{k:04d}"])
    frame_set = make_frame_set(sorted(files.glob("*.pdb")))
    dmap = create_flat_dataset_map(frame_set)
    shuffle_seed, dropout_seed = (int(s) for s in rng.integers(0, 2 ** 31, 2))
    source = FrameBatchSource(frame_set, dmap, cfg["batch_training"], device=run.device,
                              shuffle=True, shuffle_seed=shuffle_seed)
    module, weights = program_model(cfg, run.seed, run.device)
    steps = _Steps(t["checked_steps"], run.device.type == "cuda")
    trace = DeviceTrace(run.trace, run.device)
    feed = _Feed(source, t["checked_steps"] + t["warmup_steps"], run, steps, trace)
    make_step = train_mod.make_train_step
    train_mod.make_train_step = steps.wrap(make_step)
    try:
        train_mod.fit(module, feed, n_classes=cfg["n_classes"],
                      input_channels=cfg["in_channels"], learning_rate=t["learning_rate"],
                      epochs=1, seed=dropout_seed, log_every=10 ** 12, device=run.device)
    finally:
        train_mod.make_train_step = make_step
        if feed.opened:
            trace.__exit__(None, None, None)
    setup_s = feed.setup_s
    window_s = trace.window_s
    step_ms = [a.elapsed_time(b) for a, b in steps.events]
    memory = peak_bytes(run.device)
    del module, source
    free(run.device)

    readings = _compare(run, texts, dmap.entries, shuffle_seed, dropout_seed, weights, steps)
    record = {"kind": "train", "frames": feed.frames, "window_s": window_s, "config": cfg,
              "flop_per_frame": peaks.forward_flop_per_frame(cfg), "step_ms": step_ms,
              "kernels": trace.kernel_seconds(),
              "busy_s": trace.summary()["busy_s"] if run.trace else None}
    return Outcome(end_to_end={"train_frames_per_s": feed.frames / window_s,
                               "setup_s": setup_s},
                   record=record, checks=compare.checks(readings, run.cell.limits),
                   attempted=feed.steps_in_window, failed=0, memory_peak_bytes=memory,
                   trace=trace, readings=readings)


def _compare(run: Run, texts: dict, entries: list, shuffle_seed: int, dropout_seed: int,
             weights: dict, steps: _Steps) -> dict:
    """The checked steps against the reference's: ``loss_err``, the largest
    relative gap of a step's loss; ``grad_err`` and ``update_err``, the
    worst leaf's gap between the norms of its first gradient and of its
    change over the steps, over the larger of the reference's norm of that
    leaf and of the median leaf. Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone under Adam and
    are left out of ``update_err``."""
    import torch

    ref_model.no_tf32()
    t, cfg = run.cell.traffic, run.cell.config
    B, n = cfg["batch_training"], t["checked_steps"]
    order = np.random.default_rng(shuffle_seed).permutation(len(entries))
    gen = torch.Generator(device=run.device).manual_seed(dropout_seed)
    width = cfg["filters"][-1]
    parsed = {}
    batches = []
    for s in range(n):
        rows = [entries[i] for i in order[s * B : (s + 1) * B]]
        x = torch.empty((len(rows), 21, 21, 21, cfg["in_channels"]), device=run.device)
        by_name: dict[str, list[int]] = {}
        for i, (name, *_) in enumerate(rows):
            by_name.setdefault(name, []).append(i)
        for name, idx in by_name.items():
            if name not in parsed:
                fa = ref_frames.frame_atoms(ref_frames.parse_backbone(texts[name]))
                parsed[name] = (fa, {k: r for r, k in enumerate(fa["keys"])})
            fa, row_of = parsed[name]
            x[idx] = ref_frames.voxelize(fa, [row_of[rows[i][1:3]] for i in idx], run.device)
        y = torch.zeros((len(rows), cfg["n_classes"]), device=run.device)
        y[torch.arange(len(rows)), torch.as_tensor(
            [ref_frames.AA3.index(label) for *_, label in rows])] = 1.0
        keep = torch.rand((len(rows), 1, 1, 1, width), generator=gen,
                          device=run.device) < 1.0 - cfg["dropout_rate"]
        batches.append((x, y, keep.view(len(rows), width)))
    ref = ref_model.train_steps(weights, batches, lr=t["learning_rate"])
    got = {"losses": steps.losses, "first_grads": steps.first_grads,
           "params": steps.params_after}
    if run.quantize is not None:
        # the control: the reference in the lower precision, in the program's place
        low = ref_model.train_steps(weights, batches, lr=t["learning_rate"],
                                    operand_dtype=getattr(torch, run.quantize))
        got = {"losses": low["losses"], "params": low["params"],
               "first_grads": {k: g.double().norm().item()
                               for k, g in low["first_grads"].items()}}
    if len(got["losses"]) < n or got["params"] is None:
        return {}
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    g_ref = {k: g.double().norm().item() for k, g in ref["first_grads"].items()}
    g_med = ref_model.median(g_ref.values())
    g_gap = {k: ref_model.norm_gap(got["first_grads"][k], g_ref[k], g_med) for k in g_ref}
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    d_ref = {k: (ref["params"][k] - weights[k]).double().norm().item() for k in moved}
    d_got = {k: (got["params"][k] - weights[k]).double().norm().item() for k in moved}
    d_med = ref_model.median(d_ref.values())
    d_gap = {k: ref_model.norm_gap(d_got[k], d_ref[k], d_med) for k in moved}
    for what, gaps in (("first gradient", g_gap), ("change", d_gap)):
        print(f"train: gap of each leaf's {what} norm: " + ", ".join(
            f"{k} {v:.4g}" for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])),
            file=sys.stderr)
    return {"loss_err": loss_err, "grad_err": max(g_gap.values()),
            "grad_err_median": ref_model.median(g_gap.values()),
            "update_err": max(d_gap.values()),
            "update_err_median": ref_model.median(d_gap.values())}
