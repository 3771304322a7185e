"""``td-predict --voxelize`` passes, as ``predict_passes`` runs them, of a
DenseNet-family model of the zoo (``DenseCPD``): the same seeded pool of
PDB files, passes of ``make_frame_set`` and ``load_dataset_and_predict``
(``predict_passes._pass``), rows drawn for the check (``_sample``) and
record, with the DenseNet module, weights (``weights_densenet``), plain
reference (``reference/densenet.py``) and FLOP count (``densenet``) in
TIMED's place. The traffic file's parameters are ``predict_passes``'.

The module is the registry's, built as td-predict builds it; the run
stops before any pass where its convolutions, blocks or head differ from
the configuration's widths."""
from __future__ import annotations

import sys
import time

import numpy as np

from .. import compare, densenet, harness, structures
from ..reference import densenet as ref_densenet
from ..reference import frames as ref_frames
from ..weights_densenet import calibrate, make_weights
from . import Outcome, Run, calibration_frames, compute_dtype, free, peak_bytes, sync
from .predict_passes import _pass, _sample


def program_model(config: dict, seed: int, device):
    """The registry's module of the configuration with the benchmark's
    seeded, calibrated weights, on ``device``; and a float32 copy of those
    weights for the reference."""
    from torch import nn

    from timed_design_tpu_torch.models import MODEL_REGISTRY

    module = MODEL_REGISTRY[config["model"]].build(
        compute_dtype=compute_dtype(config), in_channels=config["in_channels"])
    built = sorted((m.kernel_size[0], m.in_channels, m.out_channels)
                   for m in module.modules() if isinstance(m, nn.Conv3d))
    if (built != sorted(c[:3] for c in densenet.convs(config))
            or tuple(module.block_layers) != tuple(config["block_layers"])
            or (module.head.in_features, module.head.out_features)
            != (densenet.features(config), config["n_classes"])):
        raise ValueError(f"{config['model']} is not built at the widths of "
                         f"configuration {config['name']!r}")
    init = config["init"]
    weights = make_weights(module.state_dict(), seed, device, init["conv_gain"],
                           init["head_gain"])
    weights = calibrate(weights, calibration_frames(seed, device), config["block_layers"],
                        init["logit_std"])
    module.load_state_dict(weights)
    module.to(device)
    sync(device)
    return module, {k: v.detach().clone().float() for k, v in weights.items()
                    if v.is_floating_point()}


def reference_probs(texts: dict, wanted: list, weights: dict, block_layers, device,
                    block: int = 128) -> np.ndarray:
    """``compare.reference_probs`` with the plain DenseNet: reference
    probabilities (float64 on the host) of the frames ``wanted`` [(structure
    name, chain, residue id)] made from the PDB ``texts``, in its order."""
    by_name: dict[str, list[int]] = {}
    for i, (name, _, _) in enumerate(wanted):
        by_name.setdefault(name, []).append(i)
    out = np.zeros((len(wanted), weights["head.bias"].shape[0]))
    for name, idx in by_name.items():
        fa = ref_frames.frame_atoms(ref_frames.parse_backbone(texts[name]))
        row_of = {k: r for r, k in enumerate(fa["keys"])}
        rows = np.array([row_of[wanted[i][1:]] for i in idx])
        for s in range(0, len(rows), block):
            x = ref_frames.voxelize(fa, rows[s : s + block], device)
            out[idx[s : s + block]] = ref_densenet.probabilities(
                weights, x, block_layers).double().cpu().numpy()
            del x
    free(device)
    return out


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
    out = run.work / "out"
    out.mkdir()
    _pass(run, module, paths[: t["warmup_files"]], out, False)
    sync(run.device)

    passes, sampled = [], []
    check_rng = np.random.default_rng([run.seed, 1])
    setup_s = run.setup_clock()
    with harness.DeviceTrace(run.trace, run.device) as trace:
        deadline = time.perf_counter() + run.seconds
        while time.perf_counter() < deadline:
            pick = sorted(rng.choice(len(paths), t["files_per_pass"], replace=False))
            start = trace.now_us()
            p = _pass(run, module, [paths[i] for i in pick], out, False)
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
    want = reference_probs(texts, wanted, weights, cfg["block_layers"], run.device)
    got = np.stack([row for *_, row in sampled]) if sampled else np.zeros((0, want.shape[1]))
    readings = compare.answer_gaps(got, want)
    batch = cfg["batch_inference"]
    record = {
        "kind": "predict", "frames": frames, "window_s": window_s, "passes": passes,
        "batch": batch,
        "device_frames": sum(-(-p["frames"] // batch) for p in passes) * batch,
        "flop_per_frame": densenet.forward_flop_per_frame(cfg), "config": cfg,
        "kernels": trace.kernel_seconds(),
        "busy_s": trace.summary()["busy_s"] if run.trace else None,
    }
    return Outcome(
        end_to_end={"predict_frames_per_s": frames / window_s, "setup_s": setup_s},
        record=record, checks=compare.checks(readings, run.cell.limits),
        attempted=len(passes), failed=0, memory_peak_bytes=memory, trace=trace, readings=readings)
