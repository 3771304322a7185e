"""PyTorch port, TIMED_rotamer on td-predict's rotamer path: the registry's
338-class TIMED against the benchmark's plain reference
(``tdbench/reference/model.py``) in float32, bfloat16 and int8, a small
``td-predict --predict_rotamers`` run's artifacts against the reference, the
``timed.head`` device span and the writer's span, the cell's
readers, and one whole run of the ``predict_passes`` driver in rotamer mode,
all on the CPU with seeded weights; on the card, the head's device span."""
import functools
import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from timed_design_tpu_torch.constants import ROTAMER_TO_AA, compress_rotamer_probs
from timed_design_tpu_torch.engine import predictor as predictor_mod
from timed_design_tpu_torch.io import load_prediction_matrix
from timed_design_tpu_torch.models import MODEL_REGISTRY, quantized_convs
from timed_design_tpu_torch.utils import timing

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SMALL = (4, 8)
ZOO = (16, 32, 64, 128)
SEED = 2 ** 35 + 25


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs several workers per host
    yield
    torch.set_num_threads(n)


def cell_config() -> dict:
    return json.loads((ROOT / "tdbench" / "configs" / "timed_rotamer.json").read_text())


def cell_limits() -> dict:
    return json.loads((ROOT / "tdbench" / "limits" / "predict_rotamer_pdb.json").read_text())


@functools.lru_cache(maxsize=None)
def _calibrated(filters: tuple, residues: int, seed: int = 5):
    from tdbench.kinds import calibration_frames
    from tdbench.weights import calibrate, make_weights

    module = MODEL_REGISTRY["TIMED_rotamer"].build(filters=filters)
    frames = calibration_frames(seed, CPU, residues)
    weights = make_weights(module.state_dict(), seed, CPU, 2 ** 0.5, 1.0)
    weights.update(calibrate(weights, frames, 3.0))
    return weights, frames


def calibrated(filters: tuple, residues: int, dtype=torch.float32):
    """The registry's TIMED_rotamer at ``filters`` in ``dtype`` with
    calibrated seeded weights, the weights (float32) and the calibration
    frames."""
    weights, frames = _calibrated(filters, residues)
    module = MODEL_REGISTRY["TIMED_rotamer"].build(filters=filters, compute_dtype=dtype)
    module.load_state_dict(weights)
    module.name = "TIMED_rotamer"  # names td-predict's artifacts
    return module.eval(), {k: v for k, v in weights.items() if v.is_floating_point()}, frames


def test_registry_builds_the_configurations_widths():
    cfg = cell_config()
    module = MODEL_REGISTRY["TIMED_rotamer"].build()
    assert module.n_classes == cfg["n_classes"] == 338
    widths = [(b.conv.in_channels, b.conv.out_channels) for b in module.blocks]
    assert widths == list(zip([cfg["in_channels"], *cfg["filters"]], cfg["filters"]))
    assert (module.head.in_channels, module.head.out_channels) == (128, 338)


@pytest.mark.parametrize("filters,residues,n", [(SMALL, 40, 6), (ZOO, 8, 2)],
                         ids=["small", "zoo"])
def test_float32_forward_equals_the_reference(filters, residues, n):
    """Float32 on both sides, the same operations: 1e-5 holds the 338
    probabilities with room."""
    from tdbench.reference import model as ref

    module, weights, frames = calibrated(filters, residues)
    with torch.no_grad():
        got = module(frames[:n])
    want = ref.probabilities(weights, frames[:n])
    assert got.shape == (n, 338)
    assert (got - want).abs().max() <= 1e-5


def test_bfloat16_forward_is_near_the_reference_and_int8_is_not():
    """The program's bfloat16 convolutions against the float32 reference at
    the zoo's widths, held to the cell's own ``logit_err`` limit: bfloat16
    lies well inside it (0.016 on these 8 frames), the int8 convolutions
    (the cell's control) past it (1.5)."""
    from tdbench import compare
    from tdbench.reference import model as ref

    module, weights, frames = calibrated(ZOO, 8, torch.bfloat16)
    want = ref.probabilities(weights, frames).double().numpy()
    with torch.no_grad():
        bf16 = module(frames).float().numpy()
        with quantized_convs("int8"):
            int8 = module(frames).float().numpy()
    limit = cell_limits()["logit_err"]
    assert compare.answer_gaps(bf16, want)["logit_err"] < limit / 2
    assert compare.answer_gaps(int8, want)["logit_err"] > limit


def _pdb_texts(n_files: int = 2, seed: int = 7) -> dict:
    from tdbench import structures

    rng = np.random.default_rng(seed)
    chain = structures.chain_atoms()
    return {f"s{k:04d}": structures.backbone_text(rng, structures.RESIDUES_PER_CHAIN * (k + 1),
                                                  0.2, 50.0, chain)
            for k in range(n_files)}


def _td_predict(tmp_path: Path, module, texts: dict):
    from timed_design_tpu_torch.voxel import make_frame_set

    pdbs = tmp_path / "pdbs"
    pdbs.mkdir(parents=True)
    for name, text in texts.items():
        (pdbs / f"{name}.pdb").write_text(text)
    out = tmp_path / "out"
    out.mkdir()
    result = predictor_mod.load_dataset_and_predict(
        [module], make_frame_set(sorted(pdbs.glob("*.pdb"))), batch_size=32,
        dataset_map_path=Path("datasetmap.txt"), predict_rotamers=True, path_to_output=out,
        device=CPU)
    return result, out


def test_td_predict_rotamer_artifacts_against_the_reference(tmp_path):
    """A small ``td-predict --predict_rotamers`` run in float32: ``_rot.csv``
    read back is the matrix the run returned (which is that matrix cast to
    float16), it and its 338 -> 20 compression lie within 1e-5 of the
    reference's, and the one-hot ``{model}.csv`` marks the amino acid of the
    reference's first rotamer wherever that rotamer leads the second by more
    than the two sides' distance."""
    from tdbench import compare
    from tdbench.reference import model as ref

    module, weights, _ = calibrated(SMALL, 40)
    texts = _pdb_texts()
    result, out = _td_predict(tmp_path, module, texts)
    entries = result.flat_dataset_map.entries
    rot = load_prediction_matrix(out / "TIMED_rotamer_rot.csv")
    assert rot.shape == (len(entries), 338) and len(entries) == 76 * 3
    returned = np.concatenate([result.pdb_to_probability[k] for k in dict.fromkeys(
        name + chain for name, chain, *_ in entries)])
    assert np.array_equal(rot.astype(np.float16), returned)

    want = compare.reference_probs(texts, [e[:3] for e in entries], weights, CPU)
    assert np.abs(rot - want).max() <= 1e-5
    assert np.abs(compress_rotamer_probs(rot) - ref.compress(torch.from_numpy(want)).numpy()
                  ).max() <= 1e-5
    onehot = load_prediction_matrix(out / "TIMED_rotamer.csv")
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    assert clear.sum() > 0.9 * len(want)
    expected = np.eye(20)[ROTAMER_TO_AA[want.argmax(1)]]
    assert np.array_equal(onehot[clear], expected[clear])
    assert np.array_equal(ROTAMER_TO_AA, ref.ROTAMER_TO_AA)


def test_writer_span_while_recording_only(tmp_path):
    """With the recorder on, each batch's ``write_batch`` span on the
    ``csv-writer`` thread holds one ``write.rot_csv`` span; the files are
    the same bytes with it off, and ``_rot.csv`` is as long as
    ``tdbench.rotamer.rot_csv_bytes`` counts from its rows."""
    from tdbench import rotamer

    module, _, _ = calibrated(SMALL, 40)
    texts = _pdb_texts()
    result, off = _td_predict(tmp_path / "off", module, texts)
    with timing.recording() as rec:
        _, on = _td_predict(tmp_path / "on", module, texts)
    n_batches = -(-76 * 3 // 32)
    by_name: dict = {}
    for s in rec.spans:
        by_name.setdefault(s.name, []).append(s)
    parents = {s.index: s for s in by_name["write_batch"]}
    assert len(by_name["write.rot_csv"]) == n_batches
    assert all(s.thread == "csv-writer" and s.parent in parents
               for s in by_name["write.rot_csv"])
    assert rec.device_spans == []  # device spans are the card's
    for name in ("TIMED_rotamer_rot.csv", "TIMED_rotamer.csv"):
        assert (off / name).read_bytes() == (on / name).read_bytes(), name
    frames = len(result.flat_dataset_map.entries)
    assert (on / "TIMED_rotamer_rot.csv").stat().st_size == rotamer.rot_csv_bytes(
        {"n_classes": 338}, frames)


class _FakeEvent:
    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1.5


def test_head_device_span_while_recording_only(monkeypatch):
    """``TIMED.forward`` asks for one ``timed.head`` device span, around the
    head alone; the recorder keeps it only while it is on. The CUDA events
    are stood in for, and the frames' device is taken as a card."""
    device_span = timing.device_span
    seen = []

    def as_card(name, id=None, *, device):
        seen.append(name)
        return device_span(name, id, device=torch.device("cuda"))

    monkeypatch.setattr(timing, "device_span", as_card)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    module, _, frames = calibrated(SMALL, 40)
    with torch.no_grad():
        module(frames[:2])
        assert seen == ["timed.head"]
        with timing.recording() as rec:
            module(frames[:2])
        module(frames[:2])
    assert rec.device_spans == [("timed.head", None, 1.5)]


def small_cell():
    from tdbench import harness

    cell = harness.load_cell("predict_rotamer_pdb")
    cell.config.update(filters=list(SMALL), batch_inference=32)
    cell.traffic.update(pool_files=4, files_per_pass=2, chains_max=2, warmup_files=1,
                        check_rows_per_pass=300)
    return cell


@pytest.mark.parametrize("mode", ["sound", "control", "half_batch", "altered"])
def test_predict_passes_rotamer_run(mode):
    """A whole run of the cell's driver through ``run.execute`` at a small
    size, traced: sound, it is correct and each of the cell's per-layer
    readers returns a number or None; with the int8 convolutions (the
    control) or a fault planted in the engine, it is not correct."""
    from tdbench import controls
    from tdbench.run import execute

    cell = small_cell()
    t0 = time.perf_counter()
    fault = mode if mode in controls.FAULTS["predict_passes"] else None
    quantize = "int8" if mode == "control" else None
    with controls.planted("predict_passes", fault):
        result = execute(cell, SEED, 1.0, True, CPU, quantize=quantize,
                         setup_clock=lambda: time.perf_counter() - t0)
    assert result["correct"] == (mode == "sound"), result["readings"]
    assert result["attempted"] >= 1
    names = {entry["name"] for entry, _ in cell.per_layer}
    assert {"rotamer.head_device_ms", "rotamer.head_roofline", "rotamer.rot_csv_share",
            "rotamer.rot_csv_mb_per_s", "mfu.predict", "device_idle.predict",
            "predict.engine_frames_per_s", "predict.forward_device_ms",
            "predict.writer_busy_share", "predict.frame_set_share", "predict.parse_share",
            "predict.voxelize_device_ms", "predict.idle_unspanned_share",
            "conv3d_roofline.predict"} <= names
    for name, metric in result["metrics"].items():
        assert math.isfinite(metric["value"]), name
    assert {"mfu.predict", "predict.engine_frames_per_s"} <= set(result["metrics"])


def test_head_least_time():
    """The head's least time at the zoo's widths: its bf16 input (1.214 GB a
    batch of 512) over the memory rate, far above the pooled projection's
    operations over the bf16 peak."""
    from tdbench import peaks, rotamer

    cfg = cell_config()
    moved = 512 * (2 * 21 ** 3 * 128 + 4 * 338)
    assert math.isclose(rotamer.head_least_s(cfg, 512), moved / peaks.HBM_BYTES_PER_S)
    assert 0.36e-3 < rotamer.head_least_s(cfg, 512) < 0.37e-3
    assert 2 * 512 * 128 * 338 / peaks.BF16_FLOPS < rotamer.head_least_s(cfg, 512) / 1000


def test_readers_on_a_hand_made_record():
    from tdbench import harness, rotamer

    cfg = cell_config()
    spans = [("timed.head", None, ms) for ms in (6.0, 7.0, 8.0)] + [("forward", 0, 30.0)]
    record = {"kind": "predict", "batch": 512, "device_frames": 1536, "config": cfg,
              "spans": [("predict", 0.0, 2e6, "MainThread", 0),
                        ("write.rot_csv", 1e5, 3e5, "csv-writer", 1),
                        ("write.rot_csv", 4e5, 7e5, "csv-writer", 2)],
              "device_spans": spans, "counters": {}, "frames": 1000,
              "idle_by_span": {}}

    def read(name, r=record):
        return harness.load_reader(name).read(r)

    assert read("rotamer.head_device_ms") == 7.0
    assert math.isclose(read("rotamer.head_roofline"),
                        100 * rotamer.head_least_s(cfg, 512) / 7e-3)
    assert math.isclose(read("rotamer.rot_csv_share"), 25.0)
    assert math.isclose(read("rotamer.rot_csv_mb_per_s"), 1000 * 338 * 25 / 0.5 / 1e6)
    # a program without the new spans: the parent's
    empty = {**record, "spans": [("predict", 0.0, 2e6, "MainThread", 0)],
             "device_spans": [("forward", 0, 30.0)], "counters": {}}
    for name in ("rotamer.head_device_ms", "rotamer.head_roofline", "rotamer.rot_csv_share",
                 "rotamer.rot_csv_mb_per_s"):
        assert read(name, {}) is None and read(name, empty) is None, name


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_head_records_its_device_span_inside_forward(cuda_device):
    """One bfloat16 forward of TIMED_rotamer at the zoo's widths under the
    recorder: the head is one device span of positive time, within the
    ``forward`` span around it."""
    module = MODEL_REGISTRY["TIMED_rotamer"].build(compute_dtype=torch.bfloat16)
    module = module.to(cuda_device).eval()
    x = torch.rand(64, 21, 21, 21, 5, device=cuda_device)
    with torch.inference_mode():
        module(x)  # cuDNN's first choice of kernels outside the spans
        with timing.recording() as rec:
            with timing.device_span("forward", 0, device=cuda_device):
                out = module(x)
    assert out.shape == (64, 338) and out.dtype == torch.float32
    assert [(name, id_) for name, id_, _ in rec.device_spans] == [("timed.head", None),
                                                                  ("forward", 0)]
    head, forward = (ms for *_, ms in rec.device_spans)
    assert 0 < head < forward
