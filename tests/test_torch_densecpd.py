"""PyTorch port, DenseCPD on td-predict's path: the port's ``DenseNet3D``
against the benchmark's plain reference (``tdbench/reference/densenet.py``)
in float32 and in bfloat16, the seeded weights' calibration, the FLOP
count, the spans and counter the forward records, and one whole run of the
``predict_passes_densenet`` driver, all on the CPU with seeded weights; on
the card, the forward's device spans."""
import dataclasses
import functools
import json
import math
import time
from pathlib import Path

import pytest
import torch

from timed_design_tpu_torch.models import MODEL_REGISTRY, quantized_convs
from timed_design_tpu_torch.models.densenet import DenseNet3D
from timed_design_tpu_torch.utils import timing

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SMALL = {"growth_rate": 4, "block_layers": (2, 2, 2), "init_features": 8}
ZOO = {"growth_rate": 16, "block_layers": (6, 6, 6), "init_features": 32}
# registry DenseNet: growth 12 gives rows of 36, 60, ... channels
DENSENET = {"growth_rate": 12, "block_layers": (4, 4, 4), "init_features": 24}
SEED = 2 ** 35 + 21


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs several workers per host
    yield
    torch.set_num_threads(n)


def zoo_config() -> dict:
    return json.loads((ROOT / "tdbench" / "configs" / "densecpd.json").read_text())


@functools.lru_cache(maxsize=None)
def _calibrated(widths: tuple, residues: int, seed: int = 5):
    from tdbench.kinds import calibration_frames
    from tdbench.weights_densenet import calibrate, make_weights

    kw = dict(widths)
    module = DenseNet3D(compute_dtype=torch.float32, **kw)
    frames = calibration_frames(seed, CPU, residues)
    weights = make_weights(module.state_dict(), seed, CPU, 2 ** 0.5, 1.0)
    weights = calibrate(weights, frames, kw["block_layers"], 3.0)
    return weights, frames


def calibrated(widths: dict, residues: int, dtype=torch.float32):
    """A module of ``widths`` in ``dtype`` with calibrated seeded weights,
    the weights (float32) and the calibration frames."""
    weights, frames = _calibrated(tuple(widths.items()), residues)
    module = DenseNet3D(compute_dtype=dtype, **widths)
    module.load_state_dict(weights)
    return module.eval(), {k: v for k, v in weights.items() if v.is_floating_point()}, frames


@pytest.mark.parametrize("widths,residues,n", [(SMALL, 40, 4), (ZOO, 8, 2), (DENSENET, 8, 2)],
                         ids=["small", "zoo", "densenet"])
def test_float32_forward_equals_the_reference(widths, residues, n):
    """Float32 on both sides, the same operations: 1e-5 holds the
    probabilities with room (1.8e-7 seen at both sizes). Under ``no_grad``
    the evaluation forward goes through the block buffers."""
    from tdbench.reference import densenet as ref

    module, weights, frames = calibrated(widths, residues)
    with torch.no_grad():
        got = module(frames[:n])
    want = ref.probabilities(weights, frames[:n], widths["block_layers"])
    assert (got - want).abs().max() <= 1e-5


def test_bfloat16_forward_is_near_the_reference_and_int8_is_not():
    """The program's bfloat16 convolutions against the float32 reference at
    the zoo's widths: the log probabilities' error over their spread
    (``compare.answer_gaps``' ``logit_err``) reads 0.0066 on these 8
    frames, the int8 convolutions 0.19; 0.05 lies between with room on
    both sides."""
    from tdbench import compare
    from tdbench.reference import densenet as ref

    module, weights, frames = calibrated(ZOO, 8, torch.bfloat16)
    want = ref.probabilities(weights, frames, ZOO["block_layers"]).double().numpy()
    with torch.no_grad():
        bf16 = module(frames).float().numpy()
        with quantized_convs("int8"):
            int8 = module(frames).float().numpy()
    assert compare.answer_gaps(bf16, want)["logit_err"] < 0.05
    assert compare.answer_gaps(int8, want)["logit_err"] > 0.05


def test_calibration_sets_each_batchnorm_to_its_own_input():
    """Each BatchNorm's running mean and (biased) variance are those of
    the tensor it normalises over the calibration frames (in a dense layer,
    the concatenation), and a frame's logits spread by 3."""
    module, _, frames = calibrated(SMALL, 40)
    seen = {}
    hooks = [m.register_forward_pre_hook(
        lambda m, args, name=name: seen.__setitem__(name, args[0].detach()))
        for name, m in module.named_modules() if isinstance(m, torch.nn.BatchNorm3d)]
    try:
        # with autograd on the forward calls each BatchNorm module; the
        # block buffers' path reads their statistics as kernel parameters
        logits = module(frames, logits=True).detach()
    finally:
        for h in hooks:
            h.remove()
    with torch.no_grad():
        assert torch.allclose(module(frames, logits=True), logits, atol=1e-5)
    assert len(seen) == 2 * 6 + 2 + 1
    for name, x in seen.items():
        bn = module.get_submodule(name)
        var, mean = torch.var_mean(x, dim=(0, 2, 3, 4), correction=0)
        assert torch.allclose(bn.running_mean, mean, atol=1e-5), name
        assert torch.allclose(bn.running_var, var, rtol=1e-4, atol=1e-6), name
    assert abs(float(logits.std(1).mean()) - 3.0) <= 0.03


def test_counts_equal_the_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    from tdbench import densenet

    cfg = zoo_config()
    with torch.device("meta"):
        module = MODEL_REGISTRY["DenseCPD"].build()
        with FlopCounterMode(display=False) as counter:
            module.eval()(torch.zeros(1, 21, 21, 21, 5))
    assert densenet.forward_flop_per_frame(cfg) == counter.get_total_flops() \
        == cfg["forward_flop_per_frame"] == 4_306_668_096
    assert sum(p.numel() for p in module.parameters()) == cfg["parameters"]
    convs = densenet.convs(cfg)
    assert len(convs) == 1 + 2 * 18 + 2 and densenet.features(cfg) == 176
    assert {v for *_, v in convs} == {21 ** 3, 10 ** 3, 5 ** 3}
    # the least times: a forward of 512 frames moves more than it computes
    flop = 4_306_668_096 * 512
    assert densenet.forward_least_s(cfg, 512) > flop / 989e12
    assert densenet.conv_least_s(cfg, 512) >= densenet.forward_least_s(cfg, 512) - 1e-12


def test_concat_bytes_are_counted_while_recording_only(monkeypatch):
    module, _, frames = calibrated(SMALL, 40)
    x = frames[:3]
    calls = []
    monkeypatch.setattr(timing, "count", lambda *a: calls.append(a))
    with torch.no_grad():
        module(x)
    assert calls == []
    monkeypatch.undo()
    with timing.recording() as rec, torch.no_grad():
        module(x)
    # the evaluation forward stores each layer's new channels into its
    # block's buffer: the bytes of that slice alone
    want = sum(3 * SMALL["growth_rate"] * n * edge ** 3 * 4  # float32 values
               for n, edge in zip(SMALL["block_layers"], (21, 10, 5)))
    assert rec.counters == {"densenet.concat_bytes": want, "densenet.bn_relu.fused": 15}
    assert rec.device_spans == []  # device spans are the card's


@pytest.mark.parametrize("mode", ["train", "grad"])
def test_training_and_autograd_concatenate_as_before(mode):
    """In training mode, or in evaluation with autograd on, every dense
    layer writes its whole concatenation and every BatchNorm-ReLU runs as
    modules: no block buffer, no fused pass."""
    module, _, frames = calibrated(SMALL, 40)
    module.train(mode == "train")
    with timing.recording() as rec:
        module(frames[:3])
    module.eval()
    c, edge, want = SMALL["init_features"], 21, 0
    for b, n in enumerate(SMALL["block_layers"]):
        for _ in range(n):
            c += SMALL["growth_rate"]
            want += 3 * c * edge ** 3 * 4  # float32 values
        c, edge = c // 2, edge // 2
    assert rec.counters == {"densenet.concat_bytes": want, "densenet.bn_relu.plain": 15}


def small_cell():
    from tdbench import harness

    cell = harness.load_cell("predict_densecpd_pdb")
    cell.config.update({**SMALL, "block_layers": list(SMALL["block_layers"]),
                        "batch_inference": 32})
    cell.traffic.update(pool_files=4, files_per_pass=2, chains_max=2, warmup_files=1,
                        check_rows_per_pass=300)
    return cell


@pytest.fixture
def small_registry(monkeypatch):
    """The registry's DenseCPD built at the small widths."""
    spec = MODEL_REGISTRY["DenseCPD"]
    monkeypatch.setitem(MODEL_REGISTRY, "DenseCPD", dataclasses.replace(
        spec, constructor=functools.partial(DenseNet3D, **SMALL)))


@pytest.mark.parametrize("mode", ["sound", "control", "half_batch", "altered"])
def test_predict_passes_densenet_run(small_registry, mode):
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
    assert {"densecpd.block_device_ms", "densecpd.transition_device_ms",
            "densecpd.concat_mb_per_frame", "densecpd.forward_roofline",
            "densecpd.fused_bn_relu_share",
            "conv3d_roofline.predict_densecpd", "mfu.predict", "device_idle.predict",
            "predict.engine_frames_per_s", "predict.forward_device_ms"} <= names
    for name, metric in result["metrics"].items():
        assert math.isfinite(metric["value"]), name
    assert {"mfu.predict", "predict.engine_frames_per_s"} <= set(result["metrics"])


def test_driver_refuses_a_module_off_the_configurations_widths():
    from tdbench.kinds import predict_passes_densenet

    cfg = {**zoo_config(), "growth_rate": 12}
    with pytest.raises(ValueError, match="widths"):
        predict_passes_densenet.program_model(cfg, 1, CPU)


def test_readers_on_a_hand_made_record():
    from tdbench import densenet, harness

    cfg = zoo_config()
    spans = [("densenet.block", i, ms) for i, ms in ((0, 10.0), (1, 4.0), (2, 1.0),
                                                     (0, 12.0), (1, 4.0), (2, 1.0))]
    spans += [("densenet.transition", 0, 2.0), ("densenet.transition", 1, 0.5),
              ("densenet.head", None, 0.25), ("forward", 0, 20.0)]
    record = {"kind": "predict", "batch": 512, "device_frames": 1024, "config": cfg,
              "spans": [("forward", 0.0, 1.0, "MainThread", 0)], "device_spans": spans,
              "counters": {"densenet.concat_bytes": 1024 * 11_423_616,
                           "densenet.bn_relu.fused": 3 * 39, "densenet.bn_relu.plain": 39},
              "idle_by_span": {},
              "kernels": {"sm90_xmma_fprop_implicit_gemm_bf16": 0.5, "relu_kernel": 0.2,
                          "nvjet_tst_64x384_64x3_1x2_h_ssched_bz_coopB_TNT": 0.125,
                          "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_cublas": 0.25}}

    def read(name, r=record):
        return harness.load_reader(name).read(r)

    assert read("densecpd.block_device_ms") == 11.0 + 4.0 + 1.0
    assert read("densecpd.transition_device_ms") == 2.75
    assert math.isclose(read("densecpd.concat_mb_per_frame"), 11.423616)
    assert read("densecpd.fused_bn_relu_share") == 75.0
    # a program without the BatchNorm-ReLU counters
    assert read("densecpd.fused_bn_relu_share",
                {**record, "counters": {"densenet.concat_bytes": 1}}) is None
    assert math.isclose(read("densecpd.forward_roofline"),
                        100 * densenet.forward_least_s(cfg, 512) / 0.020)
    assert math.isclose(read("conv3d_roofline.predict_densecpd"),
                        100 * densenet.conv_least_s(cfg, 1024) / 0.625)
    empty = {"kind": "predict", "config": cfg, "device_frames": 1024, "batch": 512,
             "spans": [], "device_spans": [], "counters": {}, "idle_by_span": {}}
    for name in ("densecpd.block_device_ms", "densecpd.transition_device_ms",
                 "densecpd.concat_mb_per_frame", "densecpd.forward_roofline",
                 "conv3d_roofline.predict_densecpd", "densecpd.fused_bn_relu_share"):
        assert read(name, {}) is None and read(name, empty) is None, name


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_forward_records_its_device_spans_inside_forward(cuda_device):
    """One bfloat16 forward of DenseCPD at the zoo's widths under the
    recorder: three blocks, two transitions and the head, each a device
    span of positive time, all within the `forward` span around them."""
    module = MODEL_REGISTRY["DenseCPD"].build(compute_dtype=torch.bfloat16).to(cuda_device)
    x = torch.rand(16, 21, 21, 21, 5, device=cuda_device)
    with torch.inference_mode():
        module.eval()(x)  # cuDNN's first choice of kernels outside the spans
        with timing.recording() as rec:
            with timing.device_span("forward", 0, device=cuda_device):
                module(x)
    got = [(name, id_) for name, id_, _ in rec.device_spans]
    assert got == [("densenet.block", 0), ("densenet.transition", 0), ("densenet.block", 1),
                   ("densenet.transition", 1), ("densenet.block", 2), ("densenet.head", None),
                   ("forward", 0)]
    ms = [m for *_, m in rec.device_spans]
    assert all(m > 0 for m in ms) and sum(ms[:-1]) <= ms[-1]
    # under inference_mode each layer stores its 16 new bf16 channels into
    # its block's buffer, and all 39 BatchNorm-ReLUs take the fused pass
    assert rec.counters["densenet.concat_bytes"] == 16 * 2 * 6 * 16 * (9261 + 1000 + 125)
    assert rec.counters["densenet.bn_relu.fused"] == 39
    assert "densenet.bn_relu.plain" not in rec.counters
