"""The plain reference held to the program at small sizes on the CPU: the
frames, the forward, a training step, the rotamer compression and the
sampler's draws. These tests may import the program; the reference may
not."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from tdbench import structures
from tdbench.kinds import calibration_frames
from tdbench.reference import frames as ref_frames
from tdbench.reference import model as ref_model
from tdbench.weights import calibrate, make_weights


@pytest.fixture(scope="module")
def structure_text():
    return structures.backbone_text(np.random.default_rng(7), 100)


def small_model(n_classes: int = 20, seed: int = 5):
    from timed_design_tpu_torch.models import TIMED

    module = TIMED(n_classes=n_classes, filters=(4, 8), compute_dtype=torch.float32)
    weights = make_weights(module.state_dict(), seed, torch.device("cpu"), 2 ** 0.5, 1.0)
    weights.update(calibrate(weights, calibration_frames(seed, torch.device("cpu"), 40), 3.0))
    module.load_state_dict(weights)
    return module, {k: v.clone() for k, v in weights.items() if v.is_floating_point()}


def test_frames_equal_the_programs(structure_text):
    from timed_design_tpu_torch.structure import parse_pdb_string
    from timed_design_tpu_torch.voxel import Codec, structure_to_frame_atoms, voxelize_frame_atoms

    codec = Codec.CNOCACB()
    fa = structure_to_frame_atoms(parse_pdb_string(structure_text, name="s")[0], codec)
    got = voxelize_frame_atoms(fa, codec, device="cpu")
    ref = ref_frames.frame_atoms(ref_frames.parse_backbone(structure_text))
    assert ref["keys"] == list(zip(fa.chain_ids, fa.residue_ids))
    assert ref["labels"] == fa.labels
    rows = np.arange(0, len(ref["keys"]), 9)
    want = ref_frames.voxelize(ref, rows, "cpu")
    assert torch.allclose(got[rows], want, atol=1e-5)


def test_forward_equals_the_programs(structure_text):
    module, weights = small_model()
    fa = ref_frames.frame_atoms(ref_frames.parse_backbone(structure_text))
    x = ref_frames.voxelize(fa, np.arange(12), "cpu")
    with torch.no_grad():
        got = module.eval()(x)
    assert torch.allclose(got, ref_model.probabilities(weights, x), atol=1e-6)


def test_train_step_equals_the_programs(structure_text):
    from timed_design_tpu_torch.train import init_train_state, make_train_step

    module, weights = small_model()
    fa = ref_frames.frame_atoms(ref_frames.parse_backbone(structure_text))
    x = ref_frames.voxelize(fa, np.arange(16), "cpu")
    y = torch.zeros(16, 20)
    y[torch.arange(16), torch.as_tensor([ref_frames.AA3.index(l) for l in fa["labels"][:16]])] = 1
    state = init_train_state(module, device="cpu")
    out = make_train_step(module, state.optimizer)(x, y, torch.Generator().manual_seed(3))
    keep = torch.rand((16, 1, 1, 1, 8), generator=torch.Generator().manual_seed(3)) < 0.9
    ref = ref_model.train_steps(weights, [(x, y, keep.view(16, 8))])
    # the program's batch norm on the CPU sums 148,176 values a channel in
    # float32: against a float64 step it is 4e-5 off in the loss and up to
    # 3.4e-3 in a gradient, where the reference is 2e-7 and 9e-4
    assert abs(float(out["loss"]) - ref["losses"][0]) < 1e-4 * ref["losses"][0]
    for k, p in module.named_parameters():
        g, want = state.optimizer.state[p]["exp_avg"] / 0.1, ref["first_grads"][k]
        assert (g - want).norm() < 5e-3 * want.norm(), k
        moved, want_moved = p.detach() - weights[k], ref["params"][k] - weights[k]
        assert abs(moved.norm() - want_moved.norm()) < 5e-3 * want_moved.norm(), k


def test_rotamer_table_and_compression_equal_the_programs():
    from timed_design_tpu_torch.constants import ROTAMER_TO_AA, compress_rotamer_probs

    assert np.array_equal(ref_model.ROTAMER_TO_AA, ROTAMER_TO_AA)
    p = torch.rand(9, 338, dtype=torch.float64)
    assert np.allclose(ref_model.compress(p).numpy(), compress_rotamer_probs(p.numpy()))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 123, 2 ** 63 + 5])
def test_draws_equal_the_samplers(seed):
    from timed_design_tpu_torch.constants import ROTAMER_TO_AA
    from timed_design_tpu_torch.ops.sample import philox_uniforms, sample_codes_plain

    u = ref_model.philox_uniforms(seed, 6, 40)
    assert np.array_equal(u, philox_uniforms(seed, 6, 40))
    p = ref_model.tempered(torch.rand(40, 338, generator=torch.Generator().manual_seed(1)), 0.2)
    codes, _ = sample_codes_plain(p, torch.from_numpy(u),
                                  torch.as_tensor(ROTAMER_TO_AA.astype(np.uint8)))
    assert np.array_equal(codes.numpy(), ref_model.ROTAMER_TO_AA[ref_model.inverse_cdf_draws(p, u)])


def test_lower_precision_reference_moves_the_step():
    _, weights = small_model()
    x = calibration_frames(1, torch.device("cpu"), 16)
    y = torch.eye(20)[torch.arange(len(x)) % 20]
    keep = torch.ones(len(x), 8, dtype=torch.bool)
    full = ref_model.train_steps(weights, [(x, y, keep)])
    low = ref_model.train_steps(weights, [(x, y, keep)], operand_dtype=torch.float8_e4m3fn)
    assert low["losses"][0] != full["losses"][0]
    moved = [k for k in full["first_grads"] if low["first_grads"][k].abs().max() > 0]
    assert len(moved) == len(full["first_grads"]), "the rounding must let every gradient through"
