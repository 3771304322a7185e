"""PyTorch port, property-constrained design and the other public names
the port adds from the JAX package: residue rewrites, residue maps, cache
keys, frames of a rewritten structure, a TIMED_Charge forward, the metric
aliases, the constants, structured logging and the checkpoint readers of
``train``.

Names, keys and residue names compare exactly; frames at 1e-5 (float32
matrix products summed in another order); the forward at 1e-4 (float32
convolutions in another order); metrics at 1e-4 relative (the port's pI is
a 64-point search, the JAX package's a bisection, both narrowed to 2^-60).
"""
import json
import logging

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several workers per host
    yield
    torch.set_num_threads(n)


def _maps(n: int, seed: int) -> dict[str, np.ndarray]:
    """A charge map (-1, 0, 1) and a polarity map (0, 1) from ``seed``."""
    rng = np.random.default_rng(seed)
    return {"charge": rng.integers(-1, 2, n), "polarity": rng.integers(0, 2, n)}


def _both(ubq_pdb_gz):
    """1ubq parsed by each package: (port, JAX)."""
    from timed_design_tpu.structure import load_pdb as jax_load_pdb

    from timed_design_tpu_torch.structure import load_pdb

    return load_pdb(ubq_pdb_gz), jax_load_pdb(ubq_pdb_gz)


def _res_names(structure) -> list[str]:
    return [r.res_name for c in structure.chains for r in c.residues]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("prop", ["charge", "polarity"])
def test_modify_structure_with_property_equals_jax(ubq_pdb_gz, prop, seed):
    """The same residue names in both packages, rewritten in place; the
    rewritten sequence's map is the map asked for."""
    from timed_design_tpu.structure import modify_structure_with_property as jax_modify

    from timed_design_tpu_torch.structure import (
        convert_seq_to_property,
        modify_structure_with_property,
    )

    port, jax_s = _both(ubq_pdb_gz)
    pmap = _maps(76, seed)[prop]
    assert modify_structure_with_property(port, pmap, prop) is port
    jax_modify(jax_s, pmap, prop)
    assert _res_names(port) == _res_names(jax_s) != _res_names(_both(ubq_pdb_gz)[0])
    assert convert_seq_to_property(port.sequence1(), prop) == list(pmap)


@pytest.mark.parametrize("prop,value", [("polarity", -1), ("charge", 2)])
def test_modify_structure_refuses_a_map_it_cannot_meet(ubq_pdb_gz, prop, value):
    """A polarity of -1 (ASP is polar) fails the round trip, and a charge of
    2 has no residue: both packages raise the same error."""
    from timed_design_tpu.structure import modify_structure_with_property as jax_modify

    from timed_design_tpu_torch.structure import modify_structure_with_property

    port, jax_s = _both(ubq_pdb_gz)
    pmap = np.zeros(76, np.int64)
    pmap[5] = value
    with pytest.raises((AssertionError, KeyError)) as want:
        jax_modify(jax_s, pmap, prop)
    with pytest.raises(want.type):
        modify_structure_with_property(port, pmap, prop)
    with pytest.raises(ValueError, match="mass"):
        modify_structure_with_property(port, pmap, "mass")


def test_create_residue_map_equals_jax(ubq_pdb_gz, testing_files):
    from timed_design_tpu.structure import create_residue_map as jax_map
    from timed_design_tpu.structure import load_pdb as jax_load_pdb

    from timed_design_tpu_torch.structure import create_residue_map, load_pdb

    port, jax_s = _both(ubq_pdb_gz)
    labels, seq = create_residue_map(port)
    assert (labels, seq) == jax_map(jax_s)
    assert labels[5] == "K6 (Chain A)" and len(seq) == 76
    multi = sorted(testing_files.glob("*.pdb*"))
    for path in multi[:4]:
        assert create_residue_map(load_pdb(path)) == jax_map(jax_load_pdb(path))


@pytest.mark.parametrize("k", [32, 8])
def test_create_map_alphanumeric_code_equals_jax(k):
    """Cache keys equal to the JAX package's for maps holding -1, 0 and 1."""
    from timed_design_tpu.structure import create_map_alphanumeric_code as jax_code

    from timed_design_tpu_torch.structure import create_map_alphanumeric_code

    maps = [[0, 1, -1, 0], [0, 1, 1, 0], [-1] * 5, list(_maps(76, 3)["charge"]),
            list(_maps(76, 3)["polarity"]), np.array([1, 0, -1])]
    keys = [create_map_alphanumeric_code(m, k=k) for m in maps]
    assert keys == [jax_code(m, k=k) for m in maps]
    assert len(set(keys)) == len(keys) and all(len(key) == k for key in keys)


@pytest.mark.parametrize("codec,prop", [("CNOCACBQ", "charge"), ("CNOCACBP", "polarity")])
def test_frames_of_a_rewritten_structure_equal_jax(ubq_pdb_gz, codec, prop):
    """1ubq rewritten to a seeded map, then its frames: the port on the CPU
    against the JAX package, within 1e-5; zeroing the charge map empties
    the Q channel."""
    from timed_design_tpu.structure import modify_structure_with_property as jax_modify
    from timed_design_tpu.voxel import Codec as JCodec
    from timed_design_tpu.voxel import structure_to_frame_atoms as jax_sfa
    from timed_design_tpu.voxel import voxelize_frame_atoms as jax_vfa

    from timed_design_tpu_torch.structure import modify_structure_with_property
    from timed_design_tpu_torch.voxel import Codec, structure_to_frame_atoms, voxelize_frame_atoms

    for pmap in (_maps(76, 7)[prop], np.zeros(76, np.int64)):
        port, jax_s = _both(ubq_pdb_gz)
        c = Codec.from_string(codec)
        got = voxelize_frame_atoms(structure_to_frame_atoms(
            modify_structure_with_property(port, pmap, prop), c), c, device="cpu").numpy()
        jc = JCodec.from_string(codec)
        want = np.asarray(jax_vfa(jax_sfa(jax_modify(jax_s, pmap, prop), jc), jc))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        if prop == "charge" and not pmap.any():
            assert np.abs(got[..., 5]).max() < 1e-6


def test_timed_charge_forward_equals_jax(ubq_pdb_gz):
    """TIMED_Charge at small widths (filters 4, 8), float32: the port's
    forward on the frames of a rewritten 1ubq (CNOCACBQ, six channels)
    against the Flax module's, within 1e-4."""
    import jax

    from timed_design_tpu.models import MODEL_REGISTRY as JAX_REGISTRY

    from timed_design_tpu_torch.models import MODEL_REGISTRY
    from timed_design_tpu_torch.structure import modify_structure_with_property
    from timed_design_tpu_torch.voxel import Codec, structure_to_frame_atoms, voxelize_frame_atoms

    spec = MODEL_REGISTRY["TIMED_Charge"]
    assert spec.codec == JAX_REGISTRY["TIMED_Charge"].codec == "CNOCACBQ"
    port, _ = _both(ubq_pdb_gz)
    c = Codec.from_string(spec.codec)
    frames = voxelize_frame_atoms(structure_to_frame_atoms(
        modify_structure_with_property(port, _maps(76, 11)["charge"], "charge"), c), c,
        device="cpu").numpy()
    flax = JAX_REGISTRY["TIMED_Charge"].constructor(filters=(4, 8))
    v = flax.init(jax.random.key(0), np.zeros((1, 21, 21, 21, 6), np.float32))
    rng = np.random.default_rng(0)
    stats = jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
        v["batch_stats"])
    variables = {"params": jax.tree.map(np.asarray, v["params"]), "batch_stats": stats}
    want = np.asarray(flax.apply(variables, frames, train=False))
    module = spec.build(filters=(4, 8))
    module.load_state_dict(spec.convert(variables))
    with torch.inference_mode():
        got = module.eval()(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (76, 20)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


SEQUENCES = ["GG", "WYC", "KKKKK", "DDDDD", "AAAA", "MKVDEHRWY", "AAKKDD", "GGDDEEKKRR",
             "ACDX", "MQIFVKTLTGKTITLEVEPSDTIENVKAKIQDKEGIPPDQQRLIFAGKQLEDGRTLSDYNIQKESTLHLVLRLRGG"]


@pytest.mark.parametrize("seq", SEQUENCES)
def test_metric_aliases_equal_jax(seq):
    """The reference-named metrics on tests/test_sampling.py's sequences
    (and 1ubq's), within 1e-4 relative; each alias is its element of
    ``sequence_metrics``."""
    import timed_design_tpu.sample as jax_sample

    import timed_design_tpu_torch.sample as sample

    got = sample.calculate_seq_metrics(seq)
    np.testing.assert_allclose(got, jax_sample.calculate_seq_metrics(seq), rtol=1e-4)
    assert got == sample.sequence_metrics(seq)
    assert [sample.sequence_charge(seq), sample.sequence_isoelectric_point(seq),
            sample.sequence_molecular_weight(seq),
            sample.sequence_molar_extinction_280(seq)] == list(got)
    np.testing.assert_allclose(sample.sequence_charge(seq, ph=5.0),
                               jax_sample.sequence_charge(seq, ph=5.0), rtol=1e-4)
    if "X" not in seq:  # the charge vanishes at the pI
        assert abs(sample.sequence_charge(seq, ph=got[1])) < 1e-4


def test_sequence_int_codes_equal_jax():
    from timed_design_tpu.constants import int_to_sequence as jax_decode
    from timed_design_tpu.constants import sequence_to_int as jax_encode

    from timed_design_tpu_torch.constants import int_to_sequence, sequence_to_int

    seq = "MQIFVKTLTGKTITLEVEPSD"
    codes = sequence_to_int(seq)
    assert codes.dtype == np.int32 and np.array_equal(codes, jax_encode(seq))
    assert int_to_sequence(codes) == jax_decode(codes) == seq
    assert int_to_sequence(codes.reshape(3, 7)) == seq


def test_structured_logging(tmp_path, caplog):
    """configure, log_event and close_event_file as the JAX package's, under
    the port's own logger name."""
    from timed_design_tpu_torch.utils.logging import (
        LOGGER_NAME,
        close_event_file,
        configure,
        get_logger,
        log_event,
    )

    assert LOGGER_NAME == "timed_design_tpu_torch"
    events = tmp_path / "events.jsonl"
    logger = configure(level=logging.INFO, event_file=events)
    assert logger is get_logger() and len(logger.handlers) == 1
    configure(level=logging.INFO, event_file=events)  # reconfiguring adds no handler
    assert len(logger.handlers) == 1
    with caplog.at_level(logging.INFO, logger=LOGGER_NAME):
        log_event("predict_done", frames=76, model="TIMED")
    assert "predict_done" in caplog.text
    close_event_file()
    line = json.loads(events.read_text().splitlines()[-1])
    assert line["event"] == "predict_done" and line["frames"] == 76 and "ts" in line
    log_event("after_close", n=1)  # no file: only the log line
    assert len(events.read_text().splitlines()) == 1


def test_train_exports_the_checkpoint_readers():
    """``train`` re-exports the npz readers that ``models`` defines, as the
    JAX package's ``train`` exports its own."""
    import timed_design_tpu.train as jax_train

    import timed_design_tpu_torch.models as models
    import timed_design_tpu_torch.train as train

    for name in ("load_checkpoint_params", "load_checkpoint_build_kwargs"):
        assert hasattr(jax_train, name) and getattr(train, name) is getattr(models, name)
