"""PyTorch port, voxel layer: frames and the voxelizer against the JAX package.

Both sides get the same 1ubq atom arrays; the port runs on the CPU.
Tolerance 1e-5: float32 matrix products summed in a different order.
"""
import numpy as np
import pytest
import torch

from timed_design_tpu.structure import load_pdb


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several workers per host
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ubq(ubq_pdb_gz):
    return load_pdb(ubq_pdb_gz)


@pytest.mark.parametrize("codec", ["CNOCACB", "CNOCACBQ", "CNOCBCAP"])
def test_frame_atoms_match_jax(ubq, codec):
    from timed_design_tpu.voxel import Codec as JCodec
    from timed_design_tpu.voxel import structure_to_frame_atoms as jax_sfa

    from timed_design_tpu_torch.voxel import Codec, structure_to_frame_atoms

    a = structure_to_frame_atoms(ubq, Codec.from_string(codec))
    b = jax_sfa(ubq, JCodec.from_string(codec))
    assert Codec.from_string(codec).channels == JCodec.from_string(codec).channels
    for field in ("atoms_xyz", "atom_channel", "atom_sigma", "atom_prop", "ca", "rot", "valid"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert (a.labels, a.chain_ids, a.residue_ids) == (b.labels, b.chain_ids, b.residue_ids)


@pytest.mark.parametrize("gaussian", [True, False], ids=["gaussian", "boolean"])
@pytest.mark.parametrize("codec", ["CNOCACB", "CNOCACBQ"])
def test_voxelizer_matches_jax(ubq, codec, gaussian):
    """The port's matmul voxelizer against ``voxelize_matmul``; the Q codec
    in boolean mode covers the signed property-channel clamp."""
    import jax.numpy as jnp

    from timed_design_tpu.ops.matmul_voxelize import voxelize_matmul as jax_vox

    from timed_design_tpu_torch.voxel import Codec, structure_to_frame_atoms, voxelize_frame_atoms

    c = Codec.from_string(codec)
    fa = structure_to_frame_atoms(ubq, c)
    got = voxelize_frame_atoms(fa, c, gaussian=gaussian, device="cpu").numpy()
    prop = c.property_channel
    want = np.asarray(jax_vox(
        *(jnp.asarray(x) for x in (fa.atoms_xyz, fa.atom_channel, fa.atom_sigma,
                                   fa.atom_prop, fa.ca, fa.rot)),
        n_channels=c.n_channels, prop_channel=c.channels.index(prop) if prop else -1,
        gaussian=gaussian,
    ))
    assert got.shape == want.shape == (76, 21, 21, 21, c.n_channels)
    np.testing.assert_allclose(got, want, atol=1e-5)
    if prop and not gaussian:
        assert got[..., -1].min() >= -1.0 and got.max() <= 1.0


def test_voxelizer_matches_golden_frames(ubq, testing_files):
    """The frozen golden frames of the JAX package's voxelizer convention."""
    from timed_design_tpu_torch.voxel import Codec, structure_to_frame_atoms, voxelize_frame_atoms

    golden = np.load(testing_files / "golden_1ubq_frames.npz")
    c = Codec.from_string("CNOCBCA")
    frames = voxelize_frame_atoms(structure_to_frame_atoms(ubq, c), c, device="cpu").numpy()
    np.testing.assert_allclose(frames[0], golden["frame0"], atol=1e-4)
    np.testing.assert_allclose(frames[40], golden["frame40"], atol=1e-4)
    np.testing.assert_allclose(frames.sum(axis=(1, 2, 3, 4)), golden["total"], rtol=1e-4)


def test_voxelizer_chunking_is_invisible(ubq):
    """A chunk that does not divide R gives the same frames."""
    from timed_design_tpu_torch.voxel import Codec, structure_to_frame_atoms, voxelize_frame_atoms

    c = Codec.CNOCACB()
    fa = structure_to_frame_atoms(ubq, c)
    np.testing.assert_allclose(
        voxelize_frame_atoms(fa, c, chunk=16, device="cpu").numpy(),
        voxelize_frame_atoms(fa, c, chunk=7, device="cpu").numpy(), atol=1e-6)


@pytest.mark.parametrize("codec", ["CNOCACB", "CNOCACBQ"])
def test_frames_of_several_structures_in_one_call(ubq, codec):
    """FrameSet.voxelize_rows, a batch's rows from structures of 380, 150
    and 60 atoms in one call (each padded to the largest with dropped
    atoms), equal each structure voxelized alone, row by row."""
    import dataclasses

    from timed_design_tpu_torch.voxel import Codec, structure_to_frame_atoms, voxelize_frame_atoms
    from timed_design_tpu_torch.voxel.dataset import FrameSet

    c = Codec.from_string(codec)
    fa = structure_to_frame_atoms(ubq, c)
    shifted = dataclasses.replace(fa, atoms_xyz=fa.atoms_xyz + np.float32(3.5))
    parts = [fa, dataclasses.replace(shifted, atoms_xyz=shifted.atoms_xyz[:150],
                                     atom_channel=shifted.atom_channel[:150],
                                     atom_sigma=shifted.atom_sigma[:150],
                                     atom_prop=shifted.atom_prop[:150])]
    parts.append(dataclasses.replace(fa, **{k: getattr(fa, k)[:60] for k in (
        "atoms_xyz", "atom_channel", "atom_sigma", "atom_prop")}))
    fs = FrameSet([(f"s{i}", p) for i, p in enumerate(parts)], c)
    alone = [voxelize_frame_atoms(p, c, device="cpu").numpy() for p in parts]
    rng = np.random.default_rng(5)
    structure = rng.integers(0, 3, 40)
    row = rng.integers(0, 76, 40)
    got = fs.voxelize_rows(structure, row, torch.device("cpu")).numpy()
    want = np.stack([alone[s][r] for s, r in zip(structure, row)])
    assert len({len(p.atom_channel) for p in parts}) == 3 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------- the scatter voxelizer

SCATTER_CASES = [("integral", True), ("pdf", True), ("integral", False)]


@pytest.mark.parametrize("spread,gaussian", SCATTER_CASES, ids=["integral", "pdf", "boolean"])
@pytest.mark.parametrize("codec", ["CNOCACB", "CNOCACBQ", "CNOCACBP"])
def test_scatter_voxelizer_matches_jax(ubq, codec, spread, gaussian):
    """``voxelize_frame_atoms(impl="scatter")`` against the JAX package's,
    each codec, gaussian (both spreads) and boolean; 1e-6: float32 weights
    added in another order."""
    from timed_design_tpu.voxel import Codec as JCodec
    from timed_design_tpu.voxel import voxelize_frame_atoms as jax_vfa

    from timed_design_tpu_torch.voxel import Codec, structure_to_frame_atoms, voxelize_frame_atoms

    c = Codec.from_string(codec)
    fa = structure_to_frame_atoms(ubq, c)
    got = voxelize_frame_atoms(fa, c, gaussian=gaussian, impl="scatter", spread=spread,
                               device="cpu").numpy()
    want = np.asarray(jax_vfa(fa, JCodec.from_string(codec), gaussian=gaussian,
                              impl="scatter", spread=spread))
    assert got.shape == want.shape == (76, 21, 21, 21, c.n_channels)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("gaussian", [True, False], ids=["gaussian", "boolean"])
@pytest.mark.parametrize("codec", ["CNOCACB", "CNOCACBQ"])
def test_scatter_voxelizer_matches_matmul(ubq, codec, gaussian):
    """The port's two formulations agree within 2e-5 (the JAX package's pin
    in tests/test_voxel.py), chunked or not."""
    from timed_design_tpu_torch.voxel import Codec, structure_to_frame_atoms, voxelize_frame_atoms

    c = Codec.from_string(codec)
    fa = structure_to_frame_atoms(ubq, c)
    matmul = voxelize_frame_atoms(fa, c, gaussian=gaussian, device="cpu").numpy()
    for chunk in (None, 7):
        scatter = voxelize_frame_atoms(fa, c, gaussian=gaussian, chunk=chunk, impl="scatter",
                                       device="cpu").numpy()
        np.testing.assert_allclose(scatter, matmul, rtol=0, atol=2e-5)


def test_voxelizer_impl_rule(ubq):
    """JAX's rule: a spread other than "integral" takes the scatter path
    even where the matmul one is asked for; the pdf spread differs from the
    integral below 2e-3 (tests/test_voxel.py's pin); an unknown impl or
    spread raises."""
    from timed_design_tpu_torch.voxel import Codec, structure_to_frame_atoms, voxelize_frame_atoms

    c = Codec.CNOCACB()
    fa = structure_to_frame_atoms(ubq, c)
    pdf = voxelize_frame_atoms(fa, c, spread="pdf", device="cpu")
    assert torch.equal(pdf, voxelize_frame_atoms(fa, c, impl="scatter", spread="pdf",
                                                 device="cpu"))
    integral = voxelize_frame_atoms(fa, c, device="cpu")
    gap = float((pdf - integral).abs().max())
    assert 0 < gap < 2e-3
    with pytest.raises(ValueError, match="impl"):
        voxelize_frame_atoms(fa, c, impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="spread"):
        voxelize_frame_atoms(fa, c, impl="scatter", spread="box", device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("spread,gaussian", SCATTER_CASES, ids=["integral", "pdf", "boolean"])
def test_scatter_voxelizer_on_card(spread, gaussian):
    """The scatter voxelizer on the card against itself on the CPU (1e-6:
    atomic adds in another order) and against the card's matmul one (2e-5),
    on 1ubq with the Q codec."""
    from pathlib import Path

    from timed_design_tpu_torch.structure import load_pdb as port_load_pdb
    from timed_design_tpu_torch.voxel import Codec, structure_to_frame_atoms, voxelize_frame_atoms

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ubq_path = Path(__file__).resolve().parent / "testing_files" / "1ubq.pdb1.gz"
    c = Codec.from_string("CNOCACBQ")
    fa = structure_to_frame_atoms(port_load_pdb(ubq_path), c)
    card = voxelize_frame_atoms(fa, c, gaussian=gaussian, impl="scatter", spread=spread,
                                device="cuda").cpu()
    cpu = voxelize_frame_atoms(fa, c, gaussian=gaussian, impl="scatter", spread=spread,
                               device="cpu")
    torch.testing.assert_close(card, cpu, rtol=0, atol=1e-6)
    if spread == "integral":
        matmul = voxelize_frame_atoms(fa, c, gaussian=gaussian, device="cuda").cpu()
        torch.testing.assert_close(card, matmul, rtol=0, atol=2e-5)
