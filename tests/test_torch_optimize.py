"""PyTorch port, TIMED's BatchNorm folding (``models/optimize.py``) against
the JAX package's ``fold_timed_bn`` and ``timed_inference_apply`` on the
same weights and frames.

Weights are the Flax modules' seeded init with BatchNorm statistics and
scales moved away from the identity, carried across by the port's
converter; the frames are 1ubq's, voxelized by the JAX package. Tolerances,
float32: the folded tensors within 1e-6 of JAX's (the kernels scaled in
float64 in both; each bias map is a float32 convolution summed in another
order); the folded forward within 1e-5 of JAX's and of the port's unfolded
forward, with the same argmax. bfloat16: argmax agreement of at least 0.95
with the unfolded bfloat16 forward.
"""
import numpy as np
import pytest
import torch

REGISTRY = (16, 32, 64, 128)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several workers per host
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ubq_frames(ubq_pdb_gz):
    from timed_design_tpu.structure import load_pdb
    from timed_design_tpu.voxel import Codec, structure_to_frame_atoms, voxelize_frame_atoms

    codec = Codec.from_string("CNOCACB")
    fa = structure_to_frame_atoms(load_pdb(ubq_pdb_gz), codec)
    return np.array(voxelize_frame_atoms(fa, codec), np.float32)


def _timed(filters, n_classes=20, seed=0):
    """(Flax TIMED, variables, port TIMED in eval mode): BatchNorm scale,
    bias, mean and variance moved by seeded noise, so that every folded
    term is exercised."""
    import jax

    from timed_design_tpu.models import timed
    from timed_design_tpu_torch.models import TIMED, flax_variables_to_state_dict

    fm = timed(n_classes=n_classes, filters=filters)
    v = fm.init(jax.random.key(seed), np.zeros((1, 21, 21, 21, 5), np.float32))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    for i in range(len(filters)):
        bn_p, bn_s = params[f"ConvBlock_{i}"]["BatchNorm_0"], stats[f"ConvBlock_{i}"]["BatchNorm_0"]
        shape = bn_s["mean"].shape
        bn_p["scale"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        bn_p["bias"] = rng.normal(0, 0.1, shape).astype(np.float32)
        bn_s["mean"] = rng.normal(0, 0.1, shape).astype(np.float32)
        bn_s["var"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    pm = TIMED(n_classes=n_classes, filters=filters)
    pm.load_state_dict(flax_variables_to_state_dict(variables))
    return fm, variables, pm.eval()


@pytest.mark.parametrize("filters", [(8, 16), REGISTRY], ids=["narrow", "registry"])
def test_fold_matches_jax(filters):
    """Every folded tensor against JAX's, layouts converted (DHWIO ->
    OIDHW, (D, H, W, O) -> (O, D, H, W)); from the module and from its
    state_dict alike."""
    from timed_design_tpu.models.optimize import fold_timed_bn as jax_fold
    from timed_design_tpu_torch.models import fold_timed_bn

    _, v, pm = _timed(filters)
    want, n = jax_fold(v["params"], v["batch_stats"])
    got, n_port = fold_timed_bn(pm)
    assert n_port == n == len(filters)
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        if w.ndim == 5:
            w = w.transpose(4, 3, 0, 1, 2)
        elif w.ndim == 4:
            w = w.transpose(3, 0, 1, 2)
        g = got[name]
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=0, err_msg=name)
    again, _ = fold_timed_bn(pm.state_dict())
    assert all(torch.equal(again[k], got[k]) for k in got)


@pytest.mark.parametrize("n_classes", [20, 338])
@pytest.mark.parametrize("filters", [(8, 16), REGISTRY], ids=["narrow", "registry"])
def test_inference_apply_matches_jax_and_unfolded(filters, n_classes, ubq_frames):
    """The folded forward, float32, on 1ubq's frames (8 at registry widths,
    where the forwards cost more): against JAX's folded forward and the
    port's unfolded module, probabilities and logits."""
    import jax.numpy as jnp

    from timed_design_tpu.models.optimize import fold_timed_bn as jax_fold
    from timed_design_tpu.models.optimize import timed_inference_apply as jax_apply
    from timed_design_tpu_torch.models import fold_timed_bn, timed_inference_apply

    _, v, pm = _timed(filters, n_classes, seed=1)
    x = ubq_frames if filters != REGISTRY else ubq_frames[::9]
    jf, n = jax_fold(v["params"], v["batch_stats"])
    folded, _ = fold_timed_bn(pm)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        got = timed_inference_apply(folded, xt, n).numpy()
        got_logits = timed_inference_apply(folded, xt, n, logits=True).numpy()
        unfolded = pm(xt).numpy()
    want = np.asarray(jax_apply(jf, jnp.asarray(x), n))
    assert got.shape == (x.shape[0], n_classes) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_logits, np.asarray(jax_apply(jf, jnp.asarray(x), n, logits=True)),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, unfolded, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.argmax(1), unfolded.argmax(1))


def test_inference_apply_bfloat16(ubq_frames):
    """In bfloat16 the folded forward keeps the unfolded bfloat16 forward's
    argmax on at least 0.95 of 1ubq's residues, and its head sums in
    float32."""
    from timed_design_tpu_torch.models import fold_timed_bn, timed_inference_apply

    _, _, pm = _timed((8, 16), seed=2)
    pm.compute_dtype = torch.bfloat16
    folded, n = fold_timed_bn(pm)
    xt = torch.from_numpy(ubq_frames)
    with torch.inference_mode():
        got = timed_inference_apply(folded, xt, n, compute_dtype=torch.bfloat16).numpy()
        unfolded = pm(xt).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)
    assert (got.argmax(1) == unfolded.argmax(1)).mean() >= 0.95
    assert np.abs(got - unfolded).max() <= 1e-2


def test_bias_map_varies_at_the_border():
    """A BatchNorm shift b reaches the next convolution as a field that is
    constant inside the frame and smaller at its faces, where 'same'
    padding reads zeros; with b = 0 the fold adds no bias map."""
    from timed_design_tpu_torch.models import fold_timed_bn

    _, _, pm = _timed((4, 4))
    sd = pm.state_dict()
    sd["blocks.1.conv.weight"] = torch.ones_like(sd["blocks.1.conv.weight"])
    sd["blocks.0.bn.bias"] = torch.full_like(sd["blocks.0.bn.bias"], 0.5)
    sd["blocks.0.bn.running_mean"] = torch.zeros_like(sd["blocks.0.bn.running_mean"])
    folded, _ = fold_timed_bn(sd)
    m = folded["bias_map_1"][0]
    assert torch.allclose(m[1:-1, 1:-1, 1:-1], torch.tensor(0.5 * 27 * 4))
    assert torch.allclose(m[0, 1:-1, 1:-1], torch.tensor(0.5 * 18 * 4))
    assert torch.allclose(m[0, 0, 0], torch.tensor(0.5 * 8 * 4))
    sd["blocks.0.bn.bias"] = torch.zeros_like(sd["blocks.0.bn.bias"])
    assert float(fold_timed_bn(sd)[0]["bias_map_1"].abs().max()) == 0.0
