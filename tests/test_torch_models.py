"""PyTorch port, models: TIMED against the Flax TIMED on converted weights.

Inputs are numpy frames from a seed. float32: atol 1e-5 on probabilities
(convolutions summed in another order) and identical argmax. bfloat16:
max |dp| <= 1e-2 against the Flax model in bfloat16 (the two frameworks
round at different places).
"""
import types

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several workers per host
    yield
    torch.set_num_threads(n)


def _flax_timed(n_classes, channels=5, seed=0, **kw):
    """A Flax TIMED with random weights and non-trivial BatchNorm stats."""
    import jax

    from timed_design_tpu.models import timed

    m = timed(n_classes=n_classes, filters=(4, 8), **kw)
    v = m.init(jax.random.key(seed), np.zeros((1, 21, 21, 21, channels), np.float32))
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
        v["batch_stats"],
    )
    return m, {"params": v["params"], "batch_stats": stats}


def _frames(n=6, channels=5, seed=1):
    return np.random.default_rng(seed).random((n, 21, 21, 21, channels), np.float32)


def _port(n_classes, variables, channels=5, dtype=torch.float32):
    from timed_design_tpu_torch.models import TIMED, flax_variables_to_state_dict

    m = TIMED(n_classes=n_classes, filters=(4, 8), in_channels=channels, compute_dtype=dtype)
    m.load_state_dict(flax_variables_to_state_dict(variables))
    return m.eval()


@pytest.mark.parametrize("n_classes", [20, 338])
def test_timed_forward_float32_matches_flax(n_classes):
    fm, v = _flax_timed(n_classes)
    x = _frames()
    want = np.asarray(fm.apply(v, x))
    with torch.inference_mode():
        got = _port(n_classes, v)(torch.from_numpy(x)).numpy()
    assert got.shape == (6, n_classes) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


@pytest.mark.parametrize("n_classes", [20, 338])
def test_timed_forward_bfloat16_matches_flax(n_classes):
    import jax.numpy as jnp

    from timed_design_tpu.models import timed

    _, v = _flax_timed(n_classes)
    fm = timed(n_classes=n_classes, filters=(4, 8), compute_dtype=jnp.bfloat16)
    x = _frames()
    want = np.asarray(fm.apply(v, x))
    with torch.inference_mode():
        got = _port(n_classes, v, dtype=torch.bfloat16)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-2


def test_timed_logits_and_six_channel_input():
    """The property-codec width (6 channels) and the logits output."""
    fm, v = _flax_timed(20, channels=6, seed=3)
    x = _frames(channels=6)
    want = np.asarray(fm.apply(v, x, logits=True))
    with torch.inference_mode():
        got = _port(20, v, channels=6)(torch.from_numpy(x), logits=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_checkpoint_roundtrip_from_jax_save(tmp_path):
    """``Name@ckpt.npz`` written by the JAX trainer's ``save_checkpoint``
    with architecture overrides resolves to the same network."""
    from timed_design_tpu.train.train import save_checkpoint

    from timed_design_tpu_torch.engine.predictor import _resolve_model
    from timed_design_tpu_torch.models import load_checkpoint_build_kwargs

    fm, v = _flax_timed(338, seed=5)
    ckpt = tmp_path / "rot.npz"
    save_checkpoint(types.SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"]),
                    ckpt, build_kwargs={"filters": (4, 8)})
    assert load_checkpoint_build_kwargs(ckpt) == {"filters": (4, 8)}
    module, name = _resolve_model(f"TIMED_rotamer@{ckpt}")
    assert name == "TIMED_rotamer" and module.n_classes == 338
    x = _frames(n=3)
    with torch.inference_mode():
        got = module.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(fm.apply(v, x)), atol=1e-5)


def test_registry_names_and_refusals():
    from timed_design_tpu.models import MODEL_REGISTRY as JAX_REGISTRY

    from timed_design_tpu_torch.engine.predictor import _resolve_model
    from timed_design_tpu_torch.models import MODEL_REGISTRY, get_model_spec, load_model

    assert list(MODEL_REGISTRY) == list(JAX_REGISTRY)
    for name, spec in JAX_REGISTRY.items():
        mine = MODEL_REGISTRY[name]
        assert (mine.n_classes, mine.codec, mine.rotamer) == (spec.n_classes, spec.codec, spec.rotamer)
    widths = {"TIMED_Deep": 6, "TIMED_rotamer_deep": 6, "TIMED_rotamer_not_so_deep": 3}
    for name in list(MODEL_REGISTRY)[:8]:
        m = MODEL_REGISTRY[name].build()
        assert len(m.blocks) == widths.get(name, 4)
        assert m.blocks[0].conv.in_channels == (6 if name in ("TIMED_Charge", "TIMED_Polar") else 5)
    for name in ("ProDCoNN", "DenseNet", "DenseCPD"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            MODEL_REGISTRY[name].build()
    with pytest.raises(NotImplementedError, match="keras_import"):
        load_model("weights/TIMED.h5")
    assert get_model_spec("timed_rotamer").name == "TIMED_rotamer"
    with pytest.raises(KeyError, match="Known"):
        get_model_spec("nope")
    with pytest.raises(ValueError, match="NO weights"):
        _resolve_model("TIMED")
    a, _ = _resolve_model("TIMED", allow_random_weights=True)
    b, _ = _resolve_model("TIMED", allow_random_weights=True)
    torch.testing.assert_close(a.state_dict(), b.state_dict())  # seeded init


def test_spatial_dropout_drops_whole_channels():
    from timed_design_tpu_torch.models.layers import spatial_dropout_3d

    x = torch.ones((4, 3, 3, 3, 16))
    g = torch.Generator().manual_seed(0)
    y = spatial_dropout_3d(x, 0.5, training=True, generator=g)
    per_channel = y.reshape(4, 27, 16)
    assert ((per_channel == 0).all(1) | (per_channel == 2.0).all(1)).all()
    assert 0 < (per_channel[:, 0] == 0).float().mean() < 1
    assert spatial_dropout_3d(x, 0.5, training=False) is x
