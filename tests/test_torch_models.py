"""PyTorch port, models: TIMED, ProDCoNN, DenseNet and DenseCPD against the
Flax modules on converted weights.

Inputs are numpy frames from a seed. float32: atol 1e-5 on probabilities
(convolutions summed in another order) and identical argmax. bfloat16:
max |dp| <= 1e-2 against the Flax model in bfloat16 (the two frameworks
round at different places), and the argmax agreement rate with float32.
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


def test_registry_names_and_refusals(tmp_path):
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
    for name, cls in (("ProDCoNN", "ProDCoNN"), ("DenseNet", "DenseNet3D"),
                      ("DenseCPD", "DenseNet3D")):
        m = MODEL_REGISTRY[name].build()
        assert type(m).__name__ == cls and m.n_classes == 20
    assert len(MODEL_REGISTRY["DenseNet"].build().layers) == 12
    assert len(MODEL_REGISTRY["DenseCPD"].build().layers) == 18
    # a Keras path: FileNotFoundError where it is missing (as the JAX
    # package's load_model), else the graph it stores, named by its stem
    with pytest.raises(FileNotFoundError, match="weights/TIMED.h5"):
        load_model("weights/TIMED.h5")
    from timed_design_tpu_torch.models import KerasH5Model, export_timed_to_h5, timed
    from timed_design_tpu_torch.train.train import flax_variables

    tree = flax_variables(timed(filters=(4,)))
    h5 = export_timed_to_h5(tree["params"], tree["batch_stats"], tmp_path / "TIMED.h5")
    imported = load_model(h5)
    assert isinstance(imported, KerasH5Model) and imported.name == "TIMED"
    assert imported.n_classes == 20 and imported.compute_dtype == torch.float32
    assert load_model(h5, compute_dtype=torch.bfloat16).compute_dtype == torch.bfloat16
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


# Narrow widths of the DenseNet family: two blocks (one transition), and
# three blocks (two transitions, DenseCPD's depth) as Flax DenseNet3D.
NARROW = {"DenseNet": {"growth_rate": 4, "block_layers": (2, 2), "init_features": 8},
          "DenseCPD": {"growth_rate": 4, "block_layers": (2, 1, 2), "init_features": 6},
          # registry DenseNet: channel prefixes of 36, 48, ..., rows not 16-byte aligned
          "DenseNet-registry": {"growth_rate": 12, "block_layers": (4, 4, 4),
                                "init_features": 24}}


def _flax_family(name, seed=0, dtype=None):
    """A Flax module of ``name`` (narrow DenseNet widths) with random weights
    and non-trivial BatchNorm stats, and its variables."""
    import jax
    import jax.numpy as jnp

    from timed_design_tpu.models import densenet as jax_densenet
    from timed_design_tpu.models import prodconn as jax_prodconn

    kw = {} if dtype is None else {"compute_dtype": dtype}
    m = jax_prodconn(**kw) if name == "ProDCoNN" else jax_densenet(**NARROW[name], **kw)
    v = m.init(jax.random.key(seed), np.zeros((1, 21, 21, 21, 5), np.float32))
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
        v.get("batch_stats", {}))
    return m, {"params": jax.tree.map(np.asarray, v["params"]), "batch_stats": stats}, jnp


def _port_family(name, variables, dtype=torch.float32):
    from timed_design_tpu_torch.models import MODEL_REGISTRY, DenseNet3D, ProDCoNN

    m = (ProDCoNN(compute_dtype=dtype) if name == "ProDCoNN"
         else DenseNet3D(**NARROW[name], compute_dtype=dtype))
    m.load_state_dict(MODEL_REGISTRY[name.split("-")[0]].convert(variables))
    return m.eval()


@pytest.mark.parametrize("name", ["ProDCoNN", "DenseNet", "DenseCPD", "DenseNet-registry"])
def test_family_forward_float32_matches_flax(name):
    fm, v, _ = _flax_family(name)
    x = _frames(n=8)
    want = np.asarray(fm.apply(v, x))
    want_logits = np.asarray(fm.apply(v, x, logits=True))
    with torch.inference_mode():
        m = _port_family(name, v)
        got = m(torch.from_numpy(x)).numpy()
        got_logits = m(torch.from_numpy(x), logits=True).numpy()
    assert got.shape == (8, 20) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got_logits, want_logits, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_prodconn_flattens_in_the_flax_layout():
    """Dense_0's rows follow Flax's NDHWC flatten: a kernel that reads one
    (d, h, w, c) feature reads the same feature in the port."""
    fm, v, _ = _flax_family("ProDCoNN", seed=2)
    k = np.zeros_like(v["params"]["Dense_0"]["kernel"])
    d, h, w, c = 1, 4, 2, 37
    k[((d * 6 + h) * 6 + w) * 64 + c, 0] = 1.0
    v["params"]["Dense_0"]["kernel"] = k
    x = _frames(n=3, seed=4)
    want = np.asarray(fm.apply(v, x, logits=True))
    with torch.inference_mode():
        got = _port_family("ProDCoNN", v)(torch.from_numpy(x), logits=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("name", ["ProDCoNN", "DenseNet", "DenseCPD"])
def test_family_forward_bfloat16(name):
    """bfloat16 convolutions: within 1e-2 of Flax in bfloat16, and the
    argmax of at least 90% of 24 frames agrees with float32."""
    _, v, jnp = _flax_family(name, seed=1)
    fm, _, _ = _flax_family(name, seed=1, dtype=jnp.bfloat16)
    x = _frames(n=24, seed=5)
    want = np.asarray(fm.apply(v, x))
    with torch.inference_mode():
        got = _port_family(name, v, dtype=torch.bfloat16)(torch.from_numpy(x)).numpy()
        f32 = _port_family(name, v)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-2
    assert (got.argmax(1) == f32.argmax(1)).mean() >= 0.9


def test_registry_widths_equal_flax():
    """At registry widths every new family has Flax's parameter shapes,
    under the converter's names."""
    import jax

    from timed_design_tpu.models import MODEL_REGISTRY as JAX_REGISTRY

    from timed_design_tpu_torch.models import MODEL_REGISTRY

    for name in ("ProDCoNN", "DenseNet", "DenseCPD"):
        shapes = jax.eval_shape(JAX_REGISTRY[name].build().init, jax.random.key(0),
                                jax.ShapeDtypeStruct((1, 21, 21, 21, 5), np.float32))
        zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), dict(shapes))
        sd = MODEL_REGISTRY[name].convert(zeros)
        want = {k: tuple(t.shape) for k, t in MODEL_REGISTRY[name].build().state_dict().items()}
        assert {k: tuple(t.shape) for k, t in sd.items()} == want


@pytest.mark.parametrize("name", ["ProDCoNN", "DenseNet"])
def test_family_checkpoint_roundtrip_from_jax_save(tmp_path, name):
    """``Name@ckpt.npz`` written by the JAX trainer's ``save_checkpoint``
    (with the narrow widths as build overrides) loads through the family's
    converter to the same network."""
    from timed_design_tpu.train.train import save_checkpoint

    from timed_design_tpu_torch.engine.predictor import _resolve_model

    fm, v, _ = _flax_family(name, seed=6)
    ckpt = tmp_path / f"{name}.npz"
    save_checkpoint(types.SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"]),
                    ckpt, build_kwargs=None if name == "ProDCoNN" else NARROW[name])
    module, got_name = _resolve_model(f"{name}@{ckpt}")
    assert got_name == name and module.n_classes == 20
    x = _frames(n=3)
    with torch.inference_mode():
        got = module.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(fm.apply(v, x)), atol=1e-5)
