"""PyTorch port, Keras ``.h5`` import (``models/keras_import.py``): the port's
importer against the JAX package's and against TF's own forward, on graphs
that TF writes in both serializations (``tf_keras``: the Keras 2 layout of
the releases; ``tf.keras``: Keras 3's legacy h5). The release files are not
in the repository, so seeded graphs stand in for them.

Tolerances:
  - weights read from a file, the imported Flax tree: exact;
  - forwards in float32: the JAX importer's to 1e-5 max abs (convolutions
    summed in another order); TF's to 2e-5 plus 1e-4 relative (the pin of
    ``tests/test_keras_import.py``), 2e-4 on the fuzzed graphs (the pin of
    ``tests/test_keras_import_fuzz.py``);
  - bfloat16: argmax agreement with the JAX importer >= 0.99 on 1ubq (cuDNN
    and the CPU round a bf16 convolution's output, JAX keeps float32);
  - quantized forwards: as ``tests/test_torch_quantize.py`` holds the zoo:
    argmax equal, 1e-5, activation codes that differ counted;
  - the int8 rewrites: exact, against a float64 ``F.conv3d`` of the codes;
  - ``td-predict`` files: as ``tests/test_torch_predict.py`` compares them;
    ``/design``: JAX's probabilities to 1e-5 and, fed JAX's uniforms, the
    plain sampler gives JAX's codes.
Where the JAX importer departs from Keras (a multi-axis Softmax, ReLU at
its threshold, ``"gelu"``, global pooling with ``keepdims``) the port is
held to TF.

``python tests/test_torch_keras.py`` rewrites the card fixtures in
``tests/testing_files/keras/`` (``write_card_fixtures``), which
``chip_smoke.py`` reads on the card, where there is no TF.
"""
import functools
import gzip
import json
import threading
import urllib.request
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

FIXTURES = Path(__file__).resolve().parent / "testing_files" / "keras"
FIXTURE_SEED = 20261017
SERIALIZATIONS = ("tf_keras", "keras3")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several workers per host
    yield
    torch.set_num_threads(n)


def _keras(serialization: str):
    """The Keras module that writes ``serialization``; skips without TF."""
    tf = pytest.importorskip("tensorflow")
    # grappler's Pad+Conv3D fusion rounds away from TF's own unfused graph
    # (tests/test_keras_import_fuzz.py)
    tf.config.optimizer.set_experimental_options({"remapping": False})
    return pytest.importorskip("tf_keras") if serialization == "tf_keras" else tf.keras


# --------------------------------------------------------------- the graphs

def _timed_like(keras, n_classes=20, filters=(8, 16, 16)):
    """[Conv3D-ELU-BN] blocks, SpatialDropout, 1x1x1 conv, GAP, softmax."""
    m = keras.Sequential()
    m.add(keras.layers.Input(shape=(21, 21, 21, 5)))
    for f in filters:
        m.add(keras.layers.Conv3D(f, 3, padding="same"))
        m.add(keras.layers.ELU())
        m.add(keras.layers.BatchNormalization())
    m.add(keras.layers.SpatialDropout3D(0.1))
    m.add(keras.layers.Conv3D(n_classes, 1, padding="same"))
    m.add(keras.layers.GlobalAveragePooling3D())
    m.add(keras.layers.Softmax())
    return m


def _functional(keras):
    """The graph of tests/test_keras_import.py: branches, merges, pooling,
    a Dense head."""
    L = keras.layers
    inp = L.Input(shape=(21, 21, 21, 5))
    a = L.Conv3D(8, 3, padding="same", activation="relu")(inp)
    b = L.Conv3D(8, 1, padding="same", activation="elu")(inp)
    x = L.Concatenate()([a, b])
    x = L.BatchNormalization()(x)
    x = L.Activation("relu")(x)
    y = L.Conv3D(16, 3, padding="same")(x)
    x = L.Conv3D(16, 1, padding="same")(x)
    x = L.Add()([x, y])
    x = L.MaxPooling3D(2)(x)
    x = L.AveragePooling3D(2, padding="same")(x)
    x = L.Flatten()(x)
    x = L.Dense(32, activation="relu")(x)
    x = L.Dropout(0.5)(x)
    x = L.Dense(20, activation="softmax")(x)
    return keras.Model(inp, x)


def _prodconn_like(keras):
    """The ProDCoNN-like graph of tests/test_keras_import_legacy.py."""
    L = keras.layers
    inp = L.Input(shape=(21, 21, 21, 5))
    a = L.Conv3D(8, 3, padding="valid", activation="relu")(inp)
    b = L.Conv3D(8, 5, padding="valid", activation="relu")(L.ZeroPadding3D(1)(inp))
    x = L.Concatenate()([a, b])
    x = L.Cropping3D(1)(x)
    x = L.MaxPooling3D(2)(x)
    x = L.Flatten()(x)
    x = L.Dense(64, activation="relu")(x)
    x = L.Dense(20, activation="softmax")(x)
    return keras.Model(inp, x)


def _geometry(keras):
    """Narrow and branching, every convolution geometry the int8 kernel
    does not take itself: strided, dilated, even-kernel and non-cubic
    'same' convolutions (asymmetric padding), a strided 'valid' one after
    an asymmetric ZeroPadding3D, 'same' pooling with even windows."""
    L = keras.layers
    inp = L.Input(shape=(21, 21, 21, 5))
    a = L.Conv3D(6, 2, strides=2, padding="same", activation="elu")(inp)  # 11^3
    b = L.Conv3D(6, 3, dilation_rate=2, padding="same")(inp)
    b = L.BatchNormalization()(b)
    b = L.MaxPooling3D(2, padding="same")(b)  # 11^3
    x = L.Concatenate()([a, b])
    c = L.Conv3D(8, (2, 4, 3), padding="same", activation="relu")(x)
    d = L.ZeroPadding3D(((1, 0), (0, 2), (1, 1)))(x)
    d = L.Conv3D(8, 4, strides=(1, 2, 3), padding="valid")(d)  # 9, 5, 4
    d = L.UpSampling3D((1, 2, 3))(d)  # 9, 10, 12
    d = L.Cropping3D(((0, 0), (0, 1), (1, 2)))(d)  # 9^3
    c = L.AveragePooling3D(3, strides=1, padding="valid")(c)  # 9^3
    x = L.Add()([c, d])
    x = L.Conv3D(12, 1, padding="same")(x)
    x = L.GlobalAveragePooling3D()(x)
    x = L.Dense(20, activation="softmax")(x)
    return keras.Model(inp, x)


GRAPHS = {
    "timed": _timed_like,
    "functional": _functional,
    "prodconn": _prodconn_like,
    "geometry": _geometry,
    "head338": functools.partial(_timed_like, n_classes=338),
}


def _seed_weights(model, rng):
    """Every weight from ``rng``: kernels N(0, 1/fan_in), biases N(0, 0.1),
    BatchNorm gamma N(1, 0.2), beta N(0, 0.2), moving mean N(0, 0.5) and
    variance U(0.5, 2), so that the BatchNorm statistics count."""
    for layer in model.layers:
        ws = layer.get_weights()
        if not ws:
            continue
        if type(layer).__name__ == "BatchNormalization":
            shape = ws[0].shape
            ws = [rng.normal(1.0, 0.2, shape), rng.normal(0.0, 0.2, shape),
                  rng.normal(0.0, 0.5, shape), rng.uniform(0.5, 2.0, shape)]
        else:
            ws = [rng.normal(0.0, 1.0 / np.sqrt(np.prod(w.shape[:-1])), w.shape) if w.ndim > 1
                  else rng.normal(0.0, 0.1, w.shape) for w in ws]
        layer.set_weights([np.asarray(w, np.float32) for w in ws])


def _save(keras, model, path: Path) -> Path:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "HDF5 is a legacy format"
        model.save(str(path))
    return path


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(graph, serialization) -> (path, TF model), each written once."""
    root = tmp_path_factory.mktemp("keras")

    @functools.cache
    def make(graph: str, serialization: str):
        keras = _keras(serialization)
        model = GRAPHS[graph](keras)
        _seed_weights(model, np.random.default_rng(len(graph)))
        return _save(keras, model, root / f"{graph}_{serialization}.h5"), model

    return make


def _frames(n=4, seed=0, shape=(21, 21, 21, 5)):
    return np.random.default_rng(seed).random((n, *shape), np.float32)


def _port(path, dtype=torch.float32):
    from timed_design_tpu_torch.models import load_keras_model

    return load_keras_model(path, compute_dtype=dtype).eval()


def _run_port(model, x) -> np.ndarray:
    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy()


def _run_jax(path, x, dtype="float32") -> np.ndarray:
    import jax
    import jax.numpy as jnp

    from timed_design_tpu.models import load_keras_model

    return np.asarray(jax.jit(load_keras_model(path, getattr(jnp, dtype)))(jnp.asarray(x)))


@pytest.fixture(scope="module")
def ubq_frames(ubq_pdb_gz):
    """1ubq's 76 frames, voxelized by the JAX package."""
    from timed_design_tpu.structure import load_pdb
    from timed_design_tpu.voxel import Codec, structure_to_frame_atoms, voxelize_frame_atoms

    codec = Codec.from_string("CNOCACB")
    fa = structure_to_frame_atoms(load_pdb(ubq_pdb_gz), codec)
    return np.array(voxelize_frame_atoms(fa, codec), np.float32)


# ------------------------------------------------------------ reading files

@pytest.mark.parametrize("serialization", SERIALIZATIONS)
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_read_weights_equal_jax(saved, graph, serialization):
    """``_read_weights`` over the port's HDF5 reader equals the JAX
    importer's over h5py: the same layers, short names and arrays."""
    import h5py

    from timed_design_tpu.models.keras_import import _read_weights as jax_read

    from timed_design_tpu_torch.io import hdf5
    from timed_design_tpu_torch.models.keras_import import _read_weights

    path, _ = saved(graph, serialization)
    with h5py.File(path, "r") as f:
        want = jax_read(f)
    with hdf5.File(path) as f:
        got = _read_weights(f)
    assert list(got) == list(want) and want
    for layer, ws in want.items():
        assert list(got[layer]) == list(ws), layer
        for k, w in ws.items():
            assert got[layer][k].dtype == w.dtype and np.array_equal(got[layer][k], w), (layer, k)


# --------------------------------------------------------------- forwards

@pytest.mark.parametrize("serialization", SERIALIZATIONS)
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_import_matches_jax_and_tf(saved, graph, serialization):
    """float32 forward of four seeded frames: the JAX importer's to 1e-5,
    TF's ``predict`` to 2e-5 + 1e-4 relative; ``n_classes`` and the name
    (the file's stem) as the JAX importer gives them."""
    from timed_design_tpu.models import load_keras_model as jax_load

    path, kmodel = saved(graph, serialization)
    x = _frames(seed=3)
    model = _port(path)
    got = _run_port(model, x)
    want = _run_jax(path, x)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, kmodel.predict(x, verbose=0), atol=2e-5, rtol=1e-4)
    assert model.n_classes == jax_load(path).n_classes == (338 if graph == "head338" else 20)
    assert model.name == path.stem and model.compute_dtype == torch.float32


FUZZ_PER_FORMAT = 55  # as tests/test_keras_import_fuzz.py: 110 graphs
FUZZ_TIER1 = 10  # the first seeds of each serialization run in Tier-1
FUZZ = [pytest.param(s, base + i, marks=() if i < FUZZ_TIER1 else pytest.mark.slow,
                     id=f"{s}-{base + i}")
        for s, base in (("keras3", 1000), ("tf_keras", 2000)) for i in range(FUZZ_PER_FORMAT)]


@pytest.mark.parametrize("serialization,seed", FUZZ)
def test_fuzzed_graph_matches_jax_and_tf(tmp_path, serialization, seed):
    """The random DAGs of ``tests/test_keras_import_fuzz.py`` (the same
    generator and seeds): the JAX importer's output to 1e-5, TF's to that
    file's 2e-4."""
    keras = _keras(serialization)
    import tensorflow as tf
    from test_keras_import_fuzz import ATOL, _random_graph, _randomize_bn

    rng = np.random.default_rng(seed)
    tf.keras.utils.set_random_seed(seed)
    model, channels = _random_graph(keras, rng)
    _randomize_bn(keras, model, rng)
    path = _save(keras, model, tmp_path / f"fuzz_{seed}.h5")
    x = rng.random((4, 21, 21, 21, channels)).astype(np.float32)
    got = _run_port(_port(path), x)
    layers = [type(layer).__name__ for layer in model.layers]
    np.testing.assert_allclose(got, _run_jax(path, x), atol=1e-5, rtol=0, err_msg=str(layers))
    np.testing.assert_allclose(got, model.predict(x, verbose=0), atol=ATOL, rtol=0,
                               err_msg=str(layers))


def _divergence_model(keras, case: str):
    """A small graph on (6, 6, 6, 3) inputs around one layer where the JAX
    importer departs from Keras."""
    L = keras.layers
    inp = L.Input(shape=(6, 6, 6, 3))
    if case == "softmax_two_axes":
        x = L.Softmax(axis=[2, 3])(L.Conv3D(4, 1)(inp))
    elif case == "relu_threshold":
        x = L.Concatenate()([L.ReLU(threshold=0.5)(inp),
                             L.ReLU(threshold=0.5, negative_slope=0.2, max_value=0.75)(inp)])
    elif case == "gelu":
        x = L.Conv3D(4, 1, activation="gelu")(inp)
    else:  # global pooling with keepdims
        x = L.Conv3D(4, 1)(L.GlobalAveragePooling3D(keepdims=True)(inp))
    return keras.Model(inp, L.Flatten()(x))


DIVERGENCES = ("softmax_two_axes", "relu_threshold", "gelu", "keepdims")


@pytest.mark.parametrize("serialization", SERIALIZATIONS)
@pytest.mark.parametrize("case", DIVERGENCES)
def test_divergences_held_to_tf(tmp_path, case, serialization):
    """Where the JAX importer departs from Keras, the port does what Keras
    does: its output within 1e-6 of TF's, where the JAX importer's is not
    (softmax over its first axis only, ``x >= threshold``, the tanh
    ``gelu``; without the unit dims of ``keepdims`` it fails). The ReLU
    inputs hold values exactly at the threshold."""
    keras = _keras(serialization)
    model = _divergence_model(keras, case)
    _seed_weights(model, np.random.default_rng(5))
    path = _save(keras, model, tmp_path / f"{case}.h5")
    x = np.random.default_rng(6).normal(0.0, 2.0, (3, 6, 6, 6, 3)).astype(np.float32)
    x[:, ::2, ::3] = 0.5
    want = model.predict(x, verbose=0)
    got = _run_port(_port(path), x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    try:
        jax_out = _run_jax(path, x)
    except (TypeError, ValueError, IndexError):
        return  # keepdims: the JAX importer's Conv3D meets a (B, C) input
    assert np.abs(jax_out - want).max() > 1e-5


def test_bf16_argmax_agrees_with_jax(saved, ubq_frames):
    """bfloat16 on 1ubq's 76 frames, TIMED-like: argmax agreement with the
    JAX importer in bfloat16 >= 0.99, and with the port's float32."""
    path, _ = saved("timed", "tf_keras")
    got = _run_port(_port(path, torch.bfloat16), ubq_frames)
    want = _run_jax(path, ubq_frames, "bfloat16")
    f32 = _run_port(_port(path), ubq_frames)
    assert got.dtype == np.float32 and got.shape == (76, 20)
    assert (got.argmax(1) == want.argmax(1)).mean() >= 0.99
    assert (got.argmax(1) == f32.argmax(1)).mean() >= 0.99


def _codes_of(x32) -> np.ndarray:
    x32 = np.asarray(x32, np.float32)
    s = np.maximum(np.float32(np.abs(x32).max()) / np.float32(127.0),
                   np.finfo(np.float32).tiny).astype(np.float32)
    return np.clip(np.round(x32 / s), -127, 127)


@pytest.mark.parametrize("mode", ["w8", "int8-fake", "int8"])
def test_quantized_import_matches_jax(saved, ubq_frames, mode, monkeypatch):
    """The geometry graph under ``--quantize`` on 1ubq (one batch of 76 in
    both packages), float32: against the JAX importer under its
    ``quantize_fn`` (what its ``Predictor(..., quantize=)`` runs), argmax
    equal and 1e-5; every convolution quantized in both, the activation codes
    that differ counted; in ``int8`` each of the 5 convolutions goes through
    the geometry rewrite to the integer convolution."""
    import jax
    import jax.numpy as jnp

    import timed_design_tpu.models.quantize as jq
    from timed_design_tpu.models import load_keras_model as jax_load

    import timed_design_tpu_torch.models.quantize as tq

    path, _ = saved("geometry", "tf_keras")
    jmodel, pm = jax_load(path), _port(path)
    jax_inputs, port_inputs, rewritten = [], [], []
    real_gate, real_activation, real_any = jq._quantized_conv, tq.quantize_activation, \
        tq.conv3d_int8_any

    def gate(mode_, call):
        jax.debug.callback(lambda a: jax_inputs.append(np.asarray(a, np.float32)), call["lhs"],
                           ordered=True)
        return real_gate(mode_, call)

    def activation(x):
        port_inputs.append(x.float().permute(0, 2, 3, 4, 1).numpy().copy())
        return real_activation(x)

    def any_geometry(*args, **kw):
        rewritten.append(args[2:5])
        return real_any(*args, **kw)

    monkeypatch.setattr(jq, "_quantized_conv", gate)
    monkeypatch.setattr(tq, "quantize_activation", activation)
    monkeypatch.setattr(tq, "conv3d_int8_any", any_geometry)
    optimize = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", False)  # XLA's int8 emulation, faster
    try:
        want = np.asarray(jax.jit(jq.quantize_fn(jmodel.apply, mode))(
            jmodel.weights, jnp.asarray(ubq_frames)))
    finally:
        jax.config.update("jax_disable_most_optimizations", optimize)
    with torch.inference_mode(), tq.quantized_convs(mode):
        got = pm(torch.from_numpy(ubq_frames)).numpy()
    assert got.shape == want.shape == (76, 20)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert len(jax_inputs) == 5
    assert len(rewritten) == (5 if mode == "int8" else 0)
    if mode != "w8":
        assert len(port_inputs) == 5
        differ = sum(int((_codes_of(a) != _codes_of(b)).sum())
                     for a, b in zip(jax_inputs, port_inputs))
        assert differ <= 1e-5 * sum(a.size for a in jax_inputs)
    with torch.inference_mode():
        base = pm(torch.from_numpy(ubq_frames)).numpy()
    assert np.abs(got - base).max() > 0  # the mode did quantize


# -------------------------------------------------------- the int8 rewrites

# (x (D, H, W, C), w (N, kd, kh, kw), padding pairs, stride, dilation)
REWRITES = {
    "even_same": ((7, 7, 7, 5), (6, 2, 2, 2), ((0, 1),) * 3, 1, 1),
    "stride2_same": ((9, 8, 7, 5), (6, 3, 3, 3), ((1, 1), (0, 1), (1, 1)), 2, 1),
    "dilated_same": ((9, 9, 9, 4), (4, 3, 3, 3), ((2, 2),) * 3, 1, 2),
    "noncubic_same": ((7, 6, 5, 8), (3, 2, 4, 3), ((0, 1), (1, 2), (1, 1)), (1, 2, 2), 1),
    "2d_like": ((1, 9, 9, 6), (5, 1, 3, 3), ((0, 0), (2, 2), (1, 1)), (1, 2, 1), (1, 2, 1)),
    "valid_stride3": ((10, 10, 10, 5), (4, 4, 4, 4), 0, 3, 1),
    "1d_like": ((1, 1, 12, 3), (7, 1, 1, 5), ((0, 0), (0, 0), (2, 2)), 1, 1),
    "zoo_same": ((6, 6, 6, 5), (8, 3, 3, 3), 1, 1, 1),
}


def _rewrite_case(name: str):
    """Codes from a seed: ``xq`` (2, D, H, W, C), ``wq`` (N, kd, kh, kw, C)."""
    xs, ws, padding, stride, dilation = REWRITES[name]
    rng = np.random.default_rng(len(name))
    xq = torch.from_numpy(rng.integers(-127, 128, (2, *xs)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (*ws, xs[-1])).astype(np.int8))
    return xq, wq, padding, stride, dilation


def _float64_conv(xq, wq, padding, stride, dilation) -> torch.Tensor:
    """The int32 sums by a float64 ``F.conv3d`` of the codes (exact)."""
    import torch.nn.functional as F

    from timed_design_tpu_torch.models.quantize import pad_channels_last, pad_pairs

    x = pad_channels_last(xq.to(torch.float64), pad_pairs(padding))
    out = F.conv3d(x.permute(0, 4, 1, 2, 3), wq.to(torch.float64).permute(0, 4, 1, 2, 3),
                   stride=stride, dilation=dilation)
    return out.permute(0, 2, 3, 4, 1).to(torch.int32)


@pytest.mark.parametrize("name", list(REWRITES))
def test_int8_rewrites_are_exact(name):
    """``conv3d_int8_any``'s rewrite onto the kernel's contract (cubic k,
    symmetric padding, stride 1) gives the int32 sums of the convolution it
    replaces, exactly; with a scale and a bias, the plain epilogue on them.
    On the CPU no kernel launches."""
    from timed_design_tpu_torch.models.quantize import conv3d_int8_any
    from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8

    xq, wq, padding, stride, dilation = _rewrite_case(name)
    want = _float64_conv(xq, wq, padding, stride, dilation)
    launches = conv3d_int8.launches
    got = conv3d_int8_any(xq, wq, padding, stride, dilation)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    scale = torch.from_numpy(np.random.default_rng(1).uniform(1e-5, 1e-4, wq.shape[0])
                             .astype(np.float32))
    bias = torch.linspace(-1, 1, wq.shape[0]).to(torch.bfloat16)
    fused = conv3d_int8_any(xq, wq, padding, stride, dilation, scale, bias, torch.bfloat16)
    assert torch.equal(fused, want.to(torch.float32).mul_(scale).to(torch.bfloat16) + bias)
    assert conv3d_int8.launches == launches


def test_quantized_conv3d_names_the_layer_it_cannot_take():
    """A convolution whose rewrite the kernel cannot take (k^3 C 127^2 past
    an int32 once a dilation makes k 7) raises a ValueError naming the layer
    and the shapes; nothing falls back to a floating-point convolution."""
    from timed_design_tpu_torch.models.quantize import quantized_conv3d

    x = torch.ones((1, 400, 7, 7, 7))
    w = torch.ones((2, 400, 3, 3, 3))
    with pytest.raises(ValueError, match=r"conv3d_9 of x \(1, 400, 7, 7, 7\).*overflow"):
        quantized_conv3d("int8", x, w, None, 0, 1, 3, name="conv3d_9")
    assert quantized_conv3d("int8-fake", x, w, None, 0, 1, 3).shape == (1, 2, 1, 1, 1)


# -------------------------------------------------- the TIMED parameter tree

@pytest.mark.parametrize("serialization", SERIALIZATIONS)
def test_import_timed_params_equals_jax(saved, serialization):
    """The Flax tree of a TIMED-shaped file equals the JAX importer's, leaf
    for leaf, and the port's TIMED with it predicts as the imported graph."""
    import jax

    from timed_design_tpu.models.keras_import import import_timed_params as jax_import

    from timed_design_tpu_torch.models import TIMED, flax_variables_to_state_dict
    from timed_design_tpu_torch.models.keras_import import import_timed_params

    path, _ = saved("timed", serialization)
    got, want = import_timed_params(path), jax_import(path)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert flat_got.keys() == flat_want.keys()
    for k, w in flat_want.items():
        assert flat_got[k].dtype == np.float32 and np.array_equal(flat_got[k], np.asarray(w)), k
    m = TIMED(filters=(8, 16, 16))
    m.load_state_dict(flax_variables_to_state_dict(got))
    x = _frames(2, seed=4)
    np.testing.assert_allclose(_run_port(m.eval(), x), _run_port(_port(path), x), atol=1e-6)


def _refused_model(keras, case: str):
    L = keras.layers
    if case == "branching":
        return _functional(keras)
    m = keras.Sequential([L.Input(shape=(21, 21, 21, 5))])
    m.add(L.Conv3D(4, 3, padding="same", use_bias=case != "no_bias"))
    m.add(L.ELU())
    m.add(L.BatchNormalization())
    if case != "no_projection":
        m.add(L.Conv3D(20, 1, padding="same"))
    m.add(L.GlobalAveragePooling3D())
    return m


@pytest.mark.parametrize("case", ["branching", "no_projection", "no_bias"])
def test_import_timed_params_refuses_as_jax(tmp_path, case):
    """A graph that does not map onto the TIMED tree raises the JAX
    importer's ValueError, word for word."""
    from timed_design_tpu.models.keras_import import import_timed_params as jax_import

    from timed_design_tpu_torch.models.keras_import import import_timed_params

    keras = _keras("tf_keras")
    path = _save(keras, _refused_model(keras, case), tmp_path / f"{case}.h5")
    with pytest.raises(ValueError) as want:
        jax_import(path)
    with pytest.raises(ValueError) as got:
        import_timed_params(path)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------ td-predict, /design

@pytest.fixture(scope="module")
def release_files(tmp_path_factory):
    """``TIMED.h5`` and ``TIMED_rotamer.h5`` written by ``tf_keras`` (the
    releases' layout), filters (4, 8), seeded weights, the heads scaled by 2
    away from near-uniform rows. Not by 8: at rows peaked to 0.5 the JAX
    importer's float32 pooling over 9261 voxels drifts 1.4e-4 from a float64
    forward (the port's, 7e-7), past the 1e-5 the files are held to."""
    keras = _keras("tf_keras")
    d = tmp_path_factory.mktemp("release")
    out = {}
    for name, n in (("TIMED", 20), ("TIMED_rotamer", 338)):
        model = _timed_like(keras, n, (4, 8))
        _seed_weights(model, np.random.default_rng(n))
        head = [layer for layer in model.layers if type(layer).__name__ == "Conv3D"][-1]
        k, b = head.get_weights()
        head.set_weights([k * 2, b])
        out[name] = _save(keras, model, d / f"{name}.h5")
    return out


@pytest.mark.parametrize("rotamer", [False, True], ids=["20_class", "rotamer"])
def test_td_predict_h5_matches_jax(tmp_path, ubq_pdb_gz, release_files, rotamer):
    """``td-predict --voxelize --path_to_model X.h5`` in both packages on
    1ubq, float32, batch 32: every file as ``tests/test_torch_predict.py``
    compares them, the outputs named by the file's stem."""
    from test_torch_predict import BATCH, _compare_runs
    from test_torch_predict import _run_jax as predict_jax
    from test_torch_predict import _run_port as predict_port

    name = "TIMED_rotamer" if rotamer else "TIMED"
    argv = ["--voxelize", "--path_to_dataset", str(ubq_pdb_gz), "--batch_size", str(BATCH),
            "--path_to_model", str(release_files[name])]
    argv += ["--predict_rotamers"] if rotamer else []
    predict_jax(argv, tmp_path / "jax")
    predict_port(argv, tmp_path / "port")
    assert (tmp_path / "port" / f"{name}.fasta").exists()
    _compare_runs(tmp_path / "jax", tmp_path / "port", rotamer=rotamer)


def _post(url, data: bytes):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def test_design_on_h5_matches_jax(ubq_pdb_gz, release_files):
    """``td-serve --model TIMED_rotamer.h5 --device cpu`` (float32, batch
    80, no coalescing) answers ``/design`` with 100 samples: the JAX
    package's ``DesignSession`` probabilities to 1e-5 (the payload rounds to
    6 decimals), the model and codec named by the file's stem; fed JAX's
    uniforms, the plain sampler on the port's tempered probabilities gives
    the codes of JAX's ``sample_sequences_with_metrics``."""
    import jax

    from timed_design_tpu.constants import compress_rotamer_probs as jax_compress
    from timed_design_tpu.engine import DesignSession as JaxSession
    from timed_design_tpu.sample.sampler import apply_temperature as jax_temperature
    from timed_design_tpu.sample.sampler import sample_sequences_with_metrics as jax_ssm

    from timed_design_tpu_torch.cli.serve import build_designers, build_parser, make_server
    from timed_design_tpu_torch.constants import ROTAMER_TO_AA
    from timed_design_tpu_torch.ops.sample import sample_codes_plain
    from timed_design_tpu_torch.sample.sampler import apply_temperature

    h5 = str(release_files["TIMED_rotamer"])
    designers = build_designers(build_parser().parse_args([
        "--model", h5, "--compute_dtype", "float32", "--batch_size", "80", "--device", "cpu",
        "--no-coalesce"]))
    assert list(designers) == ["TIMED_rotamer"]
    d = designers["TIMED_rotamer"]
    server = make_server(d, "127.0.0.1", 0, "TIMED_rotamer")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    pdb_text = gzip.decompress(ubq_pdb_gz.read_bytes()).decode()
    try:
        status, body = _post(f"http://127.0.0.1:{server.server_address[1]}/design", json.dumps(
            {"pdb": pdb_text, "n_samples": 100, "temperature": 0.5, "seed": 7}).encode())
        probs, _ = d.session.design(ubq_pdb_gz)
    finally:
        server.shutdown()
        server.server_close()
        d.close()
        th.join(timeout=10)
    assert status == 200 and body["model"] == "TIMED_rotamer" and body["rotamer_head"] is True
    assert len(body["samples"]) == 100
    want, _ = JaxSession(h5, compute_dtype="float32", batch_size=80).design(ubq_pdb_gz)
    want = np.asarray(want)
    assert probs.shape == want.shape == (76, 338)
    np.testing.assert_allclose(probs, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.array(body["probabilities"]), np.asarray(jax_compress(want)),
                               atol=1e-5, rtol=0)
    key = jax.random.key(7)
    want_codes, _ = jax_ssm(key, jax_temperature(want, 0.5), 100, rotamer_mode=True)
    u = np.asarray(jax.random.uniform(key, (100, 76, 1)))[..., 0]
    codes, _ = sample_codes_plain(apply_temperature(torch.from_numpy(probs), 0.5),
                                  torch.from_numpy(u),
                                  torch.from_numpy(ROTAMER_TO_AA.astype(np.uint8)))
    np.testing.assert_array_equal(codes.long().numpy(), np.asarray(want_codes))


# ------------------------------------------------------------ card fixtures

def _fixture_frames() -> np.ndarray:
    """The fixtures' inputs: four frames from ``FIXTURE_SEED``."""
    return np.random.default_rng(FIXTURE_SEED).random((4, 21, 21, 21, 5), np.float32)


def write_card_fixtures(dest: Path = FIXTURES) -> list[Path]:
    """The geometry graph with weights from ``FIXTURE_SEED``, written by
    ``tf_keras`` and by ``tf.keras``, and TF's predictions on
    ``_fixture_frames`` beside each: ``geometry_{serialization}.h5`` and
    ``.npy``."""
    dest.mkdir(parents=True, exist_ok=True)
    out = []
    for serialization in SERIALIZATIONS:
        keras = _keras(serialization)
        model = _geometry(keras)
        _seed_weights(model, np.random.default_rng(FIXTURE_SEED))
        path = _save(keras, model, dest / f"geometry_{serialization}.h5")
        np.save(path.with_suffix(".npy"), model.predict(_fixture_frames(), verbose=0))
        out.append(path)
    return out


@pytest.mark.parametrize("serialization", SERIALIZATIONS)
def test_card_fixtures_repredict(serialization):
    """The committed fixtures: TF loads each file and predicts the stored
    ``.npy`` again (1e-6); the port's float32 forward on the CPU is within
    1e-5 of it, as ``chip_smoke.py`` holds the card to 1e-4."""
    keras = _keras(serialization)
    path = FIXTURES / f"geometry_{serialization}.h5"
    stored = np.load(path.with_suffix(".npy"))
    x = _fixture_frames()
    kmodel = keras.models.load_model(str(path), compile=False)
    np.testing.assert_allclose(kmodel.predict(x, verbose=0), stored, atol=1e-6, rtol=0)
    np.testing.assert_allclose(_run_port(_port(path), x), stored, atol=1e-5, rtol=0)
    assert stored.shape == (4, 20)


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(REWRITES))
def test_int8_rewrites_on_the_kernel_equal_plain(name, cuda_device):
    """Each rewritten convolution launches the kernel once, and its int32
    sums and its fused bf16 epilogue equal the plain version on a CPU copy
    (``torch.equal``)."""
    from timed_design_tpu_torch.models.quantize import conv3d_int8_any
    from timed_design_tpu_torch.ops.conv3d_int8 import conv3d_int8

    xq, wq, padding, stride, dilation = _rewrite_case(name)
    scale = torch.full((wq.shape[0],), 3e-5)
    bias = torch.linspace(-1, 1, wq.shape[0]).to(torch.bfloat16)
    for extra in ((), (scale, bias, torch.bfloat16)):
        launches = conv3d_int8.launches
        got = conv3d_int8_any(xq.to(cuda_device), wq.to(cuda_device), padding, stride, dilation,
                              *(t.to(cuda_device) if isinstance(t, torch.Tensor) else t
                                for t in extra))
        torch.cuda.synchronize()
        assert conv3d_int8.launches == launches + 1
        assert torch.equal(got.cpu(), conv3d_int8_any(xq, wq, padding, stride, dilation, *extra))


if __name__ == "__main__":
    for p in write_card_fixtures():
        print(p, p.stat().st_size)
