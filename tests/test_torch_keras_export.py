"""PyTorch port, Keras ``.h5`` export (``models/keras_export.py``) and
``td-train --init_from/--output X.h5``, against the JAX package.

The port writes its files with its own HDF5 writer (``io/hdf5.py``); h5py,
the JAX importer and TF's Keras read them here. Tolerances:
  - the file against the JAX exporter's of the same tree: the same groups,
    datasets, attributes (values and stored types), JSON and arrays, exact;
  - forwards in float32: 1e-5 (TF's: 2e-5 plus 1e-4 relative, the pin of
    ``tests/test_keras_export.py``); imported trees exact;
  - ``td-train`` in both packages from one ``.h5``: every step's loss to
    1e-4, as ``tests/test_torch_train.py::test_td_train_cli_matches_jax``,
    dropout off on both sides.
"""
import importlib
import re

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several workers per host
    yield
    torch.set_num_threads(n)


def _frames(n=3, seed=0):
    return np.random.default_rng(seed).random((n, 21, 21, 21, 5), np.float32)


def _flax_tree(n_classes=20, filters=(4, 8), seed=0):
    """A Flax TIMED's numpy ``{"params", "batch_stats"}`` from ``seed``, its
    BatchNorm statistics moved off 0/1."""
    import jax

    from timed_design_tpu.models import timed

    v = timed(n_classes=n_classes, filters=filters).init(
        jax.random.key(seed), np.zeros((1, 21, 21, 21, 5), np.float32))
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape)
                         .astype(np.float32), v["batch_stats"])
    return {"params": jax.tree.map(np.asarray, v["params"]), "batch_stats": stats}


def _module(tree, n_classes=20, filters=(4, 8)):
    from timed_design_tpu_torch.models import TIMED, flax_variables_to_state_dict

    m = TIMED(n_classes=n_classes, filters=filters)
    m.load_state_dict(flax_variables_to_state_dict(tree))
    return m.eval()


def _forward(model, x) -> np.ndarray:
    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy()


def _h5py_contents(path) -> dict:
    """Every object of an h5py file: path -> (kind, attrs, dtype, shape,
    data), attributes as (stored dtype, value)."""
    import h5py

    out = {}

    def attrs(obj):
        return {k: (str(obj.attrs.get_id(k).dtype), np.asarray(obj.attrs[k]).tolist())
                for k in obj.attrs}

    with h5py.File(path, "r") as f:
        out["/"] = ("group", attrs(f), None, None, None)

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = ("dataset", attrs(obj), str(obj.dtype), obj.shape, obj[()])
            else:
                out[name] = ("group", attrs(obj), None, None, None)

        f.visititems(visit)
    return out


@pytest.mark.parametrize("n_classes", [20, 338])
def test_export_equals_jax_export(tmp_path, n_classes):
    """The port's file and the JAX exporter's, of one tree, read by h5py:
    the same objects, attributes with their stored types (``S64``
    ``weight_names`` and ``layer_names``, variable-length strings), the
    same ``model_config`` JSON and the same arrays."""
    from timed_design_tpu.models.keras_export import export_timed_to_h5 as jax_export

    from timed_design_tpu_torch.models import export_timed_to_h5

    tree = _flax_tree(n_classes, seed=n_classes)
    a = jax_export(tree["params"], tree["batch_stats"], tmp_path / "jax.h5", n_classes=n_classes)
    b = export_timed_to_h5(tree["params"], tree["batch_stats"], tmp_path / "port.h5",
                           n_classes=n_classes)
    want, got = _h5py_contents(a), _h5py_contents(b)
    assert list(got) == list(want)
    assert "model_weights/conv3d_0/conv3d_0/kernel:0" in got
    for name, (kind, attrs, dtype, shape, data) in want.items():
        g = got[name]
        assert g[:4] == (kind, attrs, dtype, shape), name
        if kind == "dataset":
            assert np.array_equal(g[4], data), name
    assert want["/"][1]["model_config"][0] == "object"  # a variable-length string


def test_port_export_reads_everywhere(tmp_path):
    """The port's export of a trained module's tree: the JAX importer and
    the port's own predict what the module predicts (1e-5), and both
    ``import_timed_params`` give the tree back exactly."""
    import jax

    from timed_design_tpu.models import load_keras_model as jax_load
    from timed_design_tpu.models.keras_import import import_timed_params as jax_tree

    from timed_design_tpu_torch.models import (
        export_timed_to_h5,
        import_timed_params,
        load_keras_model,
    )
    from timed_design_tpu_torch.train.train import flax_variables

    module = _module(_flax_tree(seed=3))
    tree = flax_variables(module)
    path = export_timed_to_h5(tree["params"], tree["batch_stats"], tmp_path / "TIMED.h5")
    x = _frames(seed=4)
    want = _forward(module, x)
    np.testing.assert_allclose(np.asarray(jax.jit(jax_load(path))(x)), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(_forward(load_keras_model(path).eval(), x), want, atol=1e-5,
                               rtol=0)
    flat = dict(jax.tree_util.tree_leaves_with_path(tree))
    for got in (import_timed_params(path), jax_tree(path)):
        leaves = dict(jax.tree_util.tree_leaves_with_path(got))
        assert leaves.keys() == flat.keys()
        assert all(np.array_equal(np.asarray(leaves[k]), v) for k, v in flat.items())


@pytest.mark.parametrize("loader", ["tf_keras", "keras3"])
def test_port_export_loads_in_tensorflow(tmp_path, loader):
    """TF's ``load_model`` (the Keras 2 and the Keras 3 loader) reads the
    port's file and predicts what the module predicts."""
    tf = pytest.importorskip("tensorflow")
    keras = pytest.importorskip("tf_keras") if loader == "tf_keras" else tf.keras

    from timed_design_tpu_torch.models import export_timed_to_h5
    from timed_design_tpu_torch.train.train import flax_variables

    module = _module(_flax_tree(seed=5))
    tree = flax_variables(module)
    path = export_timed_to_h5(tree["params"], tree["batch_stats"], tmp_path / "TIMED.h5")
    x = _frames(seed=6)
    kmodel = keras.models.load_model(str(path), compile=False)
    np.testing.assert_allclose(kmodel.predict(x, verbose=0), _forward(module, x), atol=2e-5,
                               rtol=1e-4)


# ----------------------------------------------------------------- td-train

def test_td_train_h5_matches_jax(tmp_path, monkeypatch, ubq_pdb_gz):
    """``td-train --init_from x.h5 --output y.h5`` in both packages on the
    JAX package's HDF5 file of 1ubq: TIMED at widths (8, 16) warm-started
    from one Keras file (the JAX exporter's), float32, batch 32, one epoch of
    three steps shuffled from seed 5, dropout off on both sides. Every
    step's loss to 1e-4; the port's ``y.h5`` loads in the JAX importer and
    predicts what the port's trained module predicts (1e-5), and its tree is
    the module's."""
    import jax

    import timed_design_tpu.train.train as jax_train
    from timed_design_tpu.cli.train import main as jax_main
    from timed_design_tpu.models import load_keras_model as jax_load
    from timed_design_tpu.models.keras_export import export_timed_to_h5 as jax_export
    from timed_design_tpu.parallel import make_mesh
    from timed_design_tpu.voxel import make_frame_dataset

    import timed_design_tpu_torch.train.train as port_train
    from timed_design_tpu_torch.cli.train import main
    from timed_design_tpu_torch.models import import_timed_params

    for pkg in ("timed_design_tpu", "timed_design_tpu_torch"):
        monkeypatch.setattr(importlib.import_module(f"{pkg}.models.timed"), "spatial_dropout_3d",
                            lambda x, *a, **k: x)
    monkeypatch.setattr(jax_train, "make_mesh", lambda: make_mesh(n_data=1))
    losses = {"jax": [], "port": []}
    jax_step, port_step = jax_train.make_train_step, port_train.make_train_step

    def jax_recording(module, optimizer, class_weights=None):
        step = jax_step(module, optimizer, class_weights)

        def run(state, xb, yb, rng):
            new, m = step(state, xb, yb, rng)
            jax.debug.callback(lambda loss: losses["jax"].append(float(loss)), m["loss"])
            return new, m
        return run

    def port_recording(module, optimizer, class_weights=None):
        step = port_step(module, optimizer, class_weights)

        def run(xb, yb, generator=None):
            m = step(xb, yb, generator)
            losses["port"].append(float(m["loss"]))
            return m
        return run

    monkeypatch.setattr(jax_train, "make_train_step", jax_recording)
    monkeypatch.setattr(port_train, "make_train_step", port_recording)
    data = make_frame_dataset([ubq_pdb_gz], tmp_path / "ubq.hdf5")
    tree = _flax_tree(filters=(8, 16), seed=21)
    init = jax_export(tree["params"], tree["batch_stats"], tmp_path / "init.h5")
    argv = ["--path_to_dataset", str(data), "--model", "TIMED", "--filters", "8,16",
            "--batch_size", "32", "--epochs", "1", "--learning_rate", "5e-4", "--seed", "5",
            "--bn_momentum", "0.9", "--init_from", str(init)]
    jax_main(argv + ["--output", str(tmp_path / "jax.h5")])
    state = main(argv + ["--output", str(tmp_path / "port.h5"), "--device", "cpu"])
    assert len(losses["port"]) == len(losses["jax"]) == 3
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=0, atol=1e-4)
    x = _frames(seed=7)
    want = _forward(state.module.eval(), x)
    np.testing.assert_allclose(np.asarray(jax.jit(jax_load(tmp_path / "port.h5"))(x)), want,
                               atol=1e-5, rtol=0)
    got = dict(jax.tree_util.tree_leaves_with_path(import_timed_params(tmp_path / "port.h5")))
    mine = dict(jax.tree_util.tree_leaves_with_path(port_train.flax_variables(state.module)))
    assert got.keys() == mine.keys() and all(np.array_equal(got[k], mine[k]) for k in mine)
    # the JAX package's y.h5 reads in the port as well
    assert import_timed_params(tmp_path / "jax.h5").keys() == {"params", "batch_stats"}


def test_td_train_refuses_a_non_timed_h5_output_before_any_step(tmp_path, monkeypatch,
                                                                ubq_pdb_gz):
    """``--model ProDCoNN --output y.h5`` exits with the JAX CLI's message,
    word for word, before ``fit`` is called, and writes nothing."""
    import timed_design_tpu.cli.train as jax_cli
    from timed_design_tpu.voxel import make_frame_dataset

    import timed_design_tpu_torch.train as port_train
    from timed_design_tpu_torch.cli.train import main

    def no_fit(*a, **k):
        raise AssertionError("fit was called")

    monkeypatch.setattr(importlib.import_module("timed_design_tpu.train"), "fit", no_fit)
    monkeypatch.setattr(port_train, "fit", no_fit)
    data = make_frame_dataset([ubq_pdb_gz], tmp_path / "ubq.hdf5")
    argv = ["--path_to_dataset", str(data), "--model", "ProDCoNN", "--output",
            str(tmp_path / "y.h5")]
    with pytest.raises(SystemExit) as want:
        jax_cli.main(argv)
    with pytest.raises(SystemExit) as got:
        main(argv + ["--device", "cpu"])
    assert re.search("Keras .h5 export covers the linear TIMED family only", str(got.value))
    assert str(got.value) == str(want.value)
    assert not (tmp_path / "y.h5").exists()
