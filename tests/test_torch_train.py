"""PyTorch port, training: ``timed_design_tpu_torch/train/`` against the JAX
package's ``train/`` on the same numpy inputs from a seed, on the CPU.

Tolerances, float32 on both sides unless a test says otherwise:
  - one train step: loss, top-1 and top-3 to 1e-5; BatchNorm running
    statistics to 1e-6; every gradient element to 1e-4 of the largest |g|
    of the whole gradient (in max norm over all leaves, not each leaf's
    own: a bias ahead of a BatchNorm has a true gradient of 0, or nearly,
    and holds rounding noise). TIMED and DenseNet, convolutional up to
    their global pooling, take the step on 9^3 frames: float32 sums over
    B x 21^3 = 55,566 positions carry more rounding than these tolerances
    in each framework (against a float64 computation of the same TIMED
    step at 21^3, JAX's trunk gradients are off by up to 3e-3 of their
    leaf, and a running variance by 4e-6). ProDCoNN, which flattens, takes
    21^3 frames;
  - parameters after Adam steps: Adam's first step is lr * sign(g), so an
    element whose gradient is within rounding noise of 0 moves by +-lr in
    either framework. Elements whose |g| (JAX) exceeds 1e-3 of the largest
    are held to 1e-6; the others to 2 * lr * steps;
  - ``fit``: per-step losses to 1e-4; restored weights to 2 * lr * steps;
  - ``evaluate``: 1e-5; learning-rate schedules: optax's float32 values to
    1e-6 relative; frames 1e-5 and labels exactly; checkpoints read by the
    other package: probabilities to 1e-5; weight converters: exact.

Dropout cannot match across frameworks (JAX draws threefry masks, the port
a torch generator), so every parity test runs with dropout off on both
sides: TIMED with ``dropout_rate=0.0``; ProDCoNN, whose Flax Dropout has no
knob, with ``flax.linen.Dropout.__call__`` patched to the identity and the
port's rate 0. The port's masks are held to Keras semantics on their own.
"""
import math
import re
import shutil

import numpy as np
import pytest
import torch

LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several workers per host
    yield
    torch.set_num_threads(n)


def _frames(n, seed, channels=5, side=21):
    return np.random.default_rng(seed).random((n, side, side, side, channels), np.float32)


def _onehot(labels, n_classes=20):
    return np.eye(n_classes, dtype=np.float32)[np.asarray(labels)]


# Small widths of each family, built the same way in both packages.
NARROW_DENSENET = {"growth_rate": 4, "block_layers": (2, 2), "init_features": 8}


def _jax_module(name, **kw):
    from timed_design_tpu.models import densenet, prodconn, timed

    if name == "TIMED":
        return timed(filters=(8, 16), dropout_rate=0.0, **kw)
    if name == "ProDCoNN":
        return prodconn(**kw)
    return densenet(**NARROW_DENSENET, **kw)


def _port_module(name, dtype=torch.float32, **kw):
    from timed_design_tpu_torch.models import TIMED, DenseNet3D, ProDCoNN

    if name == "TIMED":
        return TIMED(filters=(8, 16), dropout_rate=0.0, compute_dtype=dtype, **kw)
    if name == "ProDCoNN":
        return ProDCoNN(dropout_rate=0.0, compute_dtype=dtype, **kw)
    return DenseNet3D(**NARROW_DENSENET, compute_dtype=dtype, **kw)


def _variables(module, seed):
    """Flax init from ``seed``, the BatchNorm statistics moved off their
    0/1 start so that the running update is tested on both of its terms."""
    import jax

    v = module.init(jax.random.key(seed), np.zeros((1, 21, 21, 21, 5), np.float32))
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
        v.get("batch_stats", {}))
    return {"params": jax.tree.map(np.asarray, v["params"]), "batch_stats": stats}


def _load(module, variables):
    from timed_design_tpu_torch.train.train import _layout

    module.load_state_dict(_layout(module)[1](variables))
    return module


def _leaves(tree, prefix=""):
    from timed_design_tpu_torch.train.train import _flatten

    return {k: np.asarray(v) for k, v in _flatten(tree, prefix).items()}


def _port_grads(module):
    """The gradients of the last step in Flax layout."""
    from timed_design_tpu_torch.train.train import _layout

    sd = dict(module.state_dict())
    sd.update({n: p.grad for n, p in module.named_parameters()})
    return _layout(module)[0](sd)["params"]


@pytest.fixture
def no_flax_dropout(monkeypatch):
    """Flax's Dropout as the identity (ProDCoNN's rate is fixed at 0.2)."""
    import flax.linen as fnn

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)


def _jax_step(module, variables, x, y, class_weights=None, lr=LR):
    """The JAX package's make_train_step, and JAX's gradients of the same
    loss (value_and_grad of the step's own loss on the same inputs)."""
    import jax
    import jax.numpy as jnp
    import optax

    from timed_design_tpu.train import TrainState, make_train_step

    opt = optax.adam(lr)
    state = TrainState(variables["params"], variables["batch_stats"],
                       opt.init(variables["params"]), jnp.zeros((), jnp.int32))
    new, metrics = jax.jit(make_train_step(module, opt, class_weights))(
        state, jnp.asarray(x), jnp.asarray(y), jax.random.key(0))

    def loss_fn(params):
        out, _ = module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              x, train=True, logits=True, rngs={"dropout": jax.random.key(0)},
                              mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy(out, y)
        if class_weights is None:
            return ce.mean()
        w = y @ jnp.asarray(class_weights, jnp.float32)
        return (ce * w).sum() / jnp.maximum(w.sum(), 1e-9)

    grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    return new, {k: float(v) for k, v in metrics.items()}, jax.tree.map(np.asarray, grads)


def _port_step(module, x, y, class_weights=None, lr=LR):
    from timed_design_tpu_torch.train import init_train_state, make_train_step

    state = init_train_state(module, lr, device="cpu")
    step = make_train_step(module, state.optimizer, class_weights)
    metrics = step(torch.from_numpy(x), torch.from_numpy(y))
    return {k: float(v) for k, v in metrics.items()}


def _assert_step_matches(module, new, metrics, want_metrics, grads, lr=LR, steps=1):
    from timed_design_tpu_torch.train.train import flax_variables

    for k in ("loss", "top1", "top3"):
        assert abs(metrics[k] - want_metrics[k]) <= 1e-5, (k, metrics[k], want_metrics[k])
    got_g, want_g = _leaves(_port_grads(module)), _leaves(grads)
    assert set(got_g) == set(want_g)
    scale = max(float(np.abs(w).max()) for w in want_g.values())
    for k, w in want_g.items():
        err = float(np.abs(got_g[k] - w).max())
        assert err <= 1e-4 * scale, f"grad {k}: {err:.3g} (largest |g| {scale:.3g})"
    mine = flax_variables(module)
    for k, w in _leaves(new.batch_stats).items():
        np.testing.assert_allclose(_leaves(mine["batch_stats"])[k], w, rtol=0, atol=1e-6,
                                   err_msg=f"batch_stats {k}")
    got_p = _leaves(mine["params"])
    for k, w in _leaves(new.params).items():
        tol = np.where(np.abs(want_g[k]) > 1e-3 * scale, 1e-6, 2 * lr * steps)
        bad = np.abs(got_p[k] - np.asarray(w)) > tol
        assert not bad.any(), f"param {k}: {int(bad.sum())} elements off"


# ------------------------------------------------------------ datasetmap

def _split_map():
    from timed_design_tpu_torch.io import DatasetMap

    entries = [(pdb, "A", str(r), "ALA") for pdb in ("1abc", "2def", "3ghi", "4jkl", "5mno")
               for r in range(4)]
    entries += [(f"6nmr_{i}", "A", "1", "GLY") for i in range(4)]
    entries += [("ts_02x", "B", "1", "ALA"), ("ts", "A", "1", "ALA")]
    return DatasetMap(entries=entries)


@pytest.mark.parametrize("val_fraction,seed", [(0.34, 3), (0.5, 0), (0.2, 7), (0.0, 0)])
def test_split_dataset_map_equals_jax(val_fraction, seed):
    """Entry for entry, with NMR states kept together and a mid-string
    ``_0`` not read as a state."""
    from timed_design_tpu.io import DatasetMap as JaxMap
    from timed_design_tpu.io.datasetmap import split_dataset_map as jax_split

    from timed_design_tpu_torch.io import split_dataset_map

    dmap = _split_map()
    got = split_dataset_map(dmap, val_fraction, seed=seed)
    want = jax_split(JaxMap(entries=list(dmap.entries)), val_fraction, seed=seed)
    for g, w in zip(got, want):
        assert g.entries == w.entries
    assert {e[0][:4] for e in got[0].entries}.isdisjoint({e[0][:4] for e in got[1].entries})
    if val_fraction == 0.0:
        assert got[0] is dmap and got[1].entries == []


def test_split_dataset_map_refusals():
    from timed_design_tpu_torch.io import DatasetMap, split_dataset_map

    dmap = _split_map()
    for bad in (0.99, 1.0, -0.1):
        with pytest.raises(ValueError, match="val_fraction"):
            split_dataset_map(dmap, bad)
    with pytest.raises(ValueError, match="per-residue"):
        split_dataset_map(DatasetMap(counts=[("1abcA", 3)]), 0.5)


# ---------------------------------------------------------- batch source

@pytest.fixture(scope="module")
def two_structures(tmp_path_factory, ubq_pdb_gz):
    """1ubq and its residues 1-30 as a second structure."""
    import gzip

    d = tmp_path_factory.mktemp("torch_train_pdbs")
    shutil.copy(ubq_pdb_gz, d / "1ubq.pdb1.gz")
    atoms = [l for l in gzip.decompress(ubq_pdb_gz.read_bytes()).decode().splitlines()
             if l.startswith("ATOM") and int(l[22:26]) <= 30]
    (d / "2cut.pdb").write_text("\n".join(atoms + ["END"]) + "\n")
    return sorted(d.glob("*.pdb*"))


def test_shuffled_batches_equal_jax_loader(tmp_path, two_structures):
    """FrameBatchSource(shuffle=True) against FrameBatchLoader(shuffle=True)
    over the JAX package's HDF5 of the same PDB files: two epochs, batch by
    batch, X to 1e-5 and y exactly; the two epochs' orders differ."""
    from timed_design_tpu.io import FrameBatchLoader
    from timed_design_tpu.io import create_flat_dataset_map as jax_map
    from timed_design_tpu.voxel import make_frame_dataset

    from timed_design_tpu_torch.voxel import FrameBatchSource, create_flat_dataset_map, make_frame_set

    h5 = make_frame_dataset(two_structures, tmp_path / "d.hdf5")
    jmap, _ = jax_map(h5)
    fs = make_frame_set(two_structures)
    dmap = create_flat_dataset_map(fs)
    assert dmap.entries == jmap.entries
    loader = FrameBatchLoader(h5, jmap, batch_size=32, shuffle=True, shuffle_seed=3)
    source = FrameBatchSource(fs, dmap, 32, device="cpu", shuffle=True, shuffle_seed=3)
    firsts = []
    for _ in range(2):
        got, want = list(source), list(loader)
        assert len(got) == len(want) == 4
        for (X, y, n), (Xw, yw, nw) in zip(got, want):
            assert n == nw
            np.testing.assert_allclose(X.numpy(), Xw, rtol=0, atol=1e-5)
            np.testing.assert_array_equal(y, yw)
        firsts.append(got[0][1])
    assert not np.array_equal(firsts[0], firsts[1])


def test_shuffle_refuses_start_batch(two_structures):
    from timed_design_tpu_torch.voxel import FrameBatchSource, create_flat_dataset_map, make_frame_set

    fs = make_frame_set(two_structures[:1])
    with pytest.raises(ValueError, match="start_batch"):
        FrameBatchSource(fs, create_flat_dataset_map(fs), 32, start_batch=1, device="cpu",
                         shuffle=True)


# ------------------------------------------------------------- train step

@pytest.mark.parametrize("name", ["TIMED", "ProDCoNN", "DenseNet"])
def test_train_step_matches_jax(name, no_flax_dropout):
    """One step from the same weights on the same 8 frames: loss, metrics,
    gradients, BatchNorm running statistics and the parameters after Adam.
    TIMED runs with bn_momentum 0.1, so the running statistics take 90% of
    the batch's: an unbiased running variance, n/(n-1) = 1 + 1.7e-4 larger
    at 8 x 9^3 values a channel, misses 1e-6."""
    kw = {"bn_momentum": 0.1} if name == "TIMED" else {}
    jm = _jax_module(name, **kw)
    v = _variables(jm, seed=1)
    x = _frames(8, seed=2, side=21 if name == "ProDCoNN" else 9)
    y = _onehot([0, 3, 3, 7, 19, 12, 1, 2])
    new, want, grads = _jax_step(jm, v, x, y)
    module = _load(_port_module(name, **kw), v)
    got = _port_step(module, x, y)
    _assert_step_matches(module, new, got, want, grads)


def test_weighted_train_step_matches_jax():
    """TIMED with balanced class weights: the weighted loss, its gradients
    and the step, as the JAX package's."""
    from timed_design_tpu.train import balanced_class_weights

    labels = [0, 0, 1, 1, 1, 2, 5, 5]
    cw = balanced_class_weights(labels, 20)
    jm = _jax_module("TIMED")
    v = _variables(jm, seed=3)
    x, y = _frames(8, seed=4, side=9), _onehot(labels)
    new, want, grads = _jax_step(jm, v, x, y, class_weights=cw)
    module = _load(_port_module("TIMED"), v)
    got = _port_step(module, x, y, class_weights=cw)
    _assert_step_matches(module, new, got, want, grads)
    plain = _port_step(_load(_port_module("TIMED"), v), x, y)
    assert abs(plain["loss"] - got["loss"]) > 1e-6  # the weights matter on this batch


def test_bf16_train_step_close_to_float32():
    """bfloat16 convolutions: the loss within 0.05 of the float32 step's,
    and every parameter still float32 after the step."""
    from timed_design_tpu_torch.models import TIMED

    torch.manual_seed(0)
    f32 = TIMED(filters=(8,), dropout_rate=0.0)
    b16 = TIMED(filters=(8,), dropout_rate=0.0, compute_dtype=torch.bfloat16)
    b16.load_state_dict(f32.state_dict())
    x, y = _frames(8, seed=1), _onehot(np.arange(8) % 20)
    l32 = _port_step(f32, x, y)["loss"]
    l16 = _port_step(b16, x, y)["loss"]
    assert math.isfinite(l16) and abs(l16 - l32) < 0.05, (l16, l32)
    assert all(p.dtype == torch.float32 for p in b16.parameters())
    assert all(p.grad.dtype == torch.float32 for p in b16.parameters())


@pytest.mark.parametrize("name", ["TIMED", "ProDCoNN", "DenseNet"])
def test_float64_train_step_is_float64_throughout(name):
    """A module cast to float64, with compute_dtype float64, steps in
    float64 from end to end (BatchNorm, pooling and the head included):
    float64 logits and gradients, the float32 step's loss to 1e-5 relative.
    chip_smoke.py holds the card's float32 step to such a step."""
    import copy

    from timed_design_tpu_torch.train import init_train_state, make_train_step

    f32 = _port_module(name)
    f64 = copy.deepcopy(f32).double()
    f64.compute_dtype = torch.float64
    side = 21 if name == "ProDCoNN" else 9
    x, y = _frames(8, seed=6, side=side), _onehot([0, 3, 3, 7, 19, 12, 1, 2])
    logits = f64.train()(torch.from_numpy(x).double(), logits=True)
    assert logits.dtype == torch.float64
    l32 = _port_step(f32, x, y)["loss"]
    state = init_train_state(f64, LR, device="cpu")
    l64 = float(make_train_step(f64, state.optimizer)(
        torch.from_numpy(x).double(), torch.from_numpy(y).double())["loss"])
    assert abs(l64 - l32) <= 1e-5 * abs(l64), (l64, l32)
    assert all(p.grad.dtype == torch.float64 for p in f64.parameters())
    assert all(b.dtype == torch.float64 for b in f64.buffers() if b.is_floating_point())


def test_balanced_class_weights_equal_jax():
    from timed_design_tpu.train import balanced_class_weights as jax_weights

    from timed_design_tpu_torch.train import balanced_class_weights

    labels = np.random.default_rng(0).integers(0, 17, 300)
    np.testing.assert_array_equal(balanced_class_weights(labels, 20), jax_weights(labels, 20))
    with pytest.raises(ValueError):
        balanced_class_weights([], 20)


@pytest.mark.parametrize("name,warmup", [("constant", 0), ("constant", 10), ("cosine", 0),
                                         ("cosine", 10)])
def test_lr_schedule_equals_optax(name, warmup):
    """At every step, beyond the end too: optax's value, computed in
    float32, to 1e-6 relative or 1e-6 of the peak lr (near the end of a
    cosine the float32 cosine's rounding dominates)."""
    from timed_design_tpu.train import make_lr_schedule as jax_schedule

    from timed_design_tpu_torch.train import make_lr_schedule

    mine, want = make_lr_schedule(name, 3e-3, 100, warmup), jax_schedule(name, 3e-3, 100, warmup)
    for step in range(130):
        w = float(want(step)) if callable(want) else want
        assert mine(step) == pytest.approx(w, rel=1e-6, abs=3e-3 * 1e-6), step
    if warmup:
        assert mine(0) == 0.0
    with pytest.raises(ValueError, match="warmup_steps"):
        make_lr_schedule("cosine", 1e-3, 10, warmup_steps=10)
    with pytest.raises(ValueError, match="unknown"):
        make_lr_schedule("cyclic", 1e-3, 10)


# ---------------------------------------------------------------- evaluate

def test_evaluate_matches_jax():
    """Eval-mode sums over valid rows only: a padded final batch whose
    padding rows hold garbage; an empty loader gives NaN in both."""
    from timed_design_tpu.parallel import make_mesh
    from timed_design_tpu.train import evaluate as jax_evaluate

    from timed_design_tpu_torch.train import evaluate

    jm = _jax_module("TIMED")
    v = _variables(jm, seed=5)
    x = _frames(16, seed=6)
    y = _onehot(np.random.default_rng(6).integers(0, 20, 16))
    x[13:], y[13:] = 99.0, 0.0
    loader = [(x[:8], y[:8], 8), (x[8:], y[8:], 5)]
    want = jax_evaluate(jm, loader, v["params"], v["batch_stats"], mesh=make_mesh(n_data=1))
    module = _load(_port_module("TIMED"), v)
    got = evaluate(module, loader)
    assert got["n"] == want["n"] == 13
    for k in ("loss", "top1", "top3"):
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    empty, jax_empty = evaluate(module, []), jax_evaluate(jm, [], v["params"], v["batch_stats"])
    assert empty["n"] == jax_empty["n"] == 0
    assert all(math.isnan(empty[k]) and math.isnan(jax_empty[k]) for k in ("loss", "top1", "top3"))


# --------------------------------------------------------------------- fit

def test_fit_matches_jax_and_restores_the_best_epoch(monkeypatch, capsys):
    """Five steps of fit in both packages from the same weights, dropout
    off, no shuffle, a padded batch (6 of 8 rows valid, 9^3 frames as in
    test_train_step_matches_jax): per-step losses to 1e-4. Validation
    losses are scripted [1.0, 0.5, 0.6, 0.7, 0.8] on both sides (each
    epoch's real evaluate runs too, and agrees to 1e-4), so with
    patience 3 both stop after epoch 4 and restore epoch 1's weights: in the
    port, a copy equal to the weights evaluate saw then."""
    import jax

    import timed_design_tpu.train.train as jax_train
    from timed_design_tpu.parallel import make_mesh

    import timed_design_tpu_torch.train.train as port_train

    scripted = [1.0, 0.5, 0.6, 0.7, 0.8]
    lr = 1e-3
    jm = _jax_module("TIMED", bn_momentum=0.9)
    v = _variables(jm, seed=7)
    x = _frames(8, seed=8, side=9)
    y = _onehot(np.random.default_rng(8).integers(0, 20, 8))
    x[6:], y[6:] = 0.0, 0.0
    loader, val = [(x, y, 6)], [(_frames(4, seed=9, side=9), _onehot([1, 2, 3, 4]), 4)]
    runs = {}
    for pkg, mod in (("jax", jax_train), ("port", port_train)):
        losses, seen, real = [], [], []
        orig_step, orig_eval = mod.make_train_step, mod.evaluate

        def recording_step(module, optimizer, class_weights=None,
                           _orig=orig_step, _losses=losses, _pkg=pkg):
            step = _orig(module, optimizer, class_weights)
            if _pkg == "jax":
                def run(state, xb, yb, rng):
                    new, m = step(state, xb, yb, rng)
                    jax.debug.callback(lambda l: _losses.append(float(l)), m["loss"])
                    return new, m
            else:
                def run(xb, yb, generator=None):
                    m = step(xb, yb, generator)
                    _losses.append(float(m["loss"]))
                    return m
            return run

        def scripted_eval(module, val_loader, *args, _orig=orig_eval, _seen=seen, _real=real,
                          _pkg=pkg, **kw):
            _real.append(_orig(module, val_loader, *args, **kw)["loss"])
            _seen.append(jax.tree.map(np.array, args[0]) if _pkg == "jax"
                         else {k: t.clone() for k, t in module.state_dict().items()})
            return {"loss": scripted[len(_seen) - 1], "top1": 0.0, "top3": 0.0, "n": 4}

        monkeypatch.setattr(mod, "make_train_step", recording_step)
        monkeypatch.setattr(mod, "evaluate", scripted_eval)
        common = dict(n_classes=20, learning_rate=lr, epochs=10, val_loader=val, patience=3,
                      log_every=1, init_weights=v)
        if pkg == "jax":
            state = jax_train.fit(jm, loader, mesh=make_mesh(n_data=1), **common)
            weights = {"params": jax.tree.map(np.asarray, state.params)}
        else:
            module = _port_module("TIMED", bn_momentum=0.9)
            state = port_train.fit(module, loader, device="cpu", **common)
            weights = port_train.flax_variables(module)
            for k, t in module.state_dict().items():
                assert torch.equal(t, seen[1][k]), k
            assert not all(torch.equal(seen[1][k], seen[4][k]) for k in seen[1])
        runs[pkg] = (int(state.step), losses, real, _leaves(weights["params"]))
    (jstep, jl, jreal, jw), (pstep, pl, preal, pw) = runs["jax"], runs["port"]
    assert jstep == pstep == 5 and len(jl) == len(pl) == 5
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-4)
    np.testing.assert_allclose(preal, jreal, rtol=0, atol=1e-4)
    for k, w in jw.items():
        np.testing.assert_allclose(pw[k], w, rtol=0, atol=2 * lr * 2, err_msg=k)
    out = capsys.readouterr().out
    assert out.count("early stop at epoch 4") == 2 and "restoring best (val_loss=0.5000)" in out


def test_fit_nan_divergence_keeps_the_final_weights(monkeypatch, capsys):
    """All-NaN validation losses: patience still stops training, nothing is
    restored, and the message says so."""
    import timed_design_tpu_torch.train.train as port_train

    seen = []

    def nan_eval(module, loader, step_fn=None):
        seen.append({k: t.clone() for k, t in module.state_dict().items()})
        return {"loss": float("nan"), "top1": 0.0, "top3": 0.0, "n": 8}

    monkeypatch.setattr(port_train, "evaluate", nan_eval)
    module = _port_module("TIMED")
    x, y = _frames(8, seed=10), _onehot(np.arange(8))
    state = port_train.fit(module, [(x, y, 8)] * 2, n_classes=20, learning_rate=3e-3, epochs=10,
                           val_loader=[(x, y, 8)], patience=2, device="cpu")
    assert len(seen) == 2 and state.step == 4
    out = capsys.readouterr().out
    assert "no finite val_loss" in out and "restoring best" not in out
    for k, t in module.state_dict().items():
        assert torch.equal(t, seen[-1][k]), k


def test_fit_refusals():
    """The JAX package's errors: a head of another class count than the
    labels (20-class frames on a 338-class rotamer head), patience without
    validation, a decaying schedule without n_batches; and no card without
    device='cpu'."""
    from timed_design_tpu_torch.models import timed_rotamer
    from timed_design_tpu_torch.train import fit

    x, y = _frames(4, seed=11), _onehot([0, 1, 2, 3])
    module = timed_rotamer(filters=(4,))
    with pytest.raises(ValueError, match="20-class labels but n_classes=338"):
        fit(module, [(x, y, 4)], n_classes=338, device="cpu")
    with pytest.raises(ValueError, match="6-channel frames but input_channels=5"):
        fit(_port_module("TIMED"), [(_frames(4, 11, channels=6), y, 4)], n_classes=20,
            device="cpu")
    with pytest.raises(ValueError, match="patience"):
        fit(module, [(x, y, 4)], n_classes=338, patience=1, device="cpu")
    with pytest.raises(ValueError, match="n_batches"):
        fit(module, [(x, y, 4)], n_classes=338, lr_schedule="cosine", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fit(_port_module("TIMED"), [(x, y, 4)], n_classes=20)


def test_warm_start_errors_name_the_leaf():
    """init_weights of another width or depth: the JAX package's messages,
    word for word; a matching tree is loaded leaf for leaf."""
    import jax
    import optax

    from timed_design_tpu.models import timed as jax_timed
    from timed_design_tpu.train import init_train_state as jax_init

    from timed_design_tpu_torch.models import TIMED
    from timed_design_tpu_torch.train import init_train_state
    from timed_design_tpu_torch.train.train import flax_variables

    def messages(given):
        errs = []
        for init in (lambda: jax_init(jax_timed(filters=(8,)), jax.random.key(0),
                                      (1, 21, 21, 21, 5), optax.adam(1e-3), init_weights=given),
                     lambda: init_train_state(TIMED(filters=(8,)), init_weights=given,
                                              device="cpu")):
            with pytest.raises(ValueError) as e:
                init()
            errs.append(str(e.value))
        return errs

    for filters, match in (((16,), r"params\[ConvBlock_0/BatchNorm_0/bias\] has shape \(16,\)"),
                           ((8, 16), r"missing=\[\] extra=\['ConvBlock_1/")):
        got, want = messages(_variables(jax_timed(filters=filters), seed=0))
        assert got == want and re.search(match, got), got
    got, want = messages({})
    assert got == want == "init_weights must contain a 'params' tree"
    v = _variables(jax_timed(filters=(8,)), seed=4)
    state = init_train_state(TIMED(filters=(8,)), init_weights=v, device="cpu")
    mine = flax_variables(state.module)
    for part in ("params", "batch_stats"):
        for k, w in _leaves(v[part]).items():
            np.testing.assert_array_equal(_leaves(mine[part])[k], w, err_msg=k)


# ------------------------------------------------------------ td-train

def test_td_train_cli_matches_jax(tmp_path, monkeypatch, ubq_pdb_gz, capsys):
    """``td-train`` in both packages on the JAX package's HDF5 file of 1ubq:
    TIMED at widths (8, 16) from one warm-start checkpoint, float32, batch
    32, two epochs shuffled from seed 5 at lr 5e-4 (neither the default),
    six steps, two of them padded batches cut to their 12 rows; dropout off
    on both sides, JAX on a one-device mesh (on eight, the padded batch would
    be filled to 16 rows with repeats). Every step's batch equal (its frames'
    bytes, its labels), every step's loss to 1e-4 (as
    test_fit_matches_jax_and_restores_the_best_epoch), the printed step 0
    line equal. The first step's weights held as test_train_step_matches_jax
    holds one: parameters to 1e-6 where JAX's gradient is above 1e-3 of the
    largest, else 2 * lr (Adam's first move is +-lr, whatever the gradient's
    size); running statistics to 1e-5 (BatchNorm's sums over 32 x 21^3
    voxels in float32). Each checkpoint holds its package's last weights, and
    the two agree to 2 * lr * steps, the running variances to 1e-4: one
    element whose gradient is rounding noise turns its first move the other
    way, and the steps after it carry that into every leaf."""
    import hashlib
    import importlib

    import jax
    import optax

    import timed_design_tpu.train.train as jax_train
    from timed_design_tpu.cli.train import main as jax_main
    from timed_design_tpu.parallel import make_mesh
    from timed_design_tpu.voxel import make_frame_dataset

    import timed_design_tpu_torch.train.train as port_train
    from timed_design_tpu_torch.cli.train import main
    from timed_design_tpu_torch.train import load_checkpoint_params

    # the modules, not the ``timed`` functions their packages export
    for pkg in ("timed_design_tpu", "timed_design_tpu_torch"):
        monkeypatch.setattr(importlib.import_module(f"{pkg}.models.timed"), "spatial_dropout_3d",
                            lambda x, *a, **k: x)
    monkeypatch.setattr(jax_train, "make_mesh", lambda: make_mesh(n_data=1))
    # per step: the batch (a digest of its frames, its labels), the loss, and
    # the weights after the step; JAX's gradient of the step's loss too, as
    # in test_train_step_matches_jax
    seen = {"jax": {}, "port": {}}
    jax_step, port_step = jax_train.make_train_step, port_train.make_train_step

    def batch(xb, yb):
        x = np.ascontiguousarray(np.asarray(xb, np.float32))
        return hashlib.sha256(x.tobytes()).hexdigest(), x.shape, np.asarray(yb).argmax(1)

    def jax_recording(module, optimizer, class_weights=None):
        step = jax_step(module, optimizer, class_weights)

        def run(state, xb, yb, rng):
            def loss_fn(params):
                out, _ = module.apply({"params": params, "batch_stats": state.batch_stats}, xb,
                                      train=True, logits=True, rngs={"dropout": rng},
                                      mutable=["batch_stats"])
                return optax.softmax_cross_entropy(out, yb).mean()

            new, m = step(state, xb, yb, rng)
            jax.debug.callback(
                lambda k, x, y, loss, p, s, g: seen["jax"].__setitem__(
                    int(k), (batch(x, y), float(loss), _leaves(p), _leaves(s), _leaves(g))),
                state.step, xb, yb, m["loss"], new.params, new.batch_stats,
                jax.grad(loss_fn)(state.params))
            return new, m
        return run

    def port_recording(module, optimizer, class_weights=None):
        step = port_step(module, optimizer, class_weights)

        def run(xb, yb, generator=None):
            m = step(xb, yb, generator)
            after = port_train.flax_variables(module)
            seen["port"][len(seen["port"])] = (batch(xb, yb), float(m["loss"]),
                                               _leaves(after["params"]),
                                               _leaves(after["batch_stats"]))
            return m
        return run

    monkeypatch.setattr(jax_train, "make_train_step", jax_recording)
    monkeypatch.setattr(port_train, "make_train_step", port_recording)
    data = make_frame_dataset([ubq_pdb_gz], tmp_path / "ubq.hdf5")
    init = _save_variables(tmp_path / "init.npz",
                           _variables(_jax_module("TIMED", bn_momentum=0.9), seed=21))
    lr, steps, momentum = 5e-4, 6, 0.9
    argv = ["--path_to_dataset", str(data), "--model", "TIMED", "--filters", "8,16",
            "--batch_size", "32", "--epochs", "2", "--learning_rate", str(lr), "--seed", "5",
            "--bn_momentum", str(momentum), "--init_from", str(init)]
    capsys.readouterr()
    jax_main(argv + ["--output", str(tmp_path / "jax.npz")])
    jax_out = capsys.readouterr().out
    main(argv + ["--output", str(tmp_path / "port.npz"), "--device", "cpu"])
    port_out = capsys.readouterr().out
    assert f"after {steps} steps" in jax_out and f"after {steps} steps" in port_out
    printed = [re.search(r"step 0: .*", o).group(0) for o in (jax_out, port_out)]
    assert printed[0] == printed[1]
    assert sorted(seen["jax"]) == sorted(seen["port"]) == list(range(steps))
    jax_seen, port_seen = ([seen[p][k] for k in range(steps)] for p in ("jax", "port"))
    for k, (j, p) in enumerate(zip(jax_seen, port_seen)):
        assert j[0][:2] == p[0][:2] and np.array_equal(j[0][2], p[0][2]), f"step {k}'s batch"
    assert [p[0][1][0] for p in port_seen] == [32, 32, 12] * 2
    np.testing.assert_allclose([p[1] for p in port_seen], [j[1] for j in jax_seen],
                               rtol=0, atol=1e-4)
    # the first step, held as test_train_step_matches_jax holds one: Adam's
    # first move is +-lr, so 2 * lr where the gradient is rounding noise
    grads = jax_seen[0][4]
    scale = max(float(np.abs(v).max()) for v in grads.values())
    for k, w in jax_seen[0][2].items():
        tol = np.where(np.abs(grads[k]) > 1e-3 * scale, 1e-6, 2 * lr)
        bad = np.abs(port_seen[0][2][k] - w) > tol
        assert not bad.any(), f"step 0, param {k}: {int(bad.sum())} elements off"
    for k, w in jax_seen[0][3].items():
        np.testing.assert_allclose(port_seen[0][3][k], w, rtol=0, atol=1e-5,
                                   err_msg=f"step 0, batch_stats {k}")
    # each checkpoint holds its package's last weights; an element whose
    # gradient is rounding noise has turned Adam's first move the other way,
    # and the later steps carry that into every leaf
    want, got = (load_checkpoint_params(tmp_path / n) for n in ("jax.npz", "port.npz"))
    for part, i in (("params", 2), ("batch_stats", 3)):
        w, g = _leaves(want[part]), _leaves(got[part])
        assert w.keys() == g.keys() == jax_seen[-1][i].keys()
        for k in w:
            np.testing.assert_array_equal(w[k], jax_seen[-1][i][k], err_msg=f"jax {part}/{k}")
            np.testing.assert_array_equal(g[k], port_seen[-1][i][k], err_msg=f"port {part}/{k}")
            tol = 1e-4 if k.endswith("/var") else 2 * lr * steps
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=tol, err_msg=f"{part}/{k}")
    assert not np.allclose(_leaves(got["params"])["Conv_0/kernel"],
                           _leaves(load_checkpoint_params(init)["params"])["Conv_0/kernel"])


def _save_variables(path, variables):
    import types

    from timed_design_tpu.train.train import save_checkpoint

    save_checkpoint(types.SimpleNamespace(**variables), path, build_kwargs={"filters": (8, 16)})
    return path


# ------------------------------------------------------------- checkpoints

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_predicts_the_same_in_both_packages(tmp_path, ubq_pdb_gz, writer):
    """Two steps of fit in one package, its save_checkpoint, then
    ``TIMED@ckpt.npz`` through both packages' predict_structure on 1ubq:
    probabilities to 1e-5. The port's init_train_state loads the file
    leaf for leaf."""
    import jax

    from timed_design_tpu.engine import predict_structure as jax_predict
    from timed_design_tpu.parallel import make_mesh
    from timed_design_tpu.train import fit as jax_fit
    from timed_design_tpu.train import save_checkpoint as jax_save

    from timed_design_tpu_torch.engine.predictor import predict_structure
    from timed_design_tpu_torch.models import TIMED
    from timed_design_tpu_torch.train import (
        fit,
        init_train_state,
        load_checkpoint_params,
        save_checkpoint,
    )
    from timed_design_tpu_torch.train.train import flax_variables

    x, y = _frames(8, seed=12), _onehot(np.random.default_rng(12).integers(0, 20, 8))
    ckpt = tmp_path / "ckpt.npz"
    kw = dict(n_classes=20, learning_rate=1e-3, epochs=2, log_every=100)
    if writer == "port":
        save_checkpoint(fit(TIMED(filters=(8, 16), bn_momentum=0.5), [(x, y, 8)], device="cpu",
                            **kw), ckpt, build_kwargs={"filters": (8, 16)})
    else:
        jm = _jax_module("TIMED", bn_momentum=0.5)
        state = jax_fit(jm, [(x, y, 8)], mesh=make_mesh(n_data=1), **kw)
        jax_save(state, ckpt, build_kwargs={"filters": (8, 16)})
    got, _ = predict_structure(ubq_pdb_gz, f"TIMED@{ckpt}", batch_size=80, device="cpu")
    want, _ = jax_predict(ubq_pdb_gz, f"TIMED@{ckpt}", batch_size=80)
    assert got.shape == (76, 20)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    stored = load_checkpoint_params(ckpt)
    mine = flax_variables(init_train_state(TIMED(filters=(8, 16)), init_weights=stored,
                                           device="cpu").module)
    for part in ("params", "batch_stats"):
        for k, w in _leaves(stored[part]).items():
            np.testing.assert_array_equal(_leaves(mine[part])[k], w, err_msg=k)
    assert jax.tree.structure(stored) == jax.tree.structure(
        {"params": mine["params"], "batch_stats": mine["batch_stats"]})


@pytest.mark.parametrize("name", ["TIMED", "ProDCoNN", "DenseNet", "DenseCPD"])
def test_inverse_converters_round_trip(name):
    """Flax variables -> state_dict -> Flax variables gives back the same
    arrays, and state_dict -> Flax -> state_dict the same tensors."""
    from timed_design_tpu.models import densenet as jax_densenet

    from timed_design_tpu_torch.models import DenseNet3D
    from timed_design_tpu_torch.train.train import _layout

    narrow_cpd = {"growth_rate": 4, "block_layers": (2, 1, 2), "init_features": 6}
    if name == "DenseCPD":
        jm, module = jax_densenet(**narrow_cpd), DenseNet3D(**narrow_cpd)
    else:
        jm, module = _jax_module(name), _port_module(name)
    to_flax, from_flax = _layout(module)
    v = _variables(jm, seed=13)
    back = to_flax(from_flax(v))
    for part in ("params", "batch_stats"):
        want, got = _leaves(v[part]), _leaves(back[part])
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].dtype == w.dtype and got[k].shape == w.shape
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    sd = module.state_dict()
    again = from_flax(to_flax(sd))
    assert set(again) == set(sd)
    for k, t in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(again[k], t), k


# ----------------------------------------------------------------- dropout

@pytest.mark.parametrize("kind", ["spatial", "dense"])
def test_dropout_masks_follow_keras(kind):
    """The port's masks alone (never against JAX's): SpatialDropout3D zeroes
    whole channels, Dropout single elements; the kept share is within 4
    standard deviations of 1 - rate; kept values are scaled by 1 / keep; the
    same generator seed gives the same mask; evaluation drops nothing."""
    from timed_design_tpu_torch.models.layers import dropout, spatial_dropout_3d

    rate = 0.25
    if kind == "spatial":
        x = torch.ones((64, 3, 3, 3, 32))
        drop = spatial_dropout_3d
    else:
        x = torch.ones((256, 128))
        drop = dropout
    y = drop(x, rate, True, torch.Generator().manual_seed(1))
    units = y.reshape(64, 27, 32).permute(0, 2, 1).reshape(-1, 27) if kind == "spatial" else y
    if kind == "spatial":
        assert ((units == 0).all(1) | (units == 1 / (1 - rate)).all(1)).all()
        kept = (units[:, 0] != 0).float()
    else:
        assert ((y == 0) | (y == 1 / (1 - rate))).all()
        kept = (y != 0).float().ravel()
    sigma = math.sqrt(rate * (1 - rate) / kept.numel())
    assert abs(float(kept.mean()) - (1 - rate)) <= 4 * sigma
    assert torch.equal(y, drop(x, rate, True, torch.Generator().manual_seed(1)))
    assert not torch.equal(y, drop(x, rate, True, torch.Generator().manual_seed(2)))
    assert drop(x, rate, False) is x


def test_model_dropout_draws_from_the_generator():
    """TIMED's SpatialDropout and ProDCoNN's Dropout in training draw from
    the generator passed to forward: the same seed, the same logits."""
    from timed_design_tpu_torch.models import TIMED, ProDCoNN

    torch.manual_seed(0)
    x = torch.from_numpy(_frames(4, seed=14))
    for module in (TIMED(filters=(4, 8), dropout_rate=0.5), ProDCoNN()):
        module.train()

        def run(seed, _m=module):
            with torch.no_grad():
                return _m(x, logits=True, generator=torch.Generator().manual_seed(seed))

        assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_train_step_card_equals_cpu(cuda_device):
    """One float32 train step of registry TIMED (dropout off) on the card
    and on the CPU (all its threads and half of them), batch 16, TF32 off,
    each held to a float64 step on the CPU from the same weights: the loss
    to 1e-5 relative, each leaf's gradient to 1e-4 of the leaf's largest
    float64 |g| (of the model's largest for a leaf whose float64 gradient is
    below 1e-9 of it), the BatchNorm running statistics to 1e-5; or, where
    the float32 CPU lies further from float64, to 4x its distance. A bias
    ahead of a BatchNorm sums 16 x 21^3 terms that cancel, and lies 1e-2 of
    itself from float64 on the CPU too; chip_smoke.py's train phase holds
    every family so."""
    import copy

    from timed_design_tpu_torch.models import timed
    from timed_design_tpu_torch.train import init_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    x = torch.from_numpy(_frames(16, seed=15))
    y = torch.from_numpy(_onehot(np.random.default_rng(15).integers(0, 20, 16)))
    base = timed(dropout_rate=0.0)

    def step(device, threads=None, dtype=torch.float32):
        module, n = copy.deepcopy(base).to(dtype), torch.get_num_threads()
        module.compute_dtype = dtype
        torch.set_num_threads(threads or n)
        try:
            state = init_train_state(module, device=device)
            loss = float(make_train_step(module, state.optimizer)(
                x.to(device, dtype), y.to(device, dtype))["loss"])
        finally:
            torch.set_num_threads(n)
        return (loss, {k: p.grad.cpu().double() for k, p in module.named_parameters()},
                {k: b.cpu().double() for k, b in module.named_buffers() if b.is_floating_point()})

    def errors(a, ref):
        top = max(float(g.abs().max()) for g in ref[1].values())
        grads = {}
        for k, g in ref[1].items():
            scale = float(g.abs().max())
            grads[k] = float((a[1][k] - g).abs().max()) / (scale if scale > 1e-9 * top else top)
        return (abs(a[0] - ref[0]) / abs(ref[0]), grads,
                max(float((a[2][k] - v).abs().max()) / max(1.0, float(v.abs().max()))
                    for k, v in ref[2].items()))

    f64 = step("cpu", dtype=torch.float64)
    err = errors(step(cuda_device), f64)
    cpus = [errors(step("cpu", threads=t), f64)
            for t in (None, max(1, torch.get_num_threads() // 2))]
    for j, what in ((0, "loss"), (2, "running statistics")):
        assert err[j] <= max(1e-5, 4 * max(c[j] for c in cpus)), (what, err[j])
    for k, e in err[1].items():
        assert e <= max(1e-4, 4 * max(c[1][k] for c in cpus)), (k, e, [c[1][k] for c in cpus])
