"""PyTorch port, scale-out: ``timed_design_tpu_torch/parallel/`` and the mesh
through the Predictor, ``td-predict``, the train step, ``fit`` and
``evaluate``, against the JAX package's mesh on its 8 virtual CPU devices
(``tests/conftest.py``).

The port's worlds are gloo ranks on the CPU, one process each, running a
port-only script (``timed_design_tpu``, jax, flax and optax unimportable):
one thread a rank, a gloo timeout of 60 s, and a wall limit of its own
(``WALL_S``) past which every rank is killed and the test fails. One world
runs per mesh shape (a module-scoped fixture) and writes its results to
files that the tests read; the JAX side runs in the test process on the
same numpy inputs from a seed.

Tolerances, float32 with dropout off on both sides (``tests/
test_torch_train.py``'s): loss, top-1 and top-3 1e-5; every gradient
element 1e-4 of the largest |g| of the whole gradient; BatchNorm running
statistics 1e-6; parameters after Adam's first step (lr * sign(g)) 1e-6
where |g| exceeds 1e-3 of the largest, else 2 * lr; probabilities 1e-5;
``int8`` probabilities 1e-5 with equal argmax (``tests/
test_torch_quantize.py``'s); ``evaluate`` 1e-5. The two-by-two world
against the port's two-by-one: the same tolerances. TIMED runs on 9^3
frames, where float32 sums are tight enough for them.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
UBQ = REPO / "tests" / "testing_files" / "1ubq.pdb1.gz"
WALL_S = 180
LR = 1e-3
N_VALID = 5  # of the train batch's 8 rows: odd, so two data ranks need a repeat
FILTERS = (8, 16)

_HYGIENE = """
import sys
for _name in ("timed_design_tpu", "jax", "flax", "optax"):
    sys.modules[_name] = None  # any import of these now raises ImportError
"""

_WORKER = _HYGIENE + textwrap.dedent('''
    import json
    from pathlib import Path

    import numpy as np
    import torch

    torch.set_num_threads(1)
    rank, world, n_model, port = (int(a) for a in sys.argv[1:5])
    work = Path(sys.argv[5])

    from timed_design_tpu_torch.engine import DesignSession, Predictor, predict_structure
    from timed_design_tpu_torch.models import TIMED, flax_variables_to_state_dict
    from timed_design_tpu_torch.parallel import (
        barrier, gather_host_arrays, initialize_distributed, make_mesh, shard_batch,
        shard_work_for_host)
    from timed_design_tpu_torch.parallel.tensor_parallel import gather_state_dict
    from timed_design_tpu_torch.train import (
        evaluate, fit, init_train_state, load_checkpoint_params, make_train_step,
        save_checkpoint)
    from timed_design_tpu_torch.train.train import _flatten, _layout, fill_batch, flax_variables

    out, arrays = {}, {}
    out["process"] = initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                                            timeout_s=60)
    mesh = make_mesh(n_model=n_model, timeout_s=60)
    out["shape"], out["data_index"], out["model_index"] = (
        mesh.shape, mesh.data_index, mesh.model_index)
    inp = np.load(work / "inputs.npz")
    N_VALID = int(inp["n_valid"])
    variables = load_checkpoint_params(work / "init.npz")

    def module():
        m = TIMED(filters=(8, 16), dropout_rate=0.0)
        m.load_state_dict(flax_variables_to_state_dict(variables))
        return m

    def leaves(prefix, tree):
        arrays.update({f"{prefix}/{k}": np.asarray(v) for k, v in _flatten(tree).items()})

    if n_model == 1:
        work_items = [f"pdb{i}" for i in range(5)]
        mine = shard_work_for_host(work_items)
        out["mine"] = mine
        arrays["gathered"] = gather_host_arrays(np.full((len(mine), 2), float(rank)))
        barrier("test-sync")
        try:
            make_mesh(n_model=100)
        except ValueError as e:
            out["too_small"] = str(e)
        for mode in (None, "int8"):
            p = Predictor(module(), batch_size=5, device="cpu", quantize=mode, mesh=mesh)
            out["batch_size"] = p.batch_size
            arrays[f"probs_{mode}"] = p.predict_probs(inp["predict_x"])
        ckpt, ubq = f"TIMED@{work / 'init.npz'}", str(inp["ubq"])
        arrays["session"] = DesignSession(ckpt, compute_dtype="float32", batch_size=40,
                                          device="cpu", mesh=mesh).design(ubq)[0]
        arrays["structure"] = predict_structure(ubq, ckpt, batch_size=40, mesh=mesh)[0]
        ex, ey = inp["eval_x"], inp["eval_y"]
        out["evaluate"] = evaluate(module(), [(ex[:8], ey[:8], 8), (ex[8:], ey[8:], 5)],
                                   mesh=mesh)
        m = module()
        fit(m, [(inp["train_x"], inp["train_y"], N_VALID)], n_classes=20, learning_rate=1e-3,
            device="cpu", mesh=mesh)
        leaves("fit", flax_variables(m)["params"])

    for weighting in ("none", "balanced"):
        m = module()
        state = init_train_state(m, 1e-3, device="cpu", mesh=mesh)
        x, y = fill_batch(inp["train_x"], inp["train_y"], N_VALID, mesh.shape["data"])
        cw = None if weighting == "none" else inp["class_weights"]
        step = make_train_step(m, state.optimizer, cw, mesh=mesh)
        metrics = step(torch.from_numpy(shard_batch(x, mesh)),
                       torch.from_numpy(shard_batch(y, mesh)))
        out[f"metrics_{weighting}"] = {k: float(v) for k, v in metrics.items()}
        sd = dict(m.state_dict())
        sd.update({n: p.grad for n, p in m.named_parameters()})
        leaves(f"grads_{weighting}", _layout(m)[0](gather_state_dict(m, sd))["params"])
        after = flax_variables(m)
        leaves(f"params_{weighting}", after["params"])
        leaves(f"stats_{weighting}", after["batch_stats"])
        if n_model > 1:
            out["sliced"] = {k: list(v.shape) for k, v in m.state_dict().items()}
            save_checkpoint(state, work / f"ckpt_{weighting}.npz",
                            build_kwargs={"filters": (8, 16)})
    if n_model > 1:
        from timed_design_tpu_torch.models import DenseNet3D
        from timed_design_tpu_torch.parallel.tensor_parallel import shard_model_axis

        torch.manual_seed(0)
        dn = DenseNet3D(growth_rate=4, block_layers=(2, 2), init_features=8).eval()
        x = torch.from_numpy(inp["predict_x"][:2])
        with torch.inference_mode():
            arrays["densenet_whole"] = dn(x, logits=True).numpy()
        shard_model_axis(dn, mesh)
        with torch.inference_mode():
            arrays["densenet_buffered"] = dn(x, logits=True).numpy()
        arrays["densenet_concatenated"] = dn(x, logits=True).detach().numpy()
    barrier("done")
    np.savez(work / f"rank{rank}.npz", **arrays)
    (work / f"rank{rank}.json").write_text(json.dumps(out))
''')

# torchrun's target: the port's td-predict as __main__, from a directory of
# this rank's own, so that whatever a rank writes lands apart
_PREDICT = _HYGIENE + textwrap.dedent('''
    import os
    import runpy

    os.chdir(f"rank{os.environ['RANK']}")
    runpy.run_module("timed_design_tpu_torch.cli.predict", run_name="__main__")
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")


def _run_world(cmds: list[list[str]], cwd: Path) -> list[str]:
    """Start every rank, wait for all within ``WALL_S``; past it kill every
    rank (its process group) and fail. Returns each rank's output."""
    procs = [subprocess.Popen(c, cwd=cwd, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, start_new_session=True)
             for c in cmds]
    deadline = time.monotonic() + WALL_S
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                pytest.fail(f"a world of {len(cmds)} ranks passed its {WALL_S} s wall limit")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    return outs


def _frames(n, seed, side=9):
    return np.random.default_rng(seed).random((n, side, side, side, 5), np.float32)


def _onehot(labels, n_classes=20):
    return np.eye(n_classes, dtype=np.float32)[np.asarray(labels)]


def _jax_timed():
    from timed_design_tpu.models import timed

    return timed(filters=FILTERS, dropout_rate=0.0)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The weights (a Flax init, running statistics moved off 0/1) as the
    JAX package's checkpoint, and every input, made from seeds."""
    import types

    import jax

    from timed_design_tpu.train import balanced_class_weights
    from timed_design_tpu.train.train import save_checkpoint

    work = tmp_path_factory.mktemp("torch_parallel")
    v = _jax_timed().init(jax.random.key(1), np.zeros((1, 9, 9, 9, 5), np.float32))
    rng = np.random.default_rng(1)
    variables = {
        "params": jax.tree.map(np.asarray, v["params"]),
        "batch_stats": jax.tree.map(
            lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
            v["batch_stats"]),
    }
    save_checkpoint(types.SimpleNamespace(**variables), work / "init.npz",
                    build_kwargs={"filters": FILTERS})
    labels = [0, 3, 3, 7, 19, 12, 1, 2]
    predict_x = _frames(7, seed=2)
    # the second rank's rows of the first batch run to 30x the first rank's:
    # a per-rank int8 scale would give the first rank other codes
    predict_x[3:6] *= 30.0
    data = {
        "predict_x": predict_x,
        "train_x": _frames(8, seed=3), "train_y": _onehot(labels),
        "eval_x": _frames(15, seed=4),
        "eval_y": _onehot(np.random.default_rng(4).integers(0, 20, 15)),
        "class_weights": balanced_class_weights(labels[:N_VALID], 20).astype(np.float32),
        "n_valid": N_VALID,
        "ubq": str(UBQ),
    }
    data["eval_x"][13:], data["eval_y"][13:] = 99.0, 0.0  # padding rows hold garbage
    np.savez(work / "inputs.npz", **data)
    return work, variables, data


def _world(inputs, world: int, n_model: int, name: str) -> Path:
    work, _, _ = inputs
    wdir = work / name
    wdir.mkdir()
    for f in ("inputs.npz", "init.npz"):
        (wdir / f).symlink_to(work / f)
    script = wdir / "worker.py"
    script.write_text(_WORKER)
    port = _free_port()
    _run_world([[sys.executable, str(script), str(r), str(world), str(n_model), str(port),
                 str(wdir)] for r in range(world)], cwd=wdir)
    return wdir


def _results(wdir: Path, rank: int = 0) -> tuple[dict, dict]:
    arrays = np.load(wdir / f"rank{rank}.npz")
    return json.loads((wdir / f"rank{rank}.json").read_text()), {k: arrays[k] for k in arrays}


@pytest.fixture(scope="module")
def two_data(inputs):
    """Two gloo ranks on the data axis (``make_mesh()``: 2 x 1)."""
    return _world(inputs, 2, 1, "dp2")


@pytest.fixture(scope="module")
def two_by_two(inputs):
    """Four gloo ranks, 2 data x 2 model (``make_mesh(n_model=2)``)."""
    return _world(inputs, 4, 2, "tp4")


def _sub(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in arrays.items() if k.startswith(prefix + "/")}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# ---------------------------------------------------------------- the mesh

def test_make_mesh_shape_and_errors_equal_jax():
    """Shapes and the error of a mesh too large for the world (JAX: 8
    virtual devices; the port with no world joined: one rank)."""
    from timed_design_tpu.parallel import make_mesh as jax_make_mesh

    from timed_design_tpu_torch.parallel import make_mesh

    assert make_mesh().shape == dict(jax_make_mesh(n_data=1).shape) == {"data": 1, "model": 1}
    for kw in ({"n_model": 100}, {"n_data": 0}, {"n_data": 2}):
        with pytest.raises(ValueError, match="devices") as port_err:
            make_mesh(**kw)
        if kw != {"n_data": 2}:  # JAX holds 2 of its 8 devices
            with pytest.raises(ValueError, match="devices") as jax_err:
                jax_make_mesh(**kw)
            assert str(port_err.value).split(";")[0] == str(jax_err.value).split(";")[0]


def test_distributed_helpers_single_host():
    """The helpers degenerate to no-ops with no world joined, as the JAX
    package's do on one host."""
    from timed_design_tpu_torch.parallel import (
        barrier,
        gather_host_arrays,
        initialize_distributed,
        shard_work_for_host,
    )

    assert initialize_distributed() == (0, 1)
    assert shard_work_for_host(["a", "b", "c"]) == ["a", "b", "c"]
    assert shard_work_for_host(["a", "b", "c"], 1, 2) == ["b"]
    x = np.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(gather_host_arrays(x), x)
    barrier()


def test_a_cuda_rank_never_falls_back_to_gloo(monkeypatch):
    """Asking for a CUDA rank where there is no card (or no NCCL) raises
    before any world is joined."""
    import torch.distributed as dist

    from timed_design_tpu_torch.parallel import initialize_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        initialize_distributed("127.0.0.1:1", 1, 0, device="cuda")
    assert not dist.is_initialized()


@pytest.mark.parametrize("family", ["TIMED", "ProDCoNN", "DenseNet"])
def test_param_shardings_equal_jax(family):
    """The spec tree of the tensor-parallel layout equals JAX's at
    ``make_mesh(n_data=4, n_model=2)`` (TIMED at filters (16, 32), as
    ``tests/test_train.py`` builds it), and ``shard_model_axis`` cuts
    exactly the layers it marks to half their output channels."""
    import jax
    import jax.numpy as jnp

    from timed_design_tpu.models import densenet, prodconn, timed
    from timed_design_tpu.parallel import make_mesh as jax_make_mesh
    from timed_design_tpu.train import param_shardings as jax_param_shardings

    from timed_design_tpu_torch.models import TIMED, DenseNet3D, ProDCoNN
    from timed_design_tpu_torch.parallel.mesh import Mesh
    from timed_design_tpu_torch.parallel.tensor_parallel import shard_model_axis
    from timed_design_tpu_torch.train import param_shardings
    from timed_design_tpu_torch.train.train import _layout, flax_variables

    narrow = {"growth_rate": 4, "block_layers": (2, 2), "init_features": 8}
    jm, pm = {"TIMED": (timed(filters=(16, 32)), TIMED(filters=(16, 32))),
              "ProDCoNN": (prodconn(), ProDCoNN()),
              "DenseNet": (densenet(**narrow), DenseNet3D(**narrow))}[family]
    params = jm.init(jax.random.key(0), jnp.zeros((1, 21, 21, 21, 5)))["params"]
    want = _flat_specs(jax.tree.map(lambda s: tuple(s.spec), jax_param_shardings(
        params, jax_make_mesh(n_data=4, n_model=2))))
    mesh = Mesh({"data": 4, "model": 2}, tuple(range(8)))
    got_tree = param_shardings(flax_variables(pm)["params"], mesh)
    got = {k: v.spec for k, v in _flat_specs(got_tree).items()}
    assert got == want
    assert any(s and s[-1] == "model" for s in got.values())
    full = _flat(flax_variables(pm)["params"])
    sliced = _flat(_layout(pm)[0](shard_model_axis(pm, mesh).state_dict())["params"])
    for k, v in full.items():
        # a split layer keeps its slice of the bias too (JAX replicates the
        # bias and slices the kernel's output: the same channels)
        kernel = k.rsplit("/", 1)[0] + "/kernel"
        split = got[kernel] if k.endswith("/bias") and kernel in got else got[k]
        halved = v.shape[:-1] + (v.shape[-1] // 2,)
        assert sliced[k].shape == (halved if split else v.shape), k


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_fill_batch_equals_jax_fit():
    """``fill_batch`` against the JAX package's fill in ``fit``
    (``train.py:402-427``, copied here), over batch sizes, valid rows and
    data axes; at one data rank it is the valid rows."""
    from timed_design_tpu_torch.train.train import fill_batch

    def jax_fill(X, y, n_valid, n_data):
        keep = max(n_data, -(-n_valid // n_data) * n_data)
        if n_valid < X.shape[0] or keep != X.shape[0]:
            Xn = np.empty((keep, *X.shape[1:]), dtype=X.dtype)
            yn = np.empty((keep, y.shape[1]), dtype=y.dtype)
            Xn[:n_valid], yn[:n_valid] = X[:n_valid], y[:n_valid]
            if keep > n_valid:
                src = np.arange(keep - n_valid) % n_valid
                Xn[n_valid:] = X[src]
                yn[n_valid:] = y[src]
            X, y = Xn, yn
        return X, y

    rng = np.random.default_rng(0)
    for rows, n_valid, n_data in [(8, 5, 2), (8, 8, 2), (38, 38, 8), (8, 1, 4), (6, 3, 1),
                                  (8, 8, 3), (4, 2, 8)]:
        X, y = rng.random((rows, 2, 3)), rng.random((rows, 4))
        for got, want in zip(fill_batch(X, y, n_valid, n_data), jax_fill(X, y, n_valid, n_data)):
            np.testing.assert_array_equal(got, want)
        got = fill_batch(torch.from_numpy(X), y, n_valid, n_data)[0]
        np.testing.assert_array_equal(got.numpy(), jax_fill(X, y, n_valid, n_data)[0])


def test_batch_source_voxelizes_only_its_rows(tmp_path):
    """``FrameBatchSource(rows=)``, as a rank of a mesh reads td-predict's
    batches: each rank's rows of every batch (across two structures: 1ubq
    and its residues 1-30) equal the whole batch's, within the voxelizer's
    rounding over another padded atom count, and the other rows are zero;
    the labels are every row's."""
    import gzip

    from timed_design_tpu_torch.voxel import FrameBatchSource, create_flat_dataset_map, make_frame_set

    atoms = [line for line in gzip.decompress(UBQ.read_bytes()).decode().splitlines()
             if line.startswith("ATOM") and int(line[22:26]) <= 30]
    (tmp_path / "2cut.pdb").write_text("\n".join(atoms + ["END"]) + "\n")
    fs = make_frame_set([UBQ, tmp_path / "2cut.pdb"])
    dmap = create_flat_dataset_map(fs)
    full = list(FrameBatchSource(fs, dmap, 64, device="cpu"))
    for rank in range(2):
        rows = slice(32 * rank, 32 * (rank + 1))
        part = list(FrameBatchSource(fs, dmap, 64, device="cpu", rows=rows))
        assert len(part) == len(full)
        for (X, y, n), (Xp, yp, n_p) in zip(full, part):
            assert n_p == n
            np.testing.assert_array_equal(yp, y)
            np.testing.assert_allclose(Xp[rows].numpy(), X[rows].numpy(), rtol=0, atol=1e-6)
            others = torch.ones(64, dtype=torch.bool)
            others[rows] = False
            assert not Xp[others].any()


# ------------------------------------------------------ two ranks, 2 x 1

def test_two_rank_helpers(two_data):
    """Round-robin of 5 items, the ragged gather in process order and the
    barrier, as ``tests/test_distributed_multiprocess.py`` holds the JAX
    helpers; the mesh's shape and its too-small error."""
    for rank, mine in ((0, ["pdb0", "pdb2", "pdb4"]), (1, ["pdb1", "pdb3"])):
        out, arrays = _results(two_data, rank)
        assert out["process"] == [rank, 2]
        assert out["mine"] == mine
        assert arrays["gathered"][:, 0].tolist() == [0.0, 0.0, 0.0, 1.0, 1.0]
        assert out["shape"] == {"data": 2, "model": 1} and out["data_index"] == rank
        assert out["too_small"].startswith("mesh (0 data x 100 model) needs 100 devices")


def _jax_predict(inputs, mesh, quantize=None, rows=None):
    import jax

    from timed_design_tpu.engine.predictor import Predictor as JaxPredictor

    _, variables, data = inputs
    x = data["predict_x"] if rows is None else data["predict_x"][rows]
    optimize = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", False)  # JAX's int8 is emulated
    try:
        p = JaxPredictor((_jax_timed(), variables), batch_size=5, mesh=mesh, quantize=quantize)
        return p.batch_size, p.predict_probs(x)
    finally:
        jax.config.update("jax_disable_most_optimizations", optimize)


def test_two_rank_predictor_equals_jax_mesh(inputs, two_data):
    """``Predictor(mesh=)`` at batch 5, rounded to 6, on two data ranks
    against JAX's over ``make_mesh(n_data=2)``: 7 frames, two batches, the
    second padded; both ranks return every row."""
    from timed_design_tpu.parallel import make_mesh as jax_make_mesh

    batch, want = _jax_predict(inputs, jax_make_mesh(n_data=2))
    out, arrays = _results(two_data)
    assert out["batch_size"] == batch == 6
    assert arrays["probs_None"].shape == want.shape == (7, 20)
    np.testing.assert_allclose(arrays["probs_None"], want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_results(two_data, 1)[1]["probs_None"], arrays["probs_None"])


def test_two_rank_int8_takes_the_global_scale(inputs, two_data):
    """``int8`` over two data ranks: the activation scale of each
    convolution is the max over the whole batch (both ranks' rows), as
    JAX's max over a sharded batch; equal to JAX's over
    ``make_mesh(n_data=2)``. A per-rank scale, which JAX gives when each
    half of the batch runs alone, moves the first rank's rows."""
    from timed_design_tpu.parallel import make_mesh as jax_make_mesh

    _, want = _jax_predict(inputs, jax_make_mesh(n_data=2), "int8")
    got = _results(two_data)[1]["probs_int8"]
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_results(two_data, 1)[1]["probs_int8"], got)
    _, per_rank = _jax_predict(inputs, jax_make_mesh(n_data=1), "int8", rows=slice(0, 3))
    assert np.abs(per_rank - want[:3]).max() > 10 * max(np.abs(got - want).max(), 1e-5)


@pytest.mark.parametrize("entry", ["session", "structure"])
def test_two_rank_design_entry_points_equal_jax_mesh(inputs, two_data, entry):
    """``DesignSession(mesh=)`` and ``predict_structure(mesh=)`` of 1ubq
    (the checkpoint, float32, batch 40: two batches over two ranks, each
    rank voxelizing the structure) against the JAX package's over
    ``make_mesh(n_data=2)``."""
    from timed_design_tpu.engine import DesignSession as JaxSession
    from timed_design_tpu.engine import predict_structure as jax_predict_structure
    from timed_design_tpu.parallel import make_mesh as jax_make_mesh

    mesh, ckpt = jax_make_mesh(n_data=2), f"TIMED@{inputs[0] / 'init.npz'}"
    if entry == "session":
        want = JaxSession(ckpt, compute_dtype="float32", batch_size=40, mesh=mesh).design(UBQ)[0]
    else:
        want = jax_predict_structure(UBQ, ckpt, batch_size=40, mesh=mesh)[0]
    got = _results(two_data)[1][entry]
    assert got.shape == np.shape(want) == (76, 20)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_results(two_data, 1)[1][entry], got)


def _jax_train_step(inputs, mesh, weighting: str):
    """The JAX package's train step (Adam) on the batch its ``fit`` fills
    for ``N_VALID`` rows over ``mesh``, and JAX's gradients of the same
    loss, the batch sharded over the data axis and the parameters laid out
    by ``param_shardings``."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from timed_design_tpu.parallel import shard_batch
    from timed_design_tpu.train import TrainState, make_train_step, param_shardings

    from timed_design_tpu_torch.train.train import fill_batch

    _, variables, data = inputs
    cw = None if weighting == "none" else data["class_weights"]
    jm = _jax_timed()
    x, y = fill_batch(data["train_x"], data["train_y"], N_VALID, mesh.shape["data"])
    x, y = shard_batch(jnp.asarray(x), mesh), shard_batch(jnp.asarray(y), mesh)
    params = jax.tree.map(jax.device_put, variables["params"],
                          param_shardings(variables["params"], mesh))
    stats = jax.tree.map(lambda a: jax.device_put(a, NamedSharding(mesh, P())),
                         variables["batch_stats"])
    opt = optax.adam(LR)
    state = TrainState(params, stats, opt.init(params), jnp.zeros((), jnp.int32))
    new, metrics = jax.jit(make_train_step(jm, opt, cw))(state, x, y, jax.random.key(0))

    def loss_fn(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats}, x, train=True, logits=True,
                          rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy(out, y)
        if cw is None:
            return ce.mean()
        w = y @ jnp.asarray(cw)
        return (ce * w).sum() / jnp.maximum(w.sum(), 1e-9)

    grads = jax.jit(jax.grad(loss_fn))(params)
    return ({k: float(v) for k, v in metrics.items()}, _flat(jax.tree.map(np.asarray, grads)),
            _flat(jax.tree.map(np.asarray, new.params)),
            _flat(jax.tree.map(np.asarray, new.batch_stats)))


def _assert_step_close(got: tuple, want: tuple) -> None:
    """(metrics, grads, params after Adam, running statistics) to the
    tolerances of the module docstring."""
    (m, g, p, s), (wm, wg, wp, ws) = got, want
    for k in ("loss", "top1", "top3"):
        assert abs(m[k] - wm[k]) <= 1e-5, (k, m[k], wm[k])
    assert set(g) == set(wg) and set(p) == set(wp) and set(s) == set(ws)
    scale = max(float(np.abs(v).max()) for v in wg.values())
    for k, w in wg.items():
        err = float(np.abs(g[k] - w).max())
        assert err <= 1e-4 * scale, f"grad {k}: {err:.3g} (largest |g| {scale:.3g})"
    for k, w in ws.items():
        np.testing.assert_allclose(s[k], w, rtol=0, atol=1e-6, err_msg=f"batch_stats {k}")
    for k, w in wp.items():
        tol = np.where(np.abs(wg[k]) > 1e-3 * scale, 1e-6, 2 * LR)
        bad = np.abs(p[k] - w) > tol
        assert not bad.any(), f"param {k}: {int(bad.sum())} elements off"


def _port_step(wdir: Path, weighting: str) -> tuple:
    out, arrays = _results(wdir)
    return (out[f"metrics_{weighting}"], _sub(arrays, f"grads_{weighting}"),
            _sub(arrays, f"params_{weighting}"), _sub(arrays, f"stats_{weighting}"))


@pytest.mark.parametrize("weighting", ["none", "balanced"])
def test_two_rank_train_step_equals_jax_mesh(inputs, two_data, weighting):
    """One step on a partial batch (5 valid rows of 8: filled to 6 with a
    repeat, 3 rows a rank) against JAX's over ``make_mesh(n_data=2)``: the
    loss (with balanced class weights, over the global weight sum), top-1
    and top-3, every gradient, the running statistics (BatchNorm over the
    global batch) and the parameters after Adam."""
    from timed_design_tpu.parallel import make_mesh as jax_make_mesh

    _assert_step_close(_port_step(two_data, weighting),
                       _jax_train_step(inputs, jax_make_mesh(n_data=2), weighting))


def test_two_rank_fit_takes_the_same_step(two_data):
    """``fit(mesh=)`` for one step on the same loader batch lands on the
    parameters of the explicit step (fill, shard, step): the same
    arithmetic."""
    _, arrays = _results(two_data)
    fit_params, step_params = _sub(arrays, "fit"), _sub(arrays, "params_none")
    assert set(fit_params) == set(step_params)
    for k, v in step_params.items():
        np.testing.assert_array_equal(fit_params[k], v, err_msg=k)


def test_two_rank_evaluate_equals_jax_mesh(inputs, two_data):
    """``evaluate(mesh=)`` over a full batch and a partial one of 7 rows
    (5 valid, the padding garbage; zero-padded to 8 over two ranks)
    against JAX's over ``make_mesh(n_data=2)``."""
    from timed_design_tpu.parallel import make_mesh as jax_make_mesh
    from timed_design_tpu.train import evaluate as jax_evaluate

    _, variables, data = inputs
    ex, ey = data["eval_x"], data["eval_y"]
    want = jax_evaluate(_jax_timed(), [(ex[:8], ey[:8], 8), (ex[8:], ey[8:], 5)],
                        variables["params"], variables["batch_stats"],
                        mesh=jax_make_mesh(n_data=2))
    got = _results(two_data)[0]["evaluate"]
    assert got["n"] == want["n"] == 13
    for k in ("loss", "top1", "top3"):
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])


# ------------------------------------------------------ four ranks, 2 x 2

@pytest.mark.parametrize("weighting", ["none", "balanced"])
def test_two_by_two_train_step_equals_jax_mesh(inputs, two_by_two, weighting):
    """2 data x 2 model ranks (every kernel of TIMED (8, 16) split on its
    output channels) against JAX's ``make_mesh(n_data=2, n_model=2)``."""
    from timed_design_tpu.parallel import make_mesh as jax_make_mesh

    out, _ = _results(two_by_two)
    assert out["shape"] == {"data": 2, "model": 2}
    assert out["sliced"]["blocks.1.conv.weight"][0] == FILTERS[1] // 2
    _assert_step_close(_port_step(two_by_two, weighting),
                       _jax_train_step(inputs, jax_make_mesh(n_data=2, n_model=2), weighting))


@pytest.mark.parametrize("weighting", ["none", "balanced"])
def test_two_by_two_equals_two_by_one(two_data, two_by_two, weighting):
    """The model axis changes no number past rounding: the 2 x 2 step
    against the port's 2 x 1 step on the same batch. Every rank of the
    2 x 2 world holds the same gathered tree."""
    _assert_step_close(_port_step(two_by_two, weighting), _port_step(two_data, weighting))
    want = _results(two_by_two)[1]
    for rank in (1, 2, 3):
        got = _results(two_by_two, rank)[1]
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"rank {rank}: {k}")


def test_two_by_two_densenet_buffers_take_the_whole_bias(two_by_two):
    """DenseNet's evaluation forward through its block buffers, every
    convolution split over the model axis: each pass after a convolution
    adds the bias gathered whole, so the logits equal the unsplit module's,
    and the split module's concatenating path (autograd on), on every rank,
    within 1e-5."""
    for rank in range(4):
        arrays = _results(two_by_two, rank)[1]
        for path in ("buffered", "concatenated"):
            np.testing.assert_allclose(arrays[f"densenet_{path}"], arrays["densenet_whole"],
                                       atol=1e-5)


def test_two_by_two_checkpoint_is_the_whole_tree(inputs, two_by_two):
    """The checkpoint written under the model axis holds every leaf whole
    (the JAX init's shapes), loads in the JAX package's
    ``load_checkpoint_params`` and the port's, and equals the gathered
    weights after the step."""
    from timed_design_tpu.train import load_checkpoint_params as jax_load

    from timed_design_tpu_torch.train import load_checkpoint_params

    _, variables, _ = inputs
    _, arrays = _results(two_by_two)
    path = two_by_two / "ckpt_none.npz"
    for loaded in (jax_load(path), load_checkpoint_params(path)):
        params, stats = _flat(loaded["params"]), _flat(loaded["batch_stats"])
        init = _flat(variables["params"])
        assert {k: v.shape for k, v in params.items()} == {k: v.shape for k, v in init.items()}
        for k, v in _sub(arrays, "params_none").items():
            np.testing.assert_array_equal(params[k], v, err_msg=k)
        for k, v in _sub(arrays, "stats_none").items():
            np.testing.assert_array_equal(stats[k], v, err_msg=k)


# ------------------------------------------------------------ td-predict

def test_torchrun_td_predict_writes_once(inputs, tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2`` of the port's
    ``td-predict --device cpu`` on 1ubq (76 frames, batch 40: two batches
    split over two gloo ranks), each rank in a directory of its own: rank 0
    writes every file, byte-equal to the one-process run's; rank 1 writes
    nothing."""
    work, _, _ = inputs
    ckpt = f"TIMED@{work / 'init.npz'}"
    args = ["--voxelize", "--path_to_dataset", str(UBQ), "--path_to_model", ckpt,
            "--path_to_output", "out", "--path_to_datasetmap", "out/datasetmap.txt",
            "--batch_size", "40", "--device", "cpu"]
    script = tmp_path / "predict.py"
    script.write_text(_PREDICT)
    for r in (0, 1):
        (tmp_path / f"rank{r}").mkdir()
    (tmp_path / "single").mkdir()
    _run_world([[sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", "2", str(script), *args]], cwd=tmp_path)
    _run_world([[sys.executable, "-c", _HYGIENE + "import runpy; runpy.run_module("
                 "'timed_design_tpu_torch.cli.predict', run_name='__main__')", *args]],
               cwd=tmp_path / "single")
    assert not any((tmp_path / "rank1").iterdir())
    want = sorted(p.name for p in (tmp_path / "single" / "out").iterdir())
    assert "TIMED.fasta" in want and "TIMED.csv" in want
    assert sorted(p.name for p in (tmp_path / "rank0" / "out").iterdir()) == want
    for name in want:
        assert (tmp_path / "rank0" / "out" / name).read_bytes() == \
            (tmp_path / "single" / "out" / name).read_bytes(), name


# ------------------------------------------------------------------ card

@pytest.mark.cuda
def test_nccl_world_of_one_predicts_as_one_card():
    """World size 1 over NCCL: ``Predictor(mesh=make_mesh())`` gives
    probabilities ``torch.equal`` to the single-card Predictor's (registry
    TIMED widths, bf16, batch 512, random weights from a seed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import torch.distributed as dist

    from timed_design_tpu_torch.engine import Predictor
    from timed_design_tpu_torch.models import TIMED
    from timed_design_tpu_torch.parallel import initialize_distributed, make_mesh

    torch.manual_seed(0)
    module = TIMED(compute_dtype=torch.bfloat16)
    x = _frames(600, seed=5, side=21)
    want = Predictor(module, batch_size=512, device="cuda").predict_probs(x)
    assert initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0) == (0, 1)
    try:
        mesh = make_mesh()
        got = Predictor(module, batch_size=512, mesh=mesh).predict_probs(x)
    finally:
        dist.destroy_process_group()
    assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))
