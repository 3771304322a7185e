"""PyTorch port, the span recorder (``utils/timing.py``) and the spans and
counters that td-predict and td-train record, on the CPU."""
import contextlib
import dataclasses
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from timed_design_tpu_torch.utils import PhaseTimer
from timed_design_tpu_torch.utils.timing import count, device_span, recording, span

UBQ = Path(__file__).resolve().parent / "testing_files" / "1ubq.pdb1.gz"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several workers per host
    yield
    torch.set_num_threads(n)


def _names(rec, name):
    return [s for s in rec.spans if s.name == name]


def test_off_is_one_shared_object_and_keeps_nothing():
    first = span("a")
    assert span("b", 7) is first
    assert device_span("c", 1, device=torch.device("cpu")) is first
    with span("a"), span("b", 3):
        count("n", 5)
    with recording() as rec:
        pass
    assert rec.spans == [] and rec.device_spans == [] and rec.counters == {}


def test_spans_nest_by_thread_with_ids():
    seen = threading.Event()

    def writer():
        with span("write_batch", 4):
            seen.set()

    with recording() as rec:
        with span("outer"):
            with span("inner", 4):
                th = threading.Thread(target=writer, name="csv-writer")
                th.start()
                th.join(timeout=30)
            count("n", 2)
            count("n", 3)
        with pytest.raises(RuntimeError, match="already recording"):
            with recording():
                pass
    assert not th.is_alive() and seen.is_set()
    (outer,), (inner,), (w,) = (_names(rec, n) for n in ("outer", "inner", "write_batch"))
    main = threading.current_thread().name
    assert (outer.parent, outer.thread, outer.id) == (None, main, None)
    assert (inner.parent, inner.thread, inner.id) == (outer.index, main, 4)
    assert (w.parent, w.thread, w.id) == (None, "csv-writer", 4)
    assert outer.start_ns <= inner.start_ns <= w.start_ns <= w.end_ns <= inner.end_ns \
        <= outer.end_ns
    assert rec.counters == {"n": 5}
    # a span that ends after its recording closed is not kept
    with recording() as late:
        s = span("late")
        s.__enter__()
    s.__exit__(None, None, None)
    assert late.spans == []


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_phase_timer_totals_and_spans(on):
    t = PhaseTimer()
    with recording() if on else contextlib.nullcontext() as rec:
        for i in range(3):
            with t.phase("a", i):
                pass
        with t.phase("b"):
            pass
        with pytest.raises(ValueError):
            with t.phase("b"):
                raise ValueError
    s = t.summary()
    assert set(s) == {"a", "b"} and s == t.phases and s is not t.phases
    assert all(v >= 0 for v in s.values())
    if on:
        assert [x.id for x in _names(rec, "a")] == [0, 1, 2] and len(_names(rec, "b")) == 2
        spans_a = sum(x.end_ns - x.start_ns for x in _names(rec, "a")) / 1e9
        assert spans_a <= s["a"]


def _copies(tmp_path, n):
    paths = []
    for i in range(n):
        p = tmp_path / f"s{i}.pdb.gz"
        shutil.copy(UBQ, p)
        paths.append(p)
    return paths


def test_make_frame_set_spans(tmp_path):
    from timed_design_tpu_torch.voxel import make_frame_set

    paths = _copies(tmp_path, 3)
    with recording() as rec:
        fs = make_frame_set(paths)
    assert len(fs.structures) == 3
    counts = {n: len(_names(rec, n)) for n in (
        "frame_set", "frame_set.parse", "frame_set.frame_atoms", "frame_set.index")}
    assert counts == {"frame_set": 1, "frame_set.parse": 3, "frame_set.frame_atoms": 3,
                      "frame_set.index": 1}
    (whole,) = _names(rec, "frame_set")
    assert all(s.parent == whole.index for s in rec.spans if s is not whole)


@pytest.mark.parametrize("scanner", ["native", "python"])
def test_make_frame_set_counters(tmp_path, scanner, monkeypatch):
    """``frame_set.atoms`` counts the atom records of every file; the
    Python scanner counts a file in ``frame_set.python_scans``, the C++
    one none; ``frame_set.files`` counts the files, and
    ``frame_set.pooled_files`` none of them below the pool's threshold."""
    import timed_design_tpu_torch.structure._native as native
    from tdbench import structures
    from timed_design_tpu_torch.voxel import make_frame_set

    if scanner == "native":
        assert native.native_available()
    else:
        monkeypatch.setattr(native, "scan_pdb_native", lambda text: None)
    rng = np.random.default_rng(3000000017)
    paths, records = [], 0
    for i, chains in enumerate((1, 3, 2)):
        text = structures.backbone_text(rng, chains * structures.RESIDUES_PER_CHAIN)
        records += sum(line.startswith("ATOM") for line in text.splitlines())
        paths.append(tmp_path / f"s{i}.pdb")
        paths[-1].write_text(text)
    with recording() as rec:
        make_frame_set(paths)
    assert records > 0
    assert rec.counters == {"frame_set.atoms": records,
                            "frame_set.python_scans": 0 if scanner == "native" else 3,
                            "frame_set.files": 3, "frame_set.pooled_files": 0}
    make_frame_set(paths[:1])  # off: nothing counted
    assert rec.counters["frame_set.atoms"] == records


def test_pad_counters_by_hand():
    """Two structures of 1ubq's N atoms and of 150: a call on rows of the
    first once and of the second twice computes 3 x N pairs, of which
    N + 150 + 150 are real."""
    from timed_design_tpu_torch.structure import load_pdb
    from timed_design_tpu_torch.voxel import Codec, structure_to_frame_atoms
    from timed_design_tpu_torch.voxel.dataset import FrameSet

    c = Codec.from_string("CNOCACB")
    fa = structure_to_frame_atoms(load_pdb(UBQ), c)
    small = dataclasses.replace(fa, **{k: getattr(fa, k)[:150] for k in (
        "atoms_xyz", "atom_channel", "atom_sigma", "atom_prop")})
    fs = FrameSet([("big", fa), ("small", small)], c)
    N = len(fa.atom_channel)
    assert N > 150
    with recording() as rec:
        fs.voxelize_rows(np.array([0, 1, 1]), np.array([0, 1, 2]), torch.device("cpu"))
    assert rec.counters == {"voxelize.pairs_real": N + 300, "voxelize.pairs_computed": 3 * N}
    fs.voxelize_rows(np.array([1]), np.array([0]), torch.device("cpu"))  # off: nothing counted
    assert rec.counters == {"voxelize.pairs_real": N + 300, "voxelize.pairs_computed": 3 * N}


def test_device_span_records_nothing_on_the_cpu():
    with recording() as rec:
        with device_span("voxelize", 0, device=torch.device("cpu")):
            torch.ones(3).sum()
    assert rec.device_spans == [] and rec.spans == []


@pytest.mark.parametrize("n_models,batch_size", [(1, 40), (2, 8)],
                         ids=["one_model", "two_models_ten_batches"])
def test_load_dataset_and_predict_spans(tmp_path, n_models, batch_size):
    """Batches of 1ubq's 76 frames: a next_batch, fetch_wait and
    write_batch span each, with the batch's index; ``loader_wait_s`` is the
    next_batch phase's total; forward and voxelize are device spans, none
    on the CPU. Two models share each device batch over ten batches, more
    than the four in flight: each model's CSV holds its own Predictor's
    ``predict_probs`` of the same batches, in input order."""
    from timed_design_tpu_torch.engine import Predictor, load_dataset_and_predict
    from timed_design_tpu_torch.io import load_datasetmap, load_prediction_matrix
    from timed_design_tpu_torch.models import timed
    from timed_design_tpu_torch.voxel import FrameBatchSource, make_frame_set

    torch.manual_seed(0)
    fs = make_frame_set([UBQ])
    models = [timed(filters=(4, 8)).eval() for _ in range(n_models)]
    if n_models > 1:
        for i, m in enumerate(models):
            m.name = f"m{i}"
    with recording() as rec:
        result = load_dataset_and_predict(models, fs, batch_size=batch_size,
                                          dataset_map_path=tmp_path / "datasetmap.txt",
                                          path_to_output=tmp_path, device="cpu")
    n_batches = -(-76 // batch_size)
    for name, thread in (("next_batch", "MainThread"), ("fetch_wait", "MainThread"),
                         ("write_batch", "csv-writer")):
        got = _names(rec, name)
        assert [s.id for s in got] == list(range(n_batches)), name
        assert {s.thread for s in got} == {thread}, name
    if n_models > 1:
        dmap = load_datasetmap(tmp_path / "datasetmap.txt", is_old=True)
        frames = torch.cat([X[:n] for X, _, n in FrameBatchSource(fs, dmap, batch_size,
                                                                  device="cpu")])
        for m in models:
            want = Predictor(m, batch_size=batch_size, device="cpu").predict_probs(frames)
            got = load_prediction_matrix(tmp_path / f"{m.name}.csv", dtype=np.float64)
            np.testing.assert_array_equal(got, want.astype(np.float16))
    waits = sum(s.end_ns - s.start_ns for s in _names(rec, "next_batch")) / 1e9
    assert waits <= result.loader_wait_s <= waits + 0.01
    (whole,) = _names(rec, "td_predict")
    (predict,) = _names(rec, "predict")
    assert predict.parent == whole.index
    assert all(s.parent == predict.index for s in _names(rec, "next_batch"))
    assert set(result.timings) == {"datasetmap", "predict", "decode", "write"}
    assert rec.device_spans == []
    assert rec.counters["voxelize.pairs_computed"] == 76 * len(fs.structures[0][1].atom_channel)


def test_fit_spans():
    """``fit`` over two host batches: a span of each kind a step, with the
    step number as its id."""
    from timed_design_tpu_torch.models import timed
    from timed_design_tpu_torch.train import fit

    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        y = np.zeros((4, 20), np.float32)
        y[np.arange(4), rng.integers(0, 20, 4)] = 1
        batches.append((rng.random((4, 9, 9, 9, 5), np.float32), y, 4))
    with recording() as rec:
        fit(timed(filters=(4, 8)), batches, n_classes=20, log_every=1, device="cpu")
    (whole,) = _names(rec, "train.fit")
    for name in ("train.step", "train.log"):
        assert [s.id for s in _names(rec, name)] == [0, 1], name
        assert {s.parent for s in _names(rec, name)} == {whole.index}
    # the last next_batch finds the loader empty
    assert [s.id for s in _names(rec, "train.next_batch")] == [0, 1, 2]
    assert rec.device_spans == []



@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_span_times_the_card(cuda_device):
    """A device span around a sleep kernel holds its time, read when the
    recording closes; none is kept while the stream is captured."""
    with recording() as rec:
        with device_span("sleep", 7, device=cuda_device):
            torch.cuda._sleep(1_000_000)
        x = torch.zeros(8, device=cuda_device)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            with device_span("captured", device=cuda_device):
                x.add_(1)
        graph.replay()
    (name, id_, ms), = rec.device_spans
    assert (name, id_) == ("sleep", 7) and ms > 0.1
    assert rec.spans == []
