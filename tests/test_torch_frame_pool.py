"""PyTorch port: td-predict's frame set over the pool of host worker
processes (``voxel/frame_pool.py``) against the same frame set made in
process, on the CPU. The pool is forced on by patching its worker count.

The module's top level imports nothing heavy: a worker imports it when a
test hands it ``_python_scanned``."""
import contextlib
import dataclasses
import gzip
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

from timed_design_tpu_torch.voxel import frame_pool

UBQ = Path(__file__).resolve().parent / "testing_files" / "1ubq.pdb1.gz"
SIZE = 2  # workers of the forced pool
_IN_WORKER = frame_pool.frame_atoms_in_worker


def _python_scanned(paths, codec, all_states):
    """``frame_atoms_in_worker`` with the C++ scanner out of reach, in the
    process that runs it."""
    from timed_design_tpu_torch.structure import _native

    keep = _native.scan_pdb_native
    _native.scan_pdb_native = lambda text: None
    try:
        return _IN_WORKER(paths, codec, all_states)
    finally:
        _native.scan_pdb_native = keep


@pytest.fixture
def pool(monkeypatch):
    """A fresh pool in the place of the process's, of ``SIZE`` workers for
    calls on ``MIN_FILES`` files or more: the rule on a host of SIZE + 1
    cores."""
    fresh = frame_pool.FramePool()
    monkeypatch.setattr(frame_pool, "POOL", fresh)
    monkeypatch.setattr(frame_pool, "pool_workers",
                        lambda n: frame_pool.workers_for(n, SIZE + 1, 1))
    yield fresh
    fresh.close()


def _wait_up(pool):
    deadline = time.monotonic() + 60
    while (workers := pool.acquire(SIZE)) is None:
        assert time.monotonic() < deadline, "the pool did not start"
        time.sleep(0.02)
    pool.release(workers)
    return workers


def _make(paths, in_process=False, **kwargs):
    """make_frame_set of ``paths`` (in process if asked) under the span
    recorder: the FrameSet, its counters and the warnings it raised."""
    from timed_design_tpu_torch.utils.timing import recording
    from timed_design_tpu_torch.voxel import make_frame_set

    with contextlib.ExitStack() as stack:
        if in_process:
            stack.enter_context(mock.patch.object(frame_pool, "pool_workers", lambda n: 0))
        rec = stack.enter_context(recording())
        caught = stack.enter_context(warnings.catch_warnings(record=True))
        warnings.simplefilter("always")
        fs = make_frame_set(paths, **kwargs)
    return fs, rec.counters, sorted(str(w.message) for w in caught)


def _assert_same(a, b):
    """Two FrameSets equal field for field and bit for bit."""
    assert [n for n, _ in a.structures] == [n for n, _ in b.structures]
    for (_, x), (_, y) in zip(a.structures, b.structures):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if isinstance(u, np.ndarray):
                assert (u.dtype, u.shape, u.tobytes()) == (v.dtype, v.shape, v.tobytes()), f.name
            else:
                assert type(u) is type(v) and u == v, f.name
                assert [type(e) for e in u] == [type(e) for e in v], f.name
    assert a.index == b.index
    assert [x.tobytes() for x in a.label_index] == [y.tobytes() for y in b.label_index]
    for name in ("_atoms", "_frames", "_atom_count", "_atom_start", "_row_start"):
        assert getattr(a, name).tobytes() == getattr(b, name).tobytes(), name


def _ubq_atoms():
    return [l for l in gzip.decompress(UBQ.read_bytes()).decode().splitlines()
            if l.startswith("ATOM")]


def _nmr_text(atoms, seed, n_states=4, gap_in_state=None):
    """``n_states`` states of 1ubq's residues 1-10, moved by seeded noise;
    residue 5 left out of state ``gap_in_state``."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_states):
        out.append(f"MODEL     {k + 1:4d}")
        for l in atoms:
            res = int(l[22:26])
            if res > 10 or (k == gap_in_state and res == 5):
                continue
            x, y, z = (float(l[30:38]), float(l[38:46]), float(l[46:54])) + rng.normal(0, 0.3, 3)
            out.append(f"{l[:30]}{x:8.3f}{y:8.3f}{z:8.3f}{l[54:]}")
        out.append("ENDMDL")
    return "\n".join(out + ["END"]) + "\n"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Sets of PDB files by case, each more files than the forced pool's
    workers: ``multichain`` (1-6 noisy chains, a file written chain B
    first, an insertion code), ``gz`` (gzipped files and 1ubq), ``nmr``
    (states, one file missing a residue in one state), ``many`` (30
    files, more chunks than workers)."""
    from tdbench import structures

    d = tmp_path_factory.mktemp("frame_pool")
    rng = np.random.default_rng(2900000023)
    chain = structures.chain_atoms()

    def text(chains):
        return structures.backbone_text(rng, structures.RESIDUES_PER_CHAIN * chains,
                                        0.2, 50.0, chain)

    atoms = _ubq_atoms()
    first20 = [l for l in atoms if int(l[22:26]) <= 20]
    out = {name: [] for name in ("multichain", "gz", "nmr", "many")}
    for case in out:
        (d / case).mkdir()
    for k, chains in enumerate((1, 6, 2, 5, 3, 4, 6, 1, 2, 3)):
        out["multichain"].append(d / "multichain" / f"m{k:02d}.pdb")
        out["multichain"][-1].write_text(text(chains))
    b_first = ([f"{l[:21]}B{l[22:]}" for l in first20] + ["TER"]
               + [f"{l[:21]}A{l[22:30]}{float(l[30:38]) + 40.0:8.3f}{l[38:]}" for l in first20])
    ins = [f"{l[:22]}   2A{l[27:]}" if int(l[22:26]) == 10 else l
           for l in atoms if int(l[22:26]) <= 12]
    for name, lines in (("zz2b", b_first), ("Ains", ins)):
        out["multichain"].append(d / "multichain" / f"{name}.pdb")
        out["multichain"][-1].write_text("\n".join(lines + ["END"]) + "\n")
    for k in range(4):
        out["gz"].append(Path(shutil.copy(UBQ, d / "gz" / f"u{k}.pdb1.gz")))
    for k, chains in enumerate((3, 1, 4, 2, 6)):
        out["gz"].append(d / "gz" / f"g{k}.pdb.gz")
        out["gz"][-1].write_bytes(gzip.compress(text(chains).encode()))
    for k in range(9):
        out["nmr"].append(d / "nmr" / f"n{k}.pdb")
        out["nmr"][-1].write_text(_nmr_text(atoms, seed=k, gap_in_state=1 if k in (2, 5) else None)
                                  if k % 3 != 1 else text(2))
    for k in range(30):
        out["many"].append(d / "many" / f"s{k:02d}.pdb")
        out["many"][-1].write_text(text(1 + k % 6))
    return out


@pytest.mark.parametrize("case,all_states", [
    ("multichain", False), ("gz", False), ("nmr", True), ("nmr", False), ("many", False)])
def test_pooled_equals_in_process(pool, files, case, all_states):
    """Every file done by a worker gives the same FrameSet as every file
    done in process, the same counters but ``pooled_files``, and the same
    warnings (the NMR states' alignment)."""
    paths = files[case]
    want, want_counts, want_warned = _make(paths, in_process=True,
                                           voxelise_all_states=all_states)
    _wait_up(pool)
    got, got_counts, got_warned = _make(paths, voxelise_all_states=all_states)
    _assert_same(want, got)
    assert got_warned == want_warned
    if case == "nmr" and all_states:
        assert len(want_warned) == 2 and "aligning 4 NMR states" in want_warned[0]
    assert want_counts.pop("frame_set.pooled_files") == 0
    assert got_counts.pop("frame_set.pooled_files") == len(paths)
    assert got_counts == want_counts
    assert want_counts["frame_set.files"] == len(paths) and want_counts["frame_set.atoms"] > 0


def test_python_scanner_pooled_equals_in_process(pool, files, monkeypatch):
    """With the C++ scanner out of reach, in process and in the workers:
    the same FrameSet, and every file counted in ``python_scans``."""
    import timed_design_tpu_torch.structure._native as native

    paths = files["multichain"]
    with monkeypatch.context() as m:
        m.setattr(native, "scan_pdb_native", lambda text: None)
        want, want_counts, _ = _make(paths, in_process=True)
    monkeypatch.setattr(frame_pool, "frame_atoms_in_worker", _python_scanned)
    _wait_up(pool)
    got, got_counts, _ = _make(paths)
    _assert_same(want, got)
    assert got_counts["frame_set.pooled_files"] == len(paths)
    assert want_counts["frame_set.python_scans"] == got_counts["frame_set.python_scans"] == len(paths)
    assert want_counts["frame_set.atoms"] == got_counts["frame_set.atoms"]


@pytest.mark.parametrize("fault", ["no_atom_records", "not_gzip"])
def test_a_malformed_file_raises_the_same_type(pool, files, tmp_path, fault):
    paths = list(files["gz"])
    if fault == "no_atom_records":
        bad = tmp_path / "bad.pdb"
        bad.write_text("REMARK   1 NOTHING HERE\nEND\n")
    else:
        bad = tmp_path / "bad.pdb.gz"
        bad.write_bytes(b"not gzip at all" * 100)
    paths.insert(3, bad)
    with pytest.raises(Exception) as in_process:
        _make(paths, in_process=True)
    _wait_up(pool)
    with pytest.raises(Exception) as pooled:
        _make(paths)
    assert type(pooled.value) is type(in_process.value)
    assert type(in_process.value) is (ValueError if fault == "no_atom_records"
                                      else gzip.BadGzipFile)
    # the workers are whole again for the next call
    _, counts, _ = _make(files["gz"])
    assert counts["frame_set.pooled_files"] == len(files["gz"])


def test_below_the_threshold_nothing_is_pooled(pool, files):
    paths = files["multichain"][: frame_pool.MIN_FILES - 1]
    for _ in range(2):
        _, counts, _ = _make(paths)
        assert counts["frame_set.pooled_files"] == 0
        assert counts["frame_set.files"] == len(paths)


@pytest.mark.parametrize("local", [None, "4"], ids=["one_process", "torchrun_4"])
@pytest.mark.parametrize("cores", [1, 2, 8, 64])
def test_size_rule(monkeypatch, cores, local):
    """Workers = usable cores over the local world size, less one for the
    caller, at most 16; none below 2 workers or 8 files."""
    monkeypatch.setattr(frame_pool.os, "sched_getaffinity", lambda pid: set(range(cores)))
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    want = {(1, None): 0, (2, None): 0, (8, None): 7, (64, None): 16,
            (1, "4"): 0, (2, "4"): 0, (8, "4"): 0, (64, "4"): 15}[cores, local]
    assert frame_pool.pool_workers(100) == want
    assert frame_pool.pool_workers(frame_pool.MIN_FILES) == want
    assert frame_pool.pool_workers(frame_pool.MIN_FILES - 1) == 0


def test_a_killed_worker_falls_back_in_process(pool, files):
    """A worker killed before a call: the call finishes in process with
    the same FrameSet, and the pool starts new workers, once; after a
    second loss the calls stay in process."""
    paths = files["multichain"]
    want, _, _ = _make(paths, in_process=True)
    for loss in range(2):
        workers = _wait_up(pool)
        os.kill(workers.pids[0], signal.SIGKILL)
        got, counts, _ = _make(paths)
        _assert_same(want, got)
        assert counts["frame_set.pooled_files"] < len(paths)
        assert workers.proc.poll() is not None  # the lost workers are ended and reaped
        for pid in workers.pids:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)
    time.sleep(0.5)
    assert pool.acquire(SIZE) is None
    got, counts, _ = _make(paths)
    _assert_same(want, got)
    assert counts["frame_set.pooled_files"] == 0


def test_the_first_call_does_not_wait_for_the_pool(pool, files, monkeypatch):
    """While the workers start, a call does its files in process."""
    paths = files["multichain"]
    starting, go = threading.Event(), threading.Event()
    start = pool._start

    def slow_start(size, generation):
        starting.set()
        go.wait(60)
        start(size, generation)

    monkeypatch.setattr(pool, "_start", slow_start)
    want, _, _ = _make(paths, in_process=True)
    try:
        got, counts, _ = _make(paths)
        assert starting.is_set() and counts["frame_set.pooled_files"] == 0
        _assert_same(want, got)
    finally:
        go.set()
    _wait_up(pool)
    assert _make(paths)[1]["frame_set.pooled_files"] == len(paths)


def test_two_calls_at_once(pool, files):
    """Two threads' calls at once: the one that holds the workers hands
    them its files, the other works in process while they are held; both
    give the same FrameSet."""
    from timed_design_tpu_torch.utils.timing import recording
    from timed_design_tpu_torch.voxel import make_frame_set

    paths = files["many"]
    want, _, _ = _make(paths, in_process=True)
    _wait_up(pool)
    got = [None] * 4

    def call(k):
        got[k] = make_frame_set(paths)

    with recording() as rec:
        threads = [threading.Thread(target=call, args=(k,)) for k in range(len(got))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    for fs in got:
        _assert_same(want, fs)
    assert rec.counters["frame_set.files"] == len(got) * len(paths)
    assert len(paths) <= rec.counters["frame_set.pooled_files"] <= len(got) * len(paths)


def test_pooled_spans(pool, files):
    """A pooled call: one ``frame_set.gather`` span on the caller's thread;
    each file's parse and frame-atom spans under its worker's thread name,
    children of the gather span, inside it on the one clock."""
    from timed_design_tpu_torch.utils.timing import recording
    from timed_design_tpu_torch.voxel import make_frame_set

    paths = files["many"]
    workers = _wait_up(pool)
    with recording() as rec:
        make_frame_set(paths)
    (whole,) = [s for s in rec.spans if s.name == "frame_set"]
    (gather,) = [s for s in rec.spans if s.name == "frame_set.gather"]
    assert gather.thread == whole.thread and gather.parent == whole.index
    names = {f"frame_set worker {pid}" for pid in workers.pids}
    for part in ("frame_set.parse", "frame_set.frame_atoms"):
        spans = [s for s in rec.spans if s.name == part]
        assert len(spans) == len(paths)
        assert {s.thread for s in spans} <= names and len({s.thread for s in spans}) == SIZE
        assert all(s.parent == gather.index for s in spans)
        assert all(gather.start_ns <= s.start_ns <= s.end_ns <= gather.end_ns for s in spans)


def test_the_workers_start_from_one_interpreter_at_the_lowest_priority(pool):
    """The workers are forks of one interpreter, which imported the worker
    module once; they run at nice 19, so that their start and their work
    yield to the caller's threads."""
    workers = _wait_up(pool)
    assert len(set(workers.pids)) == SIZE and workers.proc.pid not in workers.pids
    for pid in workers.pids:
        assert os.getpriority(os.PRIO_PROCESS, pid) == min(os.getpriority(os.PRIO_PROCESS, 0) + 19, 19)
        with open(f"/proc/{pid}/stat") as f:
            assert int(f.read().rsplit(")", 1)[1].split()[1]) == workers.proc.pid


def test_the_worker_module_imports_no_torch():
    code = ("import sys, timed_design_tpu_torch.voxel.frame_pool; "
            "assert 'torch' not in sys.modules, sorted(sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=Path(__file__).resolve().parents[1],
                   timeout=120)


def test_the_package_keeps_the_voxelize_function():
    """``timed_design_tpu_torch.voxel.voxelize`` stays the voxelizer's
    function, as in the JAX package, once the module of that name is
    imported too, and gives what the module's function gives."""
    import torch

    import timed_design_tpu_torch.voxel as voxel
    from timed_design_tpu_torch.voxel import voxelize_frame_atoms  # noqa: F401 (imports the module)

    module = sys.modules["timed_design_tpu_torch.voxel.voxelize"]
    assert callable(voxel.voxelize) and voxel.voxelize is not module
    g = torch.Generator().manual_seed(0)
    args = (torch.randn(6, 3, generator=g) * 3, torch.tensor([0, 1, 2, 3, 1, 0]),
            torch.full((6,), 0.8), torch.zeros(6), torch.zeros(2, 3),
            torch.eye(3).expand(2, 3, 3).contiguous())
    want = module.voxelize(*args, n_channels=4, voxels_per_side=5)
    assert want.abs().sum() > 0
    assert torch.equal(voxel.voxelize(*args, n_channels=4, voxels_per_side=5), want)


def _share_record(counters, kind="predict"):
    return {"kind": kind, "passes": [{"frames": 10, "wall_s": 1.0}],
            "spans": [("frame_set", 0, 6e5, "MainThread", None)], "device_spans": [],
            "counters": counters, "idle_by_span": {"": 0.0}}


@pytest.mark.parametrize("record,want", [
    (_share_record({"frame_set.files": 200, "frame_set.pooled_files": 150}), 75.0),
    (_share_record({"frame_set.files": 100, "frame_set.pooled_files": 0}), 0.0),
    (_share_record({"frame_set.atoms": 10}), None),  # a program without the pool
    (_share_record({"frame_set.files": 100, "frame_set.pooled_files": 100}, "train"), None),
    ({"kind": "predict", "passes": [{"frames": 1, "wall_s": 1.0}]}, None),  # no window
], ids=["three_quarters", "none_pooled", "no_counter", "train", "no_window"])
def test_pooled_share_reader(monkeypatch, record, want):
    """``predict.frame_set_pooled_share``: the pooled files over the files
    of the window, and nothing read where the program does not count them."""
    from tdbench import harness, program_trace

    monkeypatch.setattr(program_trace, "_last", {})
    assert harness.load_reader("predict.frame_set_pooled_share").read(record) == want
