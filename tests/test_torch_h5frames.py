"""PyTorch port, HDF5 frame datasets: ``voxel/dataset.py::make_frame_dataset``
(``td-voxelize``), ``io/h5frames.py`` (the map, ``FrameBatchLoader``,
``convert_to_flat``, ``td-convert-dataset``) against the JAX package's on the
same inputs, h5py reading both packages' files.

Tolerances:
  - frames the port voxelizes against the JAX package's: 2e-5
    (``tests/test_voxel.py``'s); frames stored as bfloat16, 2e-5 plus the
    bfloat16 spacing at the value (a value 2e-5 away may round to the
    neighbouring bfloat16);
  - everything read from a file (batches, maps, labels, converted files):
    exact, both packages read the same bytes;
  - attributes, dataset names, dtypes, chunks, filters: equal.
"""
import gzip
import os
import subprocess
import sys
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    import h5py
except ImportError:  # the card's machine, where only the cuda-marked test runs
    h5py = None

REPO = Path(__file__).resolve().parent.parent
UBQ = REPO / "tests" / "testing_files" / "1ubq.pdb1.gz"
BATCH = 32
ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several workers per host
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pdbs(tmp_path_factory):
    """1ubq and a two-state NMR file (1ubq, then 1ubq moved 0.3 A in x)."""
    text = gzip.open(UBQ).read().decode()
    atoms = [l for l in text.splitlines() if l[:6] in ("ATOM  ", "HETATM")]

    def shift(line, dx):
        return f"{line[:30]}{float(line[30:38]) + dx:8.3f}{line[38:]}"

    d = tmp_path_factory.mktemp("h5frames_pdbs")
    nmr = d / "2nmr.pdb"
    nmr.write_text("MODEL        1\n" + "\n".join(atoms) + "\nENDMDL\nMODEL        2\n"
                   + "\n".join(shift(l, 0.3) for l in atoms) + "\nENDMDL\n")
    return [UBQ, nmr]


# case -> make_frame_dataset keywords
WRITES = {
    "tree": {},
    "flat": {"layout": "flat"},
    "flat_bf16": {"layout": "flat", "frame_dtype": "bfloat16"},
}


@pytest.fixture(scope="module")
def written(tmp_path_factory, pdbs):
    """{case: (JAX file, port file)} of 1ubq and both NMR states."""
    from timed_design_tpu.voxel import make_frame_dataset as jax_make

    from timed_design_tpu_torch.voxel import make_frame_dataset

    d = tmp_path_factory.mktemp("h5frames_written")
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for case, kw in WRITES.items():
            out[case] = (jax_make(pdbs, d / f"jax_{case}.hdf5", voxelise_all_states=True, **kw),
                         make_frame_dataset(pdbs, d / f"port_{case}.hdf5",
                                            voxelise_all_states=True, device="cpu", **kw))
    return out


def _bf16_values(bits: np.ndarray) -> np.ndarray:
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16).float().numpy()


def _same_file(want, got, frames_tol: bool, where="/"):
    """Two h5py objects: keys, attributes, dtypes, layout; frames within the
    module's tolerance where ``frames_tol``, everything else exactly."""
    assert list(got.attrs) == list(want.attrs), where
    for k in want.attrs:
        a, b = want.attrs[k], got.attrs[k]
        assert type(b) is type(a), (where, k)
        if isinstance(a, np.ndarray):
            assert b.dtype == a.dtype and b.tolist() == a.tolist(), (where, k)
        else:
            assert b == a, (where, k)
    if isinstance(want, h5py.Dataset):
        assert (got.shape, got.dtype, got.chunks, got.compression, got.compression_opts,
                got.maxshape, got.shuffle) == (want.shape, want.dtype, want.chunks,
                                               want.compression, want.compression_opts,
                                               want.maxshape, want.shuffle), where
        a, b = want[()], got[()]
        if frames_tol and a.dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=0, atol=ATOL, err_msg=where)
        elif frames_tol and a.dtype == np.uint16:  # bfloat16 bits
            wa, wb = _bf16_values(a), _bf16_values(b)
            spacing = np.abs(wa) * 2.0 ** -7
            assert (np.abs(wb - wa) <= ATOL + spacing).all(), where
        else:
            assert b.dtype == a.dtype and b.tolist() == a.tolist(), where
        return
    assert list(got.keys()) == list(want.keys()), where
    for k in want:
        _same_file(want[k], got[k], frames_tol, f"{where}{k}/")


@pytest.mark.parametrize("case", list(WRITES))
def test_make_frame_dataset_equals_jax(written, case):
    """The port's file of 1ubq and the two NMR states (tree, flat float32,
    flat bfloat16) against the JAX package's: the same names, attributes,
    dtypes, chunks and gzip level; frames within 2e-5."""
    jax_file, port_file = written[case]
    with h5py.File(jax_file, "r") as want, h5py.File(port_file, "r") as got:
        _same_file(want, got, frames_tol=True)
        if case == "tree":
            assert got["2nmr_1/A/10"].chunks == (21, 21, 21, 5)  # one chunk a frame


MAKE_REFUSALS = {
    "layout": ({"layout": "columns"}, "layout must be"),
    "frame_dtype": ({"layout": "flat", "frame_dtype": "float16"}, "frame_dtype must be"),
    "bf16_tree": ({"frame_dtype": "bfloat16"}, "requires layout='flat'"),
}


@pytest.mark.parametrize("case", list(MAKE_REFUSALS))
def test_make_frame_dataset_refuses_what_jax_refuses(tmp_path, case):
    """The JAX writer's argument checks, with its messages, in both packages."""
    from timed_design_tpu.voxel import make_frame_dataset as jax_make

    from timed_design_tpu_torch.voxel import make_frame_dataset

    kw, message = MAKE_REFUSALS[case]
    with pytest.raises(ValueError, match=message):
        jax_make([UBQ], tmp_path / "j.hdf5", **kw)
    with pytest.raises(ValueError, match=message):
        make_frame_dataset([UBQ], tmp_path / "p.hdf5", device="cpu", **kw)
    assert not (tmp_path / "p.hdf5").exists()


def _jax_batches(path, dmap, **kw):
    from timed_design_tpu.io import FrameBatchLoader as JaxLoader

    return [(np.asarray(X, np.float32), y, n) for X, y, n in JaxLoader(path, dmap, BATCH, **kw)]


def _port_batches(path, dmap, **kw):
    from timed_design_tpu_torch.io import FrameBatchLoader

    out = []
    for X, y, n in FrameBatchLoader(path, dmap, BATCH, **kw):
        assert X.device.type == "cpu" and X.shape[0] == BATCH
        out.append((X.float().numpy(), y, n))
    return out


def _same_batches(got, want):
    assert len(got) == len(want)
    for (Xg, yg, ng), (Xw, yw, nw) in zip(got, want):
        assert ng == nw
        np.testing.assert_array_equal(Xg, Xw)
        np.testing.assert_array_equal(yg, yw)


def _maps(path):
    from timed_design_tpu.io import create_flat_dataset_map as jax_map

    from timed_design_tpu_torch.io import create_flat_dataset_map

    return jax_map(path)[0], create_flat_dataset_map(path)[0]


@pytest.mark.parametrize("case", list(WRITES))
def test_jax_package_reads_the_ports_files(written, case):
    """The JAX package's create_flat_dataset_map and FrameBatchLoader read
    the port's file; their batches equal the port loader's."""
    _, port_file = written[case]
    jmap, pmap = _maps(port_file)
    assert jmap.entries == pmap.entries and len(pmap.entries) == 3 * 76
    _same_batches(_port_batches(port_file, pmap), _jax_batches(port_file, jmap))


@pytest.fixture(scope="module")
def jax_flat(tmp_path_factory, written):
    """The JAX package's flat files converted from its tree file (contiguous
    float32 and bfloat16), and an aposteriori-style copy of the tree whose
    frames h5py auto-chunks (about 32 chunks a frame)."""
    from timed_design_tpu.io.h5frames import convert_to_flat

    d = tmp_path_factory.mktemp("h5frames_flat")
    tree = written["tree"][0]
    auto = d / "auto.hdf5"
    with h5py.File(tree, "r") as fin, h5py.File(auto, "w") as fout:
        for k, v in fin.attrs.items():
            fout.attrs[k] = v
        for pdb in fin:
            for ch in fin[pdb]:
                for rid in fin[pdb][ch]:
                    node = fin[pdb][ch][rid]
                    ds = fout.create_dataset(f"{pdb}/{ch}/{rid}", data=node[()], compression="gzip")
                    for k, v in node.attrs.items():
                        ds.attrs[k] = v
    return {"flat_contiguous": convert_to_flat(tree, d / "f32.hdf5"),
            "flat_contiguous_bf16": convert_to_flat(tree, d / "bf16.hdf5", frame_dtype="bfloat16"),
            "autochunked": auto}


# case -> (file, loader keywords, map edit)
LOADS = {
    "tree": ("tree", {}, None),
    "tree_shuffled": ("tree", {"shuffle": True, "shuffle_seed": 3}, None),
    "tree_start_batch": ("tree", {"start_batch": 2}, None),
    "autochunked": ("autochunked", {}, None),
    "flat_chunked": ("flat", {}, None),
    "flat_chunked_shuffled": ("flat", {"shuffle": True, "shuffle_seed": 5}, None),
    "flat_contiguous": ("flat_contiguous", {}, None),
    "flat_contiguous_shuffled": ("flat_contiguous", {"shuffle": True, "shuffle_seed": 7}, None),
    "flat_contiguous_start_batch": ("flat_contiguous", {"start_batch": 3}, None),
    "flat_contiguous_bf16": ("flat_contiguous_bf16", {}, None),
    "flat_bf16_chunked": ("flat_bf16", {}, None),
    "flat_blacklisted_subset": ("flat_contiguous", {}, "drop_2nmr_0"),
    "flat_reordered_map": ("flat_chunked_reordered", {}, "reverse"),
}


@pytest.mark.parametrize("case", list(LOADS))
def test_loader_equals_jax_loader(written, jax_flat, case):
    """The port's FrameBatchLoader against the JAX package's on the JAX
    package's files: tree (one chunk a frame, or h5py's auto-chunking), flat
    chunked (make_frame_dataset) and contiguous (convert_to_flat), float32
    and bfloat16; in map order, shuffled (two epochs of one loader each),
    from a start batch, on a blacklist-filtered subset of a flat file, on a
    reordered map. Every batch equal."""
    name, kw, edit = LOADS[case]
    path = {**{k: v[0] for k, v in written.items()}, **jax_flat,
            "flat_chunked_reordered": written["flat"][0]}[name]
    jmap, pmap = _maps(path)
    assert jmap.entries == pmap.entries
    if edit == "drop_2nmr_0":
        from timed_design_tpu.io import create_flat_dataset_map as jax_map

        from timed_design_tpu_torch.io import create_flat_dataset_map

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jmap = jax_map(path, ["2nmr"], remove_blacklist_silently=True)[0]
            pmap = create_flat_dataset_map(path, ["2nmr"], remove_blacklist_silently=True)[0]
        assert jmap.entries == pmap.entries and len(pmap.entries) == 76
        assert pmap.row_identity_for is None
    elif edit == "reverse":
        from timed_design_tpu.io import DatasetMap as JaxMap

        from timed_design_tpu_torch.io import DatasetMap

        jmap, pmap = JaxMap(entries=jmap.entries[::-1]), DatasetMap(entries=pmap.entries[::-1])
    if kw.get("shuffle"):
        from timed_design_tpu.io import FrameBatchLoader as JaxLoader

        from timed_design_tpu_torch.io import FrameBatchLoader

        jl, pl = JaxLoader(path, jmap, BATCH, **kw), FrameBatchLoader(path, pmap, BATCH, **kw)
        epochs = []
        for _ in range(2):
            want = [(np.asarray(X, np.float32), y, n) for X, y, n in jl]
            got = [(X.float().numpy(), y, n) for X, y, n in pl]
            _same_batches(got, want)
            epochs.append(np.concatenate([y for _, y, _ in got]))
        assert not np.array_equal(*epochs)  # a fresh permutation each epoch
        return
    got = _port_batches(path, pmap, **kw)
    _same_batches(got, _jax_batches(path, jmap, **kw))
    if "bf16" in case:
        from timed_design_tpu_torch.io import FrameBatchLoader

        X, _, _ = next(iter(FrameBatchLoader(path, pmap, BATCH)))
        assert X.dtype == torch.bfloat16


def test_flat_memmap_serves_full_batches_without_a_copy(jax_flat):
    """A contiguous flat file's full in-order batches are views of one
    memory map of the file, each right after the one before; the padded
    last batch is a copy."""
    from timed_design_tpu_torch.io import FrameBatchLoader

    path = jax_flat["flat_contiguous"]
    _, pmap = _maps(path)
    batches = [X for X, _, _ in FrameBatchLoader(path, pmap, BATCH)]
    ptrs = [X.data_ptr() for X in batches]
    nbytes = batches[0].numel() * batches[0].element_size()
    assert all(b - a == nbytes for a, b in zip(ptrs[:-2], ptrs[1:-1]))
    assert ptrs[-1] - ptrs[-2] != nbytes


@pytest.mark.parametrize("name", ["flat_contiguous", "flat_contiguous_bf16"])
def test_read_flat_frames_equals_jax(jax_flat, name):
    """flat_frame_dtype and read_flat_frames against the JAX package's on
    its flat files: the same logical dtype (bfloat16 for tagged bits) and
    the same values."""
    from timed_design_tpu.io.h5frames import flat_frame_dtype as jax_dtype
    from timed_design_tpu.io.h5frames import read_flat_frames as jax_read

    from timed_design_tpu_torch.io import flat_frame_dtype, hdf5, read_flat_frames

    path = jax_flat[name]
    with h5py.File(path, "r") as h, hdf5.File(path) as p:
        assert str(flat_frame_dtype(p)).split(".")[-1] == str(jax_dtype(h))
        for sel in (np.s_[3:40], np.s_[:]):
            want = np.asarray(jax_read(h, sel), np.float32)
            np.testing.assert_array_equal(read_flat_frames(p, sel).float().numpy(), want)


@pytest.mark.parametrize("name", ["flat_contiguous", "flat_contiguous_bf16"])
def test_flat_batches_equal_h5pys_rows(jax_flat, name):
    """The reads a loader makes of a contiguous flat file, whatever its
    device (a view of the memory map for a full batch of rows in order, a
    sorted gather otherwise), against h5py's rows of the same selection:
    every batch in order and shuffled, the last one's padding rows zero."""
    from timed_design_tpu_torch.io import FrameBatchLoader, hdf5

    path = jax_flat[name]
    _, pmap = _maps(path)
    loader = FrameBatchLoader(path, pmap, BATCH)
    with hdf5.File(path) as f, h5py.File(path, "r") as h:
        frames, labels = h["frames"][()], np.asarray(h["labels"][()], np.float32)
        mm = loader._flat_setup(f)
        assert mm is not None
        for rows in (loader._flat_rows(f), np.random.default_rng(2).permutation(len(pmap.entries))):
            for index in range(loader.n_batches):
                X, y, n = loader._read_batch_flat(f, rows, index, mm, labels)
                sel = rows[index * BATCH:(index + 1) * BATCH]
                got = X.view(torch.int16).numpy() if X.dtype == torch.bfloat16 else X.numpy()
                assert n == len(sel) and (y[:n] == labels[sel]).all() and not y[n:].any()
                np.testing.assert_array_equal(got[:n], frames[sel].view(got.dtype))
                assert not got[n:].any()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_loader_on_the_card_equals_cpu(tmp_path, cuda_device):
    """FrameBatchLoader with a CUDA device (batches through the ring of
    pinned buffers) yields the CPU's batches, tree and flat (float32 and
    bfloat16, in order and shuffled), two epochs of one loader each."""
    from timed_design_tpu_torch.io import FrameBatchLoader, convert_to_flat, create_flat_dataset_map
    from timed_design_tpu_torch.voxel import make_frame_dataset

    tree = make_frame_dataset([UBQ], tmp_path / "t.hdf5", device=cuda_device)
    paths = [tree] + [convert_to_flat(tree, tmp_path / f"{dt}.hdf5", frame_dtype=dt)
                      for dt in ("float32", "bfloat16")]
    for path in paths:
        dmap, _ = create_flat_dataset_map(path)
        for kw in ({}, {"shuffle": True, "shuffle_seed": 4}):
            card = FrameBatchLoader(path, dmap, 24, device=cuda_device, prefetch=1, **kw)
            cpu = FrameBatchLoader(path, dmap, 24, **kw)
            for _ in range(2):
                for (Xc, yc, nc), (Xh, yh, nh) in zip(card, cpu, strict=True):
                    assert Xc.device.type == "cuda" and nc == nh and (yc == yh).all()
                    assert torch.equal(Xc.cpu(), Xh)


@pytest.mark.parametrize("dtype", ["float16", "float64"])
def test_flat_frames_of_other_dtypes_read_as_float32(written, tmp_path, dtype):
    """A flat file whose frames are float16 or float64 (neither float32 nor
    tagged bfloat16): the loader casts them to float32, equal to h5py's
    values. The JAX loader reads such files through a float32 buffer viewed
    as the file's dtype (io/h5frames.py:443, :469), which the port does not
    copy."""
    from timed_design_tpu_torch.io import FrameBatchLoader, create_flat_dataset_map

    src = written["flat"][0]
    path = tmp_path / f"{dtype}.hdf5"
    with h5py.File(src, "r") as fin, h5py.File(path, "w") as fout:
        for k, v in fin.attrs.items():
            fout.attrs[k] = v
        for k in fin:
            data = fin[k][()]
            fout.create_dataset(k, data=data.astype(dtype) if k == "frames" else data)
        want = fout["frames"][()].astype(np.float32)
    pmap, _ = create_flat_dataset_map(path)
    got = np.concatenate([X[:n].numpy() for X, _, n in FrameBatchLoader(path, pmap, BATCH)])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


CONVERTS = ["float32", "bfloat16", "soft_labels"]


@pytest.mark.parametrize("case", CONVERTS)
def test_convert_to_flat_equals_jax(written, tmp_path, case):
    """The port's convert_to_flat of the JAX package's tree file against the
    JAX package's: every attribute, dataset and value equal (bfloat16 bits
    included); with one soft ``encoded_residue`` the labels are float32 in
    both, and the port's loader yields them."""
    import shutil

    from timed_design_tpu.io.h5frames import convert_to_flat as jax_convert

    from timed_design_tpu_torch.io import FrameBatchLoader, convert_to_flat, create_flat_dataset_map

    src = written["tree"][0]
    frame_dtype = "bfloat16" if case == "bfloat16" else "float32"
    if case == "soft_labels":
        shutil.copy(src, tmp_path / "soft.hdf5")
        src = tmp_path / "soft.hdf5"
        with h5py.File(src, "r+") as f:
            f["1ubq/A/1"].attrs["encoded_residue"] = np.full(20, 0.05, np.float32)
    want = jax_convert(src, tmp_path / "jax.hdf5", frame_dtype=frame_dtype)
    got = convert_to_flat(src, tmp_path / "port.hdf5", frame_dtype=frame_dtype)
    with h5py.File(want, "r") as w, h5py.File(got, "r") as g:
        _same_file(w, g, frames_tol=False)
        if case == "soft_labels":
            assert g["labels"].dtype == np.float32
            np.testing.assert_array_equal(g["labels"][0], np.full(20, 0.05, np.float32))
    pmap, _ = create_flat_dataset_map(got)
    y = np.concatenate([y[:n] for _, y, n in FrameBatchLoader(got, pmap, BATCH)])
    with h5py.File(got, "r") as g:
        np.testing.assert_array_equal(y, g["labels"][()].astype(np.float32))


def test_td_voxelize_and_convert_cli_equal_jax(tmp_path, pdbs):
    """``td-voxelize`` (tree, every NMR state) then ``td-convert-dataset
    --frame-dtype bfloat16``: the port's CLIs (--device cpu) against the JAX
    package's on the same arguments."""
    from timed_design_tpu.cli.convert_dataset import main as jax_convert
    from timed_design_tpu.cli.voxelize import main as jax_voxelize

    from timed_design_tpu_torch.cli.convert_dataset import main as convert
    from timed_design_tpu_torch.cli.voxelize import main as voxelize

    for sub in ("in", "jax", "port"):
        (tmp_path / sub).mkdir()
    for p in pdbs:
        (tmp_path / "in" / p.name).write_bytes(p.read_bytes())
    args = [str(tmp_path / "in"), "-e", ".pdb*", "-n", "v", "--voxelise_all_states"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_voxelize(args + ["-o", str(tmp_path / "jax")])
        voxelize(args + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    for d in ("jax", "port"):
        (jax_convert if d == "jax" else convert)(
            [str(tmp_path / d / "v.hdf5"), "--frame-dtype", "bfloat16"])
    for name in ("v.hdf5", "v_flat.hdf5"):
        with h5py.File(tmp_path / "jax" / name, "r") as w, \
                h5py.File(tmp_path / "port" / name, "r") as g:
            _same_file(w, g, frames_tol=True)
            assert len(g["2nmr_0"] if name == "v.hdf5" else g["frames"]) in (1, 3 * 76)


def test_loader_errors_reach_the_consumer(written):
    """A map entry the flat file lacks raises in the consumer, not in a
    thread that dies quietly; an abandoned iterator stops its thread;
    shuffle with start_batch is refused."""
    from timed_design_tpu_torch.io import DatasetMap, FrameBatchLoader

    path = written["flat"][1]
    with pytest.raises(KeyError):
        list(FrameBatchLoader(path, DatasetMap(entries=[("9zzz", "A", "1", "ALA")]), BATCH))
    _, pmap = _maps(path)
    before = threading.active_count()
    for _ in FrameBatchLoader(path, pmap, 8, prefetch=0):
        break
    assert threading.active_count() == before
    with pytest.raises(ValueError, match="start_batch"):
        FrameBatchLoader(path, pmap, BATCH, start_batch=1, shuffle=True)


@pytest.mark.parametrize("cli", ["voxelize", "train"])
def test_new_entry_points_need_a_card_unless_told_cpu(cli, tmp_path):
    """td-voxelize and td-train default to --device cuda, and without a
    card exit with a message naming --device cpu."""
    import importlib

    mod = importlib.import_module(f"timed_design_tpu_torch.cli.{cli}")
    argv = ([str(UBQ)] if cli == "voxelize" else ["--path_to_dataset", str(tmp_path / "x.hdf5")])
    assert mod.build_parser().parse_args(argv).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            mod.main(argv)


_HYGIENE = """
import sys
for name in ("timed_design_tpu", "jax", "flax", "h5py", "ml_dtypes", "matplotlib"):
    sys.modules[name] = None  # any import of these now raises ImportError
from pathlib import Path
from timed_design_tpu_torch.cli import convert_dataset, predict, train, voxelize
out = Path(sys.argv[2])
voxelize.main([sys.argv[1], "-n", "v", "-o", str(out), "--device", "cpu"])
convert_dataset.main([str(out / "v.hdf5"), "--frame-dtype", "bfloat16"])
train.main(["--path_to_dataset", str(out / "v.hdf5"), "--filters", "4,8", "--batch_size", "32",
            "--epochs", "1", "--output", str(out / "t.npz"), "--device", "cpu"])
for name in ("v.hdf5", "v_flat.hdf5"):
    predict.main(["--path_to_dataset", str(out / name), "--path_to_model", f"TIMED@{out}/t.npz",
                  "--path_to_output", str(out / name[:-5]), "--batch_size", "32",
                  "--path_to_datasetmap", str(out / name[:-5] / "map.txt"), "--device", "cpu"])
print("hygiene ok")
"""


def test_hdf5_flow_imports_no_jax(tmp_path):
    """td-voxelize -> td-convert-dataset -> td-train -> td-predict on the
    tree and the bfloat16 flat file, with the JAX package, jax, flax, h5py,
    ml_dtypes and matplotlib unimportable, as on the card's machine."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _HYGIENE, str(UBQ), str(tmp_path)],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "hygiene ok" in proc.stdout and "Saved checkpoint" in proc.stdout
    fastas = [(tmp_path / d / "TIMED.fasta").read_text() for d in ("v", "v_flat")]
    assert fastas[0].startswith(">1ubqA\n") and len(fastas[0].split()[1]) == 76
