"""PyTorch port, ``io/hdf5.py`` and ``io/fast_inflate.py``: the port's own
HDF5 reader and writer against h5py, the reference.

  - reader: every file of the matrix below, written by h5py, reads equal to
    what h5py reads: the same members in the same order, shapes, dtypes,
    chunks, compression, max shapes, attributes and values, exactly (values
    of the same dtype and type: ``bytes`` for strings in datasets, ``str`` in
    attributes, ``numpy.bool_`` for h5py's bool);
  - refusals: structures outside the subset raise a ``ValueError`` naming
    what the reader met;
  - writer: h5py reads every file the writer writes equal to what was
    written, and so does the port's reader;
  - the inflate and deflate pools: equal to one-shot ``zlib``.
"""
import zlib

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from timed_design_tpu_torch.io import hdf5  # noqa: E402
from timed_design_tpu_torch.io.fast_inflate import deflate_many, inflate_many  # noqa: E402

RNG = np.random.default_rng(20261017)


def _same_value(want, got, where):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, want.dtype)
        if want.dtype == object:
            assert [type(v) for v in got.reshape(-1)] == [type(v) for v in want.reshape(-1)], where
            assert got.tolist() == want.tolist(), where
        else:
            np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def _same_tree(h, p, where="/"):
    """The port's reader ``p`` against h5py's ``h`` on one object, recursively."""
    assert list(p.attrs.keys()) == list(h.attrs.keys()), where
    for k in h.attrs:
        _same_value(h.attrs[k], p.attrs[k], f"{where}@{k}")
    if isinstance(h, h5py.Dataset):
        assert isinstance(p, hdf5.Dataset), where
        assert (p.shape, p.dtype, p.chunks, p.compression, p.maxshape) == (
            h.shape, h.dtype, h.chunks, h.compression, h.maxshape), where
        assert (p.shuffle, p.fletcher32) == (h.shuffle, h.fletcher32), where
        _same_value(h[()], p[()], where)
        return
    assert isinstance(p, hdf5.Group), where
    assert list(p.keys()) == list(h.keys()), where
    for k in h:
        _same_tree(h[k], p[k], f"{where}{k}/")


def _frame(shape=(21, 21, 21, 5)):
    """A sparse float32 frame, like a voxelized backbone."""
    x = np.zeros(shape, np.float32)
    mask = RNG.random(shape) < 0.05
    x[mask] = RNG.random(mask.sum()).astype(np.float32)
    return x


def _compact(f, name, data):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    space = h5py.h5s.create_simple(data.shape)
    ds = h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(data.dtype), space, dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, data)


def _resized(f):
    d = f.create_dataset("grow", shape=(0, 3), maxshape=(None, 3), chunks=(4, 3), dtype=np.float64)
    for i in range(3):
        d.resize(d.shape[0] + 5, axis=0)
        d[-5:] = RNG.random((5, 3))
    s = f.create_dataset("names", shape=(0,), maxshape=(None,), chunks=(4,),
                         dtype=h5py.string_dtype())
    s.resize(6, axis=0)
    s[:] = ["1ubq", "A", "", "ü", "x" * 40, "B"]


DTYPES = {"u8": np.uint8, "i8": np.int8, "i64": np.int64, "f16": np.float16,
          "f32": np.float32, "f64": np.float64, "bool": np.bool_}

# case -> writes its objects into an open h5py file
WRITTEN_BY_H5PY = {
    **{f"contiguous_{k}": (lambda f, dt=dt: f.create_dataset(
        "x", data=(RNG.random((7, 3)) * 100).astype(dt))) for k, dt in DTYPES.items()},
    "compact": lambda f: _compact(f, "c", np.arange(12, dtype=np.int16).reshape(3, 4)),
    "chunked_edges_gzip": lambda f: f.create_dataset(
        "x", data=RNG.random((10, 7, 5)).astype(np.float32), chunks=(4, 3, 5), compression="gzip"),
    "shuffle_fletcher32": lambda f: f.create_dataset(
        "x", data=RNG.random((9, 33)).astype(np.float32), chunks=(4, 8), compression="gzip",
        shuffle=True, fletcher32=True),
    "fletcher32_odd_bytes": lambda f: f.create_dataset(
        "x", data=np.arange(15, dtype=np.uint8), chunks=(7,), fletcher32=True),
    "autochunked_frame": lambda f: f.create_dataset(
        "1ubq/A/1", data=_frame(), compression="gzip"),  # h5py's ~32 chunks a frame
    "many_chunks": lambda f: f.create_dataset(
        "x", data=np.arange(30000, dtype=np.int64).reshape(300, 100), chunks=(7, 9),
        compression="gzip"),
    "resizable": _resized,
    "unwritten_chunks": lambda f: f.create_dataset("x", shape=(10, 4), chunks=(3, 4),
                                                   dtype=np.float32, fillvalue=1.5),
    "strings": lambda f: (f.create_dataset("v", data=["ALA", "", "1ubq_10"],
                                           dtype=h5py.string_dtype()),
                          f.create_dataset("s", data=np.array([b"ab", b"c"], "S2"))),
    "scalars": lambda f: (f.create_dataset("f", data=3.5), f.create_dataset("i", data=np.int8(-3)),
                          f.create_dataset("b", data=True), f.create_dataset("t", data="MET")),
    "attributes": lambda f: _attributes(f.create_dataset("d", data=np.zeros(3)), f),
    "group_of_2000": lambda f: [f.create_dataset(f"g/{i}", data=np.int64(i)) for i in range(2000)],
}


def _attributes(*objs):
    for o in objs:  # more than 10 on each object: continuation blocks
        o.attrs["label"] = "MET"
        o.attrs["labels"] = ["C", "N", "O", "CA", "CB"]
        o.attrs["flag"] = True
        o.attrs["flags"] = np.array([True, False])
        o.attrs["dims"] = (21, 21, 21, 5)
        o.attrs["edge"] = 21.0
        o.attrs["onehot"] = np.eye(20, dtype=np.int64)[3]
        o.attrs["soft"] = np.full(20, 0.05, np.float32)
        o.attrs["half"] = np.float16(0.5)
        o.attrs["u8"] = np.arange(4, dtype=np.uint8)
        o.attrs["fixed"] = np.bytes_(b"abc")
        o.attrs["fixed_array"] = np.array([b"a", b"bc"], "S2")
        o.attrs["empty_string"] = ""


@pytest.mark.parametrize("case", list(WRITTEN_BY_H5PY))
def test_reader_equals_h5py(tmp_path, case):
    path = tmp_path / f"{case}.hdf5"
    with h5py.File(path, "w") as f:
        WRITTEN_BY_H5PY[case](f)
    with h5py.File(path, "r") as h, hdf5.File(path) as p:
        _same_tree(h, p["/"])


def test_reader_reads_a_keras_export(tmp_path):
    """A Keras ``.h5`` that the JAX package's exporter writes (TIMED at
    widths (8, 16)): the next slice's input, read equal to h5py."""
    import jax

    from timed_design_tpu.models import timed
    from timed_design_tpu.models.keras_export import export_timed_to_h5

    v = timed(filters=(8, 16)).init(jax.random.key(0), np.zeros((1, 21, 21, 21, 5), np.float32))
    path = export_timed_to_h5(jax.tree.map(np.asarray, v["params"]),
                              jax.tree.map(np.asarray, v["batch_stats"]), tmp_path / "k.h5")
    with h5py.File(path, "r") as h, hdf5.File(path) as p:
        _same_tree(h, p["/"])
        assert "model_config" in p.attrs


def test_reader_selections_equal_h5py(tmp_path):
    """Slices, single rows, row lists and trailing selections, on a
    contiguous, a chunked-gzip and an unfiltered chunked dataset."""
    path = tmp_path / "sel.hdf5"
    data = RNG.random((23, 6, 4)).astype(np.float32)
    with h5py.File(path, "w") as f:
        f.create_dataset("contiguous", data=data)
        f.create_dataset("gzip", data=data, chunks=(5, 6, 4), compression="gzip")
        f.create_dataset("rows", data=data, chunks=(5, 6, 4))
    sels = [np.s_[3:17], np.s_[:], np.s_[20:], np.s_[4], np.s_[-1], [0, 2, 3, 11, 22],
            np.s_[5:9, 2], np.s_[::3], np.array([1, 7, 8, 9, 21])]
    with h5py.File(path, "r") as h, hdf5.File(path) as p:
        for name in h:
            for sel in sels:
                np.testing.assert_array_equal(p[name][sel], h[name][sel], err_msg=f"{name} {sel}")
        # rows in any order (the flat loader's gather)
        order = np.array([22, 0, 5, 4, 17, 6])
        np.testing.assert_array_equal(p["rows"]._gather(order), data[order])
        np.testing.assert_array_equal(p["gzip"]._gather(order), data[order])


def test_reader_exposes_raw_chunks(tmp_path):
    """What a loader reads itself: each chunk's offset, address, stored size
    and filter mask, h5py's own; decode_chunk undoes the filters; a
    contiguous dataset's data offset is h5py's."""
    path = tmp_path / "raw.hdf5"
    with h5py.File(path, "w") as f:
        f.create_dataset("z", data=RNG.random((9, 33)).astype(np.float32), chunks=(4, 8),
                         compression="gzip", shuffle=True, fletcher32=True)
        f.create_dataset("c", data=np.arange(8.0))
    with h5py.File(path, "r") as h, hdf5.File(path) as p:
        dsid = h["z"].id
        want = [dsid.get_chunk_info(i) for i in range(dsid.get_num_chunks())]
        got = p["z"].chunk_index()
        assert [(c.offset, c.addr, c.size, c.filter_mask) for c in got] == [
            (w.chunk_offset, w.byte_offset, w.size, w.filter_mask) for w in want]
        for c in got:
            chunk = np.frombuffer(p["z"].decode_chunk(p.read_raw(c.addr, c.size)), np.float32)
            o = c.offset
            want_chunk = np.zeros((4, 8), np.float32)
            block = h["z"][o[0]:o[0] + 4, o[1]:o[1] + 8]
            want_chunk[:block.shape[0], :block.shape[1]] = block
            np.testing.assert_array_equal(chunk.reshape(4, 8), want_chunk)
        assert p["c"].data_offset == h["c"].id.get_offset()
        assert p["z"].data_offset is None


REFUSED = {
    "latest": (lambda f: f.create_dataset("x", data=np.arange(3)), {"libver": "latest"},
               "superblock version 3"),
    "track_order": (lambda f: f.create_group("g", track_order=True), {},
                    "version 2 object header"),
    "compound": (lambda f: f.create_dataset("x", data=np.zeros(3, [("a", "i4"), ("b", "f4")])),
                 {}, "compound datatype"),
    "lzf": (lambda f: f.create_dataset("x", data=np.zeros((10, 10)), compression="lzf"), {},
            "lzf filter"),
    "scaleoffset": (lambda f: f.create_dataset("x", data=np.zeros((9, 9), np.int32),
                                               scaleoffset=0), {}, "scaleoffset filter"),
    "soft_link": (lambda f: f.__setitem__("s", h5py.SoftLink("/x")), {}, "soft link"),
    "vlen_sequence": (lambda f: f.create_dataset("x", (2,), dtype=h5py.vlen_dtype(np.int32)),
                      {}, "variable-length sequence"),
    "null_dataspace": (lambda f: f.attrs.__setitem__("a", h5py.Empty("f4")), {},
                       "null dataspace"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_reader_refuses_what_lies_outside_the_subset(tmp_path, case):
    write, kw, message = REFUSED[case]
    path = tmp_path / f"{case}.hdf5"
    with h5py.File(path, "w", **kw) as f:
        write(f)

    def read_all(g):
        g.attrs.items()
        for k in g:
            o = g[k]
            if isinstance(o, hdf5.Group):
                read_all(o)
            else:
                o[()]

    with pytest.raises(ValueError, match=message):
        with hdf5.File(path) as f:
            read_all(f)


def test_reader_refuses_other_files(tmp_path):
    (tmp_path / "x.hdf5").write_bytes(b"not an hdf5 file" * 8)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.File(tmp_path / "x.hdf5")
    with pytest.raises(ValueError, match="reading only"):
        hdf5.File(tmp_path / "x.hdf5", "w")


# case -> (writes into a port Writer, the values h5py must read back {path: value})
def _writer_attrs(w):
    want = {}
    for obj, prefix in ((w, ""), (w.create_dataset("d", data=np.zeros(2)), "d")):
        for k, v, read in (
                ("label", "MET", "MET"),
                ("labels", ["C", "N", "O"], np.array(["C", "N", "O"], object)),
                ("flag", True, np.True_),
                ("flags", np.array([True, False]), np.array([True, False])),
                ("dims", (21, 21, 21, 5), np.array([21, 21, 21, 5])),
                ("edge", 21.0, np.float64(21.0)),
                ("onehot", np.eye(20, dtype=np.int64)[3], np.eye(20, dtype=np.int64)[3]),
                ("soft", np.full(20, 0.05, np.float32), np.full(20, 0.05, np.float32)),
                ("half", np.float16(0.5), np.float16(0.5)),
                ("fixed", np.bytes_(b"abc"), np.bytes_(b"abc")),
                ("empty", "", ""),
                ("unicode", "ü", "ü")):
            obj.attrs[k] = v
            want[f"{prefix}@{k}"] = read
    return want


def _writer_datasets(w):
    data = {
        "f32": RNG.random((5, 4)).astype(np.float32), "f16": RNG.random(6).astype(np.float16),
        "f64": RNG.random(3), "i8": np.arange(-3, 3, dtype=np.int8),
        "u16": np.arange(9, dtype=np.uint16).reshape(3, 3), "i64": np.arange(4),
        "bool": np.array([True, False, True]), "scalar": np.float64(2.5),
    }
    for k, v in data.items():
        w.create_dataset(k, data=v)
    data["strings"] = np.array([b"1ubq", b"", b"A" * 30], object)
    w.create_dataset("strings", data=["1ubq", "", "A" * 30])
    frame = _frame((21, 21, 21, 5))
    w.require_group("1ubq").require_group("A").create_dataset(
        "1", data=frame, chunks=frame.shape, compression="gzip")
    data["1ubq/A/1"] = frame
    big = np.arange(30000, dtype=np.int64).reshape(300, 100)
    w.create_dataset("many_chunks", data=big, chunks=(7, 9), compression="gzip",
                     compression_opts=1)
    data["many_chunks"] = big
    rows = w.create_dataset("rows", shape=(6, 2, 3), dtype=np.float32)
    rows[0] = np.ones((2, 3))
    rows[3:5] = np.full((2, 2, 3), 7.0)
    want_rows = np.zeros((6, 2, 3), np.float32)
    want_rows[0], want_rows[3:5] = 1.0, 7.0
    data["rows"] = want_rows
    return data


def _writer_appendables(w):
    frames = w.create_appendable("frames", (4, 3), np.uint16, 5)
    labels = w.create_appendable("labels", (20,), np.int8, 4096)
    names = w.create_appendable("index_pdb", (), str, 4)
    gz = w.create_appendable("gz", (2,), np.float32, 3, compression="gzip")
    w.create_appendable("never", (3,), np.float32, 8)
    want_f, want_n, want_g = [], [], []
    for i in range(4):
        r = i + 2
        f = RNG.integers(0, 65535, (r, 4, 3)).astype(np.uint16)
        frames.append(f)
        labels.append(np.eye(20, dtype=np.int8)[:r])
        names.append([f"s{i}"] * r)
        g = RNG.random((r, 2)).astype(np.float32)
        gz.append(g)
        want_f.append(f)
        want_n += [f"s{i}".encode()] * r
        want_g.append(g)
    return {"frames": np.concatenate(want_f), "labels": np.concatenate(
        [np.eye(20, dtype=np.int8)[:i + 2] for i in range(4)]),
        "index_pdb": np.array(want_n, object), "gz": np.concatenate(want_g),
        "never": np.zeros((0, 3), np.float32)}


def _writer_group_of_2000(w):
    g = w.create_group("g")
    for i in range(2000):
        g.create_dataset(str(i), data=np.int64(i))
    return {f"g/{i}": np.int64(i) for i in range(2000)}


WRITTEN_BY_PORT = {"attributes": _writer_attrs, "datasets": _writer_datasets,
                   "appendable": _writer_appendables, "group_of_2000": _writer_group_of_2000}


@pytest.mark.parametrize("case", list(WRITTEN_BY_PORT))
def test_writer_read_by_h5py(tmp_path, case):
    path = tmp_path / f"{case}.hdf5"
    with hdf5.Writer(path) as w:
        want = WRITTEN_BY_PORT[case](w)
    with h5py.File(path, "r") as h:
        for key, value in want.items():
            obj, _, attr = key.partition("@")
            node = h[obj] if obj else h
            got = node.attrs[attr] if attr else node[()]
            _same_value(value, got, key)
        if case == "appendable":
            assert h["frames"].maxshape == (None, 4, 3) and h["frames"].chunks == (5, 4, 3)
            assert h["gz"].compression == "gzip" and h["index_pdb"].maxshape == (None,)
        if case == "group_of_2000":
            assert list(h["g"].keys()) == sorted(str(i) for i in range(2000))
        with hdf5.File(path) as p:
            _same_tree(h, p["/"])


def test_writer_refuses_what_it_cannot_write(tmp_path):
    with hdf5.Writer(tmp_path / "x.hdf5") as w:
        with pytest.raises(ValueError, match="gzip only"):
            w.create_dataset("a", data=np.zeros(3), chunks=(3,), compression="lzf")
        with pytest.raises(ValueError, match="needs chunks"):
            w.create_dataset("a", data=np.zeros(3), compression="gzip")
        with pytest.raises(ValueError, match="no HDF5 type"):
            w.create_dataset("a", data=np.zeros(3, np.complex64))
        w.create_dataset("a", data=np.zeros(3))
        with pytest.raises(ValueError, match="already exists"):
            w.create_dataset("a", data=np.zeros(3))
        with pytest.raises(ValueError, match="without '/'"):
            w.create_group("a/b")


def test_fletcher32_sums_match_h5py(tmp_path):
    """The stored checksum of h5py's chunks equals ``fletcher32_sums`` mod
    65535, on even and odd chunk lengths; a flipped byte is refused."""
    path = tmp_path / "f.hdf5"
    with h5py.File(path, "w") as f:
        for n in (1, 2, 7, 360 * 2 + 5, 5000):
            f.create_dataset(f"x{n}", data=RNG.integers(0, 255, n).astype(np.uint8), chunks=(n,),
                             fletcher32=True)
    with hdf5.File(path) as p:
        for name in p:
            c = p[name].chunk_index()[0]
            raw = p.read_raw(c.addr, c.size)
            stored = int.from_bytes(raw[-4:], "little")
            assert hdf5.fletcher32_sums(raw[:-4]) == ((stored & 0xFFFF) % 65535,
                                                      (stored >> 16) % 65535), name
            bad = bytes([raw[0] ^ 1]) + raw[1:]
            with pytest.raises(ValueError, match="Fletcher-32"):
                p[name].decode_chunk(bad)


def test_inflate_many_equals_zlib():
    frames = [_frame((9, 9, 9, 5)) for _ in range(40)]
    srcs = [zlib.compress(f.tobytes(), 4) for f in frames]
    dsts = [np.empty_like(f) for f in frames]
    inflate_many(srcs, dsts)
    for f, d in zip(frames, dsts):
        np.testing.assert_array_equal(d, f)
    assert [zlib.decompress(z) for z in deflate_many([f.tobytes() for f in frames], 4)] == [
        f.tobytes() for f in frames]
    with pytest.raises(ValueError, match="inflate failed"):
        inflate_many([b"junk" + srcs[0]], [np.empty_like(frames[0])])
    with pytest.raises(ValueError, match="not"):
        inflate_many([srcs[0]], [np.empty((3,), np.float32)])
    with pytest.raises(ValueError, match="C-contiguous"):
        inflate_many([srcs[0]], [np.empty((9, 9, 9, 10), np.float32)[..., ::2]])
