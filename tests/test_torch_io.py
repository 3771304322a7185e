"""PyTorch port, io: the port's HDF5-free copies of the datasetmap reader,
the prediction decoder and the sampling path's writers, held to the JAX
package's on the same inputs.

Parsed maps and decoded sequences compare exactly, probabilities bit for
bit (both slice the same numpy matrix); written files compare byte for byte.
"""
import numpy as np
import pytest

PDBS = [("1abc", "A", 5), ("1abc", "B", 3), ("2xyz_0", "A", 4), ("2xyz_1", "A", 4),
        ("long_name", "C", 2)]
LABELS = ["ALA", "GLY", "LYS", "TRP", "HIS", "MSE"]  # MSE: unknown, decodes to X


def _write_old_map(path):
    rows = []
    for pdb, chain, n in PDBS:
        rows += [f"{pdb},{chain},{i + 1},{LABELS[i % len(LABELS)]}" for i in range(n)]
    path.write_text("\n".join(rows) + "\n\n")
    return path


def _write_new_map(path):
    from timed_design_tpu.io.datasetmap import SRB_HEADER

    path.write_text(SRB_HEADER + "".join(f"{p}{c} {n}\n" for p, c, n in PDBS))
    return path


def _matrix(n_classes, seed=0):
    n = sum(k for *_, k in PDBS)
    p = np.random.default_rng(seed).random((n, n_classes))
    return p / p.sum(1, keepdims=True)


@pytest.mark.parametrize("fmt", ["old", "new"])
def test_load_datasetmap_equals_jax(tmp_path, fmt):
    from timed_design_tpu.io import load_datasetmap as jax_load

    from timed_design_tpu_torch.io import load_datasetmap

    path = (_write_old_map if fmt == "old" else _write_new_map)(tmp_path / "map.txt")
    got, want = load_datasetmap(path, is_old=fmt == "old"), jax_load(path, is_old=fmt == "old")
    assert got.is_old == want.is_old == (fmt == "old")
    assert got.entries == want.entries and got.counts == want.counts
    with pytest.raises(ValueError, match=".txt"):
        load_datasetmap(tmp_path / "map.csv")


@pytest.mark.parametrize("fmt", ["old", "new"])
@pytest.mark.parametrize("n_classes", [20, 338])
def test_extract_sequences_equals_jax(tmp_path, fmt, n_classes):
    from timed_design_tpu.constants import ROTAMER_CATEGORIES as JAX_CATEGORIES
    from timed_design_tpu.io import extract_sequences as jax_extract
    from timed_design_tpu.io import load_datasetmap as jax_load

    from timed_design_tpu_torch.constants import ROTAMER_CATEGORIES
    from timed_design_tpu_torch.io import extract_sequences, load_datasetmap

    path = (_write_old_map if fmt == "old" else _write_new_map)(tmp_path / "map.txt")
    P = _matrix(n_classes)
    rotamer = n_classes == 338
    got = extract_sequences(load_datasetmap(path, is_old=fmt == "old"), P,
                            rotamer_categories=ROTAMER_CATEGORIES if rotamer else None)
    want = jax_extract(jax_load(path, is_old=fmt == "old"), P,
                       rotamer_categories=JAX_CATEGORIES if rotamer else None)
    assert got.pdb_to_sequence == want.pdb_to_sequence
    assert got.pdb_to_real_sequence == want.pdb_to_real_sequence
    assert list(got.pdb_to_probability) == list(want.pdb_to_probability)
    for k, v in want.pdb_to_probability.items():
        np.testing.assert_array_equal(got.pdb_to_probability[k], v)
    if fmt == "old":
        assert got.pdb_to_real_sequence["1abcA"] == "AGKWH"
        assert got.pdb_to_real_sequence["2xyz_0A"] == "AGKW"


def _sampled():
    rng = np.random.default_rng(3)
    return {pdb: [("".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), 7)),
                   *map(float, rng.normal(size=4).astype(np.float32))) for _ in range(3)]
            for pdb in ("1ubqA", "4abcB", "x_0A")}


@pytest.mark.parametrize("mode", ["all", "json", "fasta"])
def test_save_sampled_byte_equal(tmp_path, monkeypatch, mode):
    from timed_design_tpu.io import save_sampled as jax_save

    from timed_design_tpu_torch.io import save_sampled

    data = _sampled()
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    want = jax_save(data, filename="run_temp_0.5_n_3_1ubqA", mode=mode)
    monkeypatch.chdir(tmp_path / "port")
    got = save_sampled(data, filename="run_temp_0.5_n_3_1ubqA", mode=mode)
    assert got == want
    for name in want:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_fasta_csv_and_datasetmap_writers_byte_equal(tmp_path):
    from timed_design_tpu.io import DatasetMap as JaxMap
    from timed_design_tpu.io import load_prediction_matrix as jax_load_matrix
    from timed_design_tpu.io import save_datasetmap as jax_save_map
    from timed_design_tpu.io import save_dict_to_fasta as jax_fasta
    from timed_design_tpu.io import save_prediction_csv as jax_csv

    from timed_design_tpu_torch.io import (
        DatasetMap,
        load_prediction_matrix,
        save_datasetmap,
        save_dict_to_fasta,
        save_prediction_csv,
    )

    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    seqs = {"1ubqA": "MQIFVKTLTG", "2xyzB": "ACDW"}
    assert jax_fasta(seqs, "TIMED", a).read_bytes() == save_dict_to_fasta(seqs, "TIMED", b).read_bytes()
    for rotamer, C in ((False, 20), (True, 338)):
        for block in (_matrix(C, 1)[:9], _matrix(C, 2)[:5]):  # two appended blocks
            jax_csv(block.astype(np.float32), "TIMED", a, rotamer=rotamer)
            save_prediction_csv(block.astype(np.float32), "TIMED", b, rotamer=rotamer)
        name = "TIMED_rot.csv" if rotamer else "TIMED.csv"
        assert (a / name).read_bytes() == (b / name).read_bytes()
        np.testing.assert_array_equal(load_prediction_matrix(b / name),
                                      jax_load_matrix(a / name))
        assert load_prediction_matrix(b / name).shape == (14, C)
    entries = [(p, c, str(i + 1), LABELS[i % 6]) for p, c, n in PDBS for i in range(n)]
    jax_save_map(JaxMap(entries=entries), a / "datasetmap.txt")
    save_datasetmap(DatasetMap(entries=entries), b / "datasetmap.txt")
    assert (a / "datasetmap.txt").read_bytes() == (b / "datasetmap.txt").read_bytes()
    with pytest.raises(ValueError, match="per-residue"):
        save_datasetmap(DatasetMap(counts=[("1abcA", 3)]), b / "x.txt")


# ------------------------------------------------- the native %.18e writer

_PROBE = [0.0, 1.0, 1 / 3, 0.1, 6e-8, 65504.0, 5.96e-8, float(np.float32(0.7)), 1e-38, 3.4e38]


def _e18_rows(case):
    rng = np.random.default_rng(13)
    if case == "probe_values":
        return np.array([_PROBE, _PROBE[::-1]], np.float64), True
    if case == "float32_rows":
        p = rng.random((301, 338)).astype(np.float32) ** 3
        return (p / p.sum(1, keepdims=True)).astype(np.float64), True
    if case == "subnormals":  # the savetxt path: three-digit exponents
        p = rng.random((7, 20))
        p[3, 4] = 5e-324
        p[5, 0] = 1e-310
        return p, False
    if case == "negative":
        return rng.random((5, 20)) - 0.5, False
    if case == "non_finite":
        p = rng.random((4, 20))
        p[1, 1] = np.inf
        return p, False
    raise KeyError(case)


@pytest.fixture(scope="module")
def jax_e18(tmp_path_factory):
    """The JAX package's native writer, its library built into a directory
    of this module's own: its loader builds in place in native/, where test
    workers running at once would race."""
    import timed_design_tpu.io.fast_fmt as jax_ff

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ff, "_LIB", tmp_path_factory.mktemp("jax_fmt_csv") / "libfmt_csv.so")
        mp.setattr(jax_ff, "_lib", None)
        mp.setattr(jax_ff, "_tried", False)
        assert jax_ff.native_available()
        yield jax_ff.write_e18_csv


@pytest.mark.parametrize("case", ["probe_values", "float32_rows", "subnormals", "negative",
                                  "non_finite"])
def test_native_e18_writer_byte_equal(tmp_path, case, jax_e18):
    """``write_e18_csv`` writes np.savetxt's bytes and the JAX package's
    native formatter's, and counts the call, where every cell fits its
    fixed width; elsewhere it writes nothing and ``write_prediction_rows``
    falls back to np.savetxt, the same bytes again."""
    import io

    from timed_design_tpu_torch.io import write_prediction_rows
    from timed_design_tpu_torch.io.fast_fmt import native_available, write_e18_csv

    rows, native = _e18_rows(case)
    want = io.BytesIO()
    np.savetxt(want, rows, delimiter=",")
    assert native_available()
    before = write_e18_csv.calls
    got = io.BytesIO()
    assert write_e18_csv(got, rows) is native
    assert write_e18_csv.calls == before + native
    assert got.getvalue() == (want.getvalue() if native else b"")
    jax = io.BytesIO()
    assert jax_e18(jax, rows) is native
    assert jax.getvalue() == got.getvalue()
    full = io.BytesIO()
    write_prediction_rows(full, rows, float16=False)
    assert full.getvalue() == want.getvalue()
    assert write_e18_csv.calls == before + 2 * native


def test_native_e18_writer_builds_into_the_port_and_probes(monkeypatch):
    """The library is built from the port's csrc/fmt_csv.cpp into its own
    _build/, under a hash of the source; a library whose printf misformats
    the probe row is refused (the writers then use np.savetxt)."""
    from pathlib import Path

    import timed_design_tpu_torch.io.fast_fmt as ff

    pkg = Path(ff.__file__).resolve().parents[1]
    assert ff._SRC == pkg / "csrc" / "fmt_csv.cpp"
    lib = ff.build_host_library(ff._SRC)
    assert lib.parent == pkg / "_build" and lib.name.startswith("libfmt_csv-")
    monkeypatch.setattr(ff, "_lib", None)
    monkeypatch.setattr(ff, "_tried", False)
    monkeypatch.setattr(ff, "_format", lambda lib, a: b"0")
    assert not ff.native_available()
