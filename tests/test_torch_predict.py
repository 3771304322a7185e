"""PyTorch port, ``td-predict --voxelize``: the port's CLI and engine against
the JAX package's on the same PDB files and checkpoints (written by the JAX
trainer's ``save_checkpoint``), and its writers, decode, datasetmap order and
frames against the JAX package's on the same inputs.

Tolerances, float32 on both sides:
  - files that carry no probability (``datasetmap.txt``,
    ``encoded_labels.csv``, ``dataset.fasta``, the SRB maps, the consensus
    ``.txt``) and the writers fed the same arrays: byte-equal;
  - probability CSVs: the same shape, values within 1e-5 (convolutions and
    the voxelizer sum in another order). A float16 CSV holds each value
    rounded to float16, and 1e-5 apart can round one float16 step apart, so
    there the bound is 1e-5 plus the float16 spacing at the value;
  - argmax outputs (fasta, the rotamer one-hot CSV): equal at every residue
    where the JAX matrix's top-two margin exceeds 1e-4; such near-ties are
    under 1% of residues;
  - frames: 1e-5.
"""
import gzip
import os
import shutil
import subprocess
import sys
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
BATCH = 32
ATOL = 1e-5
MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several workers per host
    yield
    torch.set_num_threads(n)


def _save(path, variables, build_kwargs=None, head=None, scale=8.0):
    """save_checkpoint of ``variables``, ``head``'s kernel scaled by
    ``scale``. The 20-class models get that: their float16 rows, near
    uniform at random weights, would tie often; peaked rows keep argmax
    near-ties rare."""
    import jax

    from timed_design_tpu.train.train import save_checkpoint

    params = jax.tree.map(np.asarray, variables["params"])
    if head is not None:
        params[head]["kernel"] = params[head]["kernel"] * scale
    save_checkpoint(types.SimpleNamespace(params=params,
                                          batch_stats=variables.get("batch_stats", {})),
                    path, build_kwargs=build_kwargs)
    return path


def _timed_checkpoint(path, n_classes, seed, filters=(4, 8)):
    import jax

    from timed_design_tpu.models import timed

    v = timed(n_classes=n_classes, filters=filters).init(
        jax.random.key(seed), np.zeros((1, 21, 21, 21, 5), np.float32))
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
        v["batch_stats"])
    return _save(path, {"params": v["params"], "batch_stats": stats}, {"filters": filters},
                 head="Conv_0" if n_classes == 20 else None)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    import jax

    from timed_design_tpu.models import prodconn

    d = tmp_path_factory.mktemp("torch_predict_ckpts")
    v = prodconn().init(jax.random.key(4), np.zeros((1, 21, 21, 21, 5), np.float32))
    return {
        "TIMED": f"TIMED@{_timed_checkpoint(d / 'timed.npz', 20, 0)}",
        "ProDCoNN": f"ProDCoNN@{_save(d / 'prodconn.npz', v, head='Dense_1', scale=64.0)}",
        "TIMED_rotamer": f"TIMED_rotamer@{_timed_checkpoint(d / 'rot.npz', 338, 1)}",
        "TIMED_rotamer_balanced":
            f"TIMED_rotamer_balanced@{_timed_checkpoint(d / 'bal.npz', 338, 2)}",
    }


def _ubq_atoms(ubq_pdb_gz) -> list[str]:
    text = gzip.decompress(ubq_pdb_gz.read_bytes()).decode()
    return [l for l in text.splitlines() if l.startswith("ATOM")]


def _residues(atoms, first, last):
    return [l for l in atoms if first <= int(l[22:26]) <= last]


def _shift_x(line, dx):
    return f"{line[:30]}{float(line[30:38]) + dx:8.3f}{line[38:]}"


def _nmr_text(atoms, n_states=11, seed=0):
    """``n_states`` states of residues 1-10, each atom moved by seeded noise."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_states):
        out.append(f"MODEL     {k + 1:4d}")
        for l in _residues(atoms, 1, 10):
            x, y, z = (float(l[30:38]), float(l[38:46]), float(l[46:54])) + rng.normal(0, 0.3, 3)
            out.append(f"{l[:30]}{x:8.3f}{y:8.3f}{z:8.3f}{l[54:]}")
        out.append("ENDMDL")
    return "\n".join(out + ["END"]) + "\n"


@pytest.fixture(scope="module")
def structures(tmp_path_factory, ubq_pdb_gz):
    """The fixture directory:
      - ``1ubq.pdb1.gz``;
      - ``a/zz2b.pdb``: 1ubq residues 1-20 as chain B, then as chain A
        (shifted 40 A), so the file holds chain B first;
      - ``b/Ains.pdb``: 1ubq residues 1-12 with residue 10 renumbered 2A
        (an insertion code, sorted between 2 and 3);
      - ``c/nmrx.pdb``: 11 states of residues 1-10 (``nmrx_10`` sorts
        before ``nmrx_2``).
    Glob order (1ubq, zz2b, Ains, nmrx) differs from the names' byte order
    (1ubq, Ains, nmrx, zz2b)."""
    d = tmp_path_factory.mktemp("torch_predict_pdbs")
    atoms = _ubq_atoms(ubq_pdb_gz)
    shutil.copy(ubq_pdb_gz, d / "1ubq.pdb1.gz")
    for sub in "abc":
        (d / sub).mkdir()
    first20 = _residues(atoms, 1, 20)
    two_chain = ([f"{l[:21]}B{l[22:]}" for l in first20] + ["TER"]
                 + [_shift_x(f"{l[:21]}A{l[22:]}", 40.0) for l in first20])
    (d / "a" / "zz2b.pdb").write_text("\n".join(two_chain + ["END"]) + "\n")
    ins = [f"{l[:22]}   2A{l[27:]}" if int(l[22:26]) == 10 else l
           for l in _residues(atoms, 1, 12)]
    (d / "b" / "Ains.pdb").write_text("\n".join(ins + ["END"]) + "\n")
    (d / "c" / "nmrx.pdb").write_text(_nmr_text(atoms))
    return d


def _pdbs(d):
    return sorted(Path(d).glob("**/*.pdb*"))


@pytest.fixture(scope="module")
def jax_hdf5(tmp_path_factory, structures):
    """The JAX package's dataset.hdf5 of the fixture directory, with the
    first state only and with every NMR state."""
    from timed_design_tpu.voxel import make_frame_dataset

    d = tmp_path_factory.mktemp("torch_predict_h5")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return {all_states: make_frame_dataset(_pdbs(structures), d / f"d{int(all_states)}.hdf5",
                                               voxelise_all_states=all_states)
                for all_states in (False, True)}


# ---------------------------------------------------------------- writers

def _probs(n, c, seed=0):
    p = np.random.default_rng(seed).random((n, c)).astype(np.float32) ** 4
    return p / p.sum(1, keepdims=True)


def _write_case(mod, case, out: Path):
    """One writer of module ``mod`` (the JAX package's io.writers or the
    port's) on fixed arrays, into ``out``."""
    p20, p338 = _probs(37, 20), _probs(23, 338, 1)
    if case == "float16_csv_small_chunks":
        with open(out / "x.csv", "wb") as f:
            assert mod.write_float16_csv(f, p20, rows_per_chunk=5)
    elif case == "float16_csv_negative_falls_back":
        neg = p20 - 0.01
        with open(out / "x.csv", "wb") as f:
            assert not mod.write_float16_csv(f, neg)
            mod.write_prediction_rows(f, neg, float16=True)
    elif case == "prediction_rows_float16":
        with open(out / "x.csv", "wb") as f:
            mod.write_prediction_rows(f, p338, float16=True)
            mod.write_prediction_rows(f, p20[:3], float16=True)
    elif case == "prediction_rows_full":
        with open(out / "x.csv", "wb") as f:
            mod.write_prediction_rows(f, p338, float16=False)
    elif case == "int_csv":
        y = np.eye(20, dtype=np.int64)[np.random.default_rng(2).integers(0, 20, 41)]
        with open(out / "x.csv", "wb") as f:
            assert mod.write_int_csv(f, y)
            assert not mod.write_int_csv(f, y * 10)
    elif case == "encoded_labels":
        y = np.eye(20, dtype=np.int64)[np.random.default_rng(3).integers(0, 20, 17)]
        mod.save_encoded_labels(y, out, append=False)
        mod.save_encoded_labels(y[:4], out, append=True)
    elif case == "consensus_probs":
        cons = {"1abc": _probs(7, 20, 4).astype(np.float16), "2xyzA": _probs(3, 20, 5)}
        mod.save_consensus_probs(cons, "M", out)
    elif case == "srb_datasetmap":
        entries = [("nmrx_0", "A", str(i), "ALA") for i in range(3)]
        entries += [("nmrx_1", "A", str(i), "ALA") for i in range(3)]
        entries += [("nmrx_10", "A", str(i), "GLY") for i in range(3)]
        entries += [("abcde", "A", "1", "ALA"), ("1ubq", "B", "1", "MET"), ("1ubq", "A", "2", "GLN")]
        mod.save_srb_datasetmap(mod.DatasetMap(entries=entries), "M", out)


WRITER_CASES = ["float16_csv_small_chunks", "float16_csv_negative_falls_back",
                "prediction_rows_float16", "prediction_rows_full", "int_csv",
                "encoded_labels", "consensus_probs", "srb_datasetmap"]


@pytest.mark.parametrize("case", WRITER_CASES)
def test_writers_byte_equal_jax(tmp_path, case):
    import timed_design_tpu.io.writers as jax_writers

    import timed_design_tpu_torch.io.writers as writers
    from timed_design_tpu_torch.io import DatasetMap, save_srb_datasetmap

    port = types.SimpleNamespace(**{k: getattr(writers, k) for k in dir(writers)},
                                 DatasetMap=DatasetMap, save_srb_datasetmap=save_srb_datasetmap)
    for name, mod in (("jax", jax_writers), ("port", port)):
        (tmp_path / name).mkdir()
        _write_case(mod, case, tmp_path / name)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files and files == sorted(p.name for p in (tmp_path / "port").iterdir())
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


# ----------------------------------------------------------------- decode

def test_consensus_decode_equals_jax():
    from timed_design_tpu.io import DatasetMap as JaxMap
    from timed_design_tpu.io.decode import extract_sequences as jax_extract

    from timed_design_tpu_torch.constants import ROTAMER_CATEGORIES
    from timed_design_tpu_torch.io import DatasetMap, extract_sequences

    labels = ["ALA", "GLY", "MET", "LYS", "TRP"]
    entries = []
    for state in (0, 1, 10, 2):  # the map's order, as HDF5 lists the states
        for chain in "AB":
            entries += [(f"nmr1_{state}", chain, str(i), labels[i]) for i in range(5)]
    entries += [("1abc", "A", str(i), "ALA") for i in range(3)]
    for C, cats in ((20, None), (338, ROTAMER_CATEGORIES)):
        P = _probs(len(entries), C, C).astype(np.float16)
        want = jax_extract(JaxMap(entries=entries), P, cats, is_consensus=True)
        got = extract_sequences(DatasetMap(entries=entries), P, cats, is_consensus=True)
        assert got.pdb_to_consensus == want.pdb_to_consensus
        assert list(got.pdb_to_consensus) == ["nmr1A", "nmr1B", "1abcA"]
        for k, v in want.pdb_to_consensus_prob.items():
            assert got.pdb_to_consensus_prob[k].dtype == v.dtype == np.float16
            np.testing.assert_array_equal(got.pdb_to_consensus_prob[k], v)
        assert got.pdb_to_sequence == want.pdb_to_sequence
        assert len(got.astuple()) == 5
    # multi-chain states 'abcd_0' emit 'abcdA', as does the literal 'abcd' chain A
    clash = [("abcd_0", "A", "1", "ALA"), ("abcd_0", "B", "1", "ALA"), ("abcd", "A", "1", "ALA")]
    P = _probs(3, 20).astype(np.float16)
    for extract, Map in ((jax_extract, JaxMap), (extract_sequences, DatasetMap)):
        with pytest.raises(ValueError, match="consensus key collision"):
            extract(Map(entries=clash), P, is_consensus=True)


# ------------------------------------------------------------------ order

@pytest.mark.parametrize("blacklist", [False, True], ids=["all", "blacklist"])
@pytest.mark.parametrize("all_states", [False, True], ids=["first_state", "nmr_states"])
def test_datasetmap_order_equals_jax(tmp_path, structures, jax_hdf5, all_states, blacklist):
    """The port's map of the frame set equals JAX's create_flat_dataset_map
    of the HDF5 file of the same structures, entry for entry."""
    from timed_design_tpu.io import create_flat_dataset_map as jax_map
    from timed_design_tpu.io import get_pdb_keys_to_filter as jax_keys

    from timed_design_tpu_torch.io import get_pdb_keys_to_filter
    from timed_design_tpu_torch.voxel import create_flat_dataset_map, make_frame_set

    filt = []
    if blacklist:
        (tmp_path / "bl").mkdir()
        (tmp_path / "bl" / "codes.txt").write_text("zz2b\n9xyz\n")
        filt = get_pdb_keys_to_filter(tmp_path / "bl")
        assert filt == jax_keys(tmp_path / "bl") == ["zz2b", "9xyz"]
    with warnings.catch_warnings(record=True) as w_jax:
        warnings.simplefilter("always")
        want, _ = jax_map(jax_hdf5[all_states], filt, remove_blacklist_silently=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fs = make_frame_set(_pdbs(structures), voxelise_all_states=all_states)
    with warnings.catch_warnings(record=True) as w_port:
        warnings.simplefilter("always")
        got = create_flat_dataset_map(fs, filt, remove_blacklist_silently=True)
    assert got.entries == want.entries
    assert [str(w.message) for w in w_port] == [str(w.message) for w in w_jax]
    names = list(dict.fromkeys(e[0] for e in got.entries))
    nmr = [f"nmrx_{k}" for k in (0, 1, 10) + tuple(range(2, 10))] if all_states else ["nmrx"]
    assert names == ["1ubq", "Ains", *nmr] + ([] if blacklist else ["zz2b"])
    ains = [e[2] for e in got.entries if e[0] == "Ains"]
    assert ains[:4] == ["1", "2", "2A", "3"] and len(ains) == 12
    if not blacklist:
        assert [e[1] for e in got.entries if e[0] == "zz2b"] == ["A"] * 20 + ["B"] * 20
    with pytest.raises(ValueError, match="blacklisted"):
        create_flat_dataset_map(fs, ["1ubq"])


def test_align_states_equals_jax(tmp_path, ubq_pdb_gz):
    """The ragged two-state fixture of tests/test_consensus_e2e.py (the N of
    residue 5 deleted from state 2): both packages keep the same 75 keys."""
    from timed_design_tpu.structure import load_pdb as jax_load
    from timed_design_tpu.voxel import Codec as JaxCodec
    from timed_design_tpu.voxel import structure_to_frame_atoms as jax_frame_atoms
    from timed_design_tpu.voxel.dataset import _align_states as jax_align

    from timed_design_tpu_torch.structure import load_pdb
    from timed_design_tpu_torch.voxel import Codec, structure_to_frame_atoms
    from timed_design_tpu_torch.voxel.dataset import _align_states

    atoms = [l for l in gzip.decompress(ubq_pdb_gz.read_bytes()).decode().splitlines()
             if l[:6] in ("ATOM  ", "HETATM")]
    state2 = [l for l in atoms if not (l[12:16].strip() == "N" and int(l[22:26]) == 5)]
    pdb = tmp_path / "ragged.pdb"
    pdb.write_text("MODEL        1\n" + "\n".join(atoms) + "\nENDMDL\n"
                   + "MODEL        2\n" + "\n".join(state2) + "\nENDMDL\n")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_align([jax_frame_atoms(s, JaxCodec.CNOCACB())
                          for s in jax_load(pdb, all_states=True)], "ragged")
        got = _align_states([structure_to_frame_atoms(s, Codec.CNOCACB())
                             for s in load_pdb(pdb, all_states=True)], "ragged")
    for g, w in zip(got, want):
        assert list(zip(g.chain_ids, g.residue_ids)) == list(zip(w.chain_ids, w.residue_ids))
        assert len(g.labels) == 75 and ("A", "5") not in zip(g.chain_ids, g.residue_ids)
        np.testing.assert_array_equal(g.ca, w.ca)
        np.testing.assert_array_equal(g.rot, w.rot)


# ----------------------------------------------------------------- frames

@pytest.mark.parametrize("all_states", [False, True], ids=["first_state", "nmr_states"])
def test_batch_source_frames_equal_jax_hdf5(structures, jax_hdf5, all_states):
    """Batch after batch, in map order, the frames voxelized on the device
    equal the frames the JAX package wrote to dataset.hdf5 (1e-5); y equals
    the encoded_residue one-hots; padding rows are zero. A source from
    start_batch 2 gives the same batches as the tail."""
    import h5py

    from timed_design_tpu_torch.voxel import FrameBatchSource, create_flat_dataset_map, make_frame_set

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fs = make_frame_set(_pdbs(structures), voxelise_all_states=all_states)
    dmap = create_flat_dataset_map(fs)
    batches = list(FrameBatchSource(fs, dmap, BATCH, device="cpu"))
    assert len(batches) == -(-len(dmap.entries) // BATCH)
    with h5py.File(jax_hdf5[all_states], "r") as f:
        for b, (X, y, n) in enumerate(batches):
            assert X.shape == (BATCH, 21, 21, 21, 5) and X.dtype == torch.float32
            for i, (pdb, chain, rid, _) in enumerate(dmap.entries[b * BATCH : b * BATCH + n]):
                node = f[pdb][chain][rid]
                np.testing.assert_allclose(X[i].numpy(), node[()], atol=1e-5, err_msg=str((pdb, chain, rid)))
                np.testing.assert_array_equal(y[i], node.attrs["encoded_residue"])
            assert not X[n:].any() and not y[n:].any()
    tail = list(FrameBatchSource(fs, dmap, BATCH, start_batch=2, device="cpu"))
    assert len(tail) == len(batches) - 2
    for (X, y, n), (X2, y2, n2) in zip(batches[2:], tail):
        assert n == n2 and torch.equal(X, X2) and np.array_equal(y, y2)


def test_voxelize_structure_equals_jax(ubq_pdb_gz):
    from timed_design_tpu.structure import load_pdb as jax_load
    from timed_design_tpu.voxel import Codec as JaxCodec
    from timed_design_tpu.voxel.dataset import voxelize_structure as jax_voxelize

    from timed_design_tpu_torch.structure import load_pdb
    from timed_design_tpu_torch.voxel import Codec, voxelize_structure

    want, wfa = jax_voxelize(jax_load(ubq_pdb_gz), JaxCodec.CNOCACB())
    got, fa = voxelize_structure(load_pdb(ubq_pdb_gz), Codec.CNOCACB(), device="cpu")
    assert fa.residue_ids == wfa.residue_ids and got.shape == want.shape == (76, 21, 21, 21, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_duplicate_structure_names_raise_in_both(tmp_path, ubq_pdb_gz):
    """Two files named alike give one HDF5 group twice the residues: the
    JAX writer refuses, and so does the frame set."""
    from timed_design_tpu.voxel import make_frame_dataset

    from timed_design_tpu_torch.voxel import make_frame_set

    paths = []
    for sub in ("x", "y"):
        (tmp_path / sub).mkdir()
        paths.append(Path(shutil.copy(ubq_pdb_gz, tmp_path / sub / "1ubq.pdb1.gz")))
    with pytest.raises(ValueError):
        make_frame_dataset(paths, tmp_path / "d.hdf5")
    with pytest.raises(ValueError, match="must be unique"):
        make_frame_set(paths)


# ------------------------------------------------------------- end to end

NO_PROBABILITY = ("datasetmap.txt", "encoded_labels.csv", "dataset.fasta")


def _run_jax(argv, out):
    from timed_design_tpu.cli.predict import main as jax_main

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_main(argv + ["--path_to_output", str(out),
                         "--path_to_datasetmap", str(out / "datasetmap.txt")])


def _run_port(argv, out, extra=()):
    from timed_design_tpu_torch.cli.predict import main

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        main(argv + ["--path_to_output", str(out), "--path_to_datasetmap",
                     str(out / "datasetmap.txt"), "--device", "cpu", *extra])


def _csv(path):
    return np.loadtxt(path, delimiter=",", ndmin=2)


def _margin(P):
    top = np.sort(P.astype(np.float16).astype(np.float64), axis=1)
    return top[:, -1] - top[:, -2]


def _fasta(path):
    lines = Path(path).read_text().splitlines()
    return dict(zip(lines[0::2], lines[1::2]))


def _compare_runs(want_dir: Path, got_dir: Path, rotamer: bool):
    """The port's artifacts against the JAX package's (module docstring)."""
    want_files = {p.name for p in want_dir.iterdir()} - {"dataset.hdf5"}
    assert {p.name for p in got_dir.iterdir()} == want_files
    dmap = [l.split(",") for l in (want_dir / "datasetmap.txt").read_text().splitlines()]
    keys = [e[0] + e[1] for e in dmap]
    n_near, n_rows = 0, 0
    for name in sorted(want_files):
        want, got = want_dir / name, got_dir / name
        if name in NO_PROBABILITY or name.endswith(".txt"):
            assert got.read_bytes() == want.read_bytes(), name
            continue
        if name.endswith(".fasta"):
            continue
        W, G = _csv(want), _csv(got)
        assert G.shape == W.shape, name
        if name.endswith("_rot.csv"):
            np.testing.assert_allclose(G, W, atol=ATOL, rtol=0, err_msg=name)
        elif rotamer and not name.endswith("_consensus.csv"):
            # the one-hot of the rotamer argmax: equal where the argmax is clear
            margin = _margin(_csv(want_dir / name.replace(".csv", "_rot.csv")))
            clear = margin > MARGIN
            np.testing.assert_array_equal(G[clear], W[clear], err_msg=name)
        else:
            # float16 values; an average of values already rounded to
            # float16 (the ensemble, the NMR consensus) rounds twice
            steps = 2 if name.startswith("ensemble") or name.endswith("_consensus.csv") else 1
            spacing = np.spacing(W.astype(np.float16)).astype(np.float64)
            assert (np.abs(G - W) <= ATOL + steps * spacing).all(), name
    for name in sorted(f for f in want_files if f.endswith(".fasta") and f != "dataset.fasta"):
        model = name[: -len(".fasta")]
        if model.endswith("_consensus"):
            P = _csv(want_dir / f"{model}.csv")
            txt = (want_dir / f"{model}.txt").read_text().splitlines()[3:]
            seq_keys = [l.split()[0] for l in txt]
            starts = np.cumsum([0] + [int(l.split()[1]) for l in txt])
        else:
            P = _csv(want_dir / (f"{model}_rot.csv" if rotamer else f"{model}.csv"))
            seq_keys = list(dict.fromkeys(keys))
            rows = {k: [i for i, kk in enumerate(keys) if kk == k] for k in seq_keys}
        clear = _margin(P) > MARGIN
        want_seqs, got_seqs = _fasta(want_dir / name), _fasta(got_dir / name)
        assert list(got_seqs) == list(want_seqs) == [f">{k}" for k in seq_keys], name
        for j, k in enumerate(seq_keys):
            idx = (list(range(starts[j], starts[j + 1])) if model.endswith("_consensus")
                   else rows[k])
            w, g = want_seqs[f">{k}"], got_seqs[f">{k}"]
            assert len(g) == len(w) == len(idx), (name, k)
            for pos, row in enumerate(idx):
                if clear[row]:
                    assert g[pos] == w[pos], (name, k, pos)
        n_near += int((~clear).sum())
        n_rows += len(clear)
    assert n_near < 0.01 * n_rows, f"{n_near} near-ties in {n_rows} residues"


E2E = {
    "ensemble_20": (["TIMED", "ProDCoNN"], ["--ensemble"], None),
    "rotamer": (["TIMED_rotamer"], ["--predict_rotamers"], None),
    "nmr_consensus": (["TIMED_rotamer"], ["--predict_rotamers", "--is_structure_nmr"],
                      "c/nmrx.pdb"),
}


@pytest.mark.parametrize("run", list(E2E))
def test_td_predict_matches_jax(tmp_path, structures, ckpts, run):
    """JAX ``td-predict --voxelize`` against the port's, float32, batch 32:
    (a) the fixture directory with TIMED and ProDCoNN and --ensemble; (b)
    with TIMED_rotamer; (c) the 11-state NMR file with --is_structure_nmr."""
    models, flags, path = E2E[run]
    argv = ["--voxelize", "--path_to_dataset", str(structures / (path or "")),
            "--batch_size", str(BATCH), "--path_to_model",
            *[ckpts[m] for m in models], *flags]
    _run_jax(argv, tmp_path / "jax")
    _run_port(argv, tmp_path / "port")
    _compare_runs(tmp_path / "jax", tmp_path / "port", rotamer="--predict_rotamers" in flags)
    if run == "nmr_consensus":
        txt = (tmp_path / "port" / "TIMED_rotamer_consensus.txt").read_text()
        assert txt.endswith("nmrx 10\n")


@pytest.mark.parametrize("mode", ["w8", "int8"])
def test_td_predict_quantize_matches_jax(tmp_path, structures, ckpts, mode):
    """JAX ``td-predict --voxelize --quantize`` against the port's, float32,
    batch 32, TIMED on 1ubq: the last batch is padded with zero frames in
    both, so the activation scales, taken over the whole batch, match."""
    argv = ["--voxelize", "--path_to_dataset", str(structures / "1ubq.pdb1.gz"),
            "--batch_size", str(BATCH), "--path_to_model", ckpts["TIMED"], "--quantize", mode]
    _run_jax(argv, tmp_path / "jax")
    _run_port(argv, tmp_path / "port")
    _compare_runs(tmp_path / "jax", tmp_path / "port", rotamer=False)
    unquantized = tmp_path / "port_unquantized"
    _run_port(argv[:-2], unquantized)
    assert _csv(unquantized / "TIMED.csv").tolist() != _csv(tmp_path / "port" / "TIMED.csv").tolist()


@pytest.mark.parametrize("rotamer", [False, True], ids=["20_class", "rotamer"])
def test_resume_equals_fresh_run(tmp_path, structures, ckpts, rotamer):
    """--start_batch 1 into a directory holding batch 0's rows (the streamed
    CSVs cut to 32 rows, and the map) writes the fresh run's bytes, the
    ensemble and the regenerated one-hot CSV included."""
    models = ["TIMED_rotamer", "TIMED_rotamer_balanced"] if rotamer else ["TIMED", "ProDCoNN"]
    argv = ["--voxelize", "--path_to_dataset", str(structures), "--batch_size", str(BATCH),
            "--ensemble", "--path_to_model", *[ckpts[m] for m in models]]
    argv += ["--predict_rotamers"] if rotamer else []
    fresh, resumed = tmp_path / "fresh", tmp_path / "resumed"
    _run_port(argv, fresh)
    resumed.mkdir()
    streamed = ["encoded_labels.csv"] + [f"{m}{s}" for m in models
                                         for s in ((".csv", "_rot.csv") if rotamer else (".csv",))]
    for name in streamed:
        lines = (fresh / name).read_bytes().splitlines(keepends=True)
        assert len(lines) > BATCH
        (resumed / name).write_bytes(b"".join(lines[:BATCH]))
    shutil.copy(fresh / "datasetmap.txt", resumed / "datasetmap.txt")
    _run_port(argv, resumed, ["--start_batch", "1"])
    files = sorted(p.name for p in fresh.iterdir())
    assert files == sorted(p.name for p in resumed.iterdir())
    assert "ensemble.fasta" in files
    for name in files:
        assert (resumed / name).read_bytes() == (fresh / name).read_bytes(), name


def test_stale_datasetmap_is_regenerated(tmp_path, structures, ckpts):
    """A map naming a residue the inputs lack is regenerated under the
    requested file name; a map of a subset of the inputs is followed."""
    from timed_design_tpu_torch.constants import AA3_TO_AA1
    from timed_design_tpu_torch.io import load_datasetmap

    argv = ["--voxelize", "--path_to_dataset", str(structures / "1ubq.pdb1.gz"),
            "--batch_size", str(BATCH), "--path_to_model", ckpts["TIMED"]]
    out = tmp_path / "out"
    out.mkdir()
    (out / "datasetmap.txt").write_text("9zzz,A,1,ALA\n")
    _run_port(argv, out)
    assert len(load_datasetmap(out / "datasetmap.txt", is_old=True).entries) == 76
    lines = (out / "datasetmap.txt").read_text().splitlines()
    subset = lines[40:] + lines[:5]
    (out / "datasetmap.txt").write_text("\n".join(subset) + "\n")
    _run_port(argv, out)
    assert (out / "datasetmap.txt").read_text().splitlines() == subset
    assert _fasta(out / "dataset.fasta") == {
        ">1ubqA": "".join(AA3_TO_AA1[l.split(",")[3]] for l in subset)}
    assert len(_fasta(out / "TIMED.fasta")[">1ubqA"]) == 41
    assert (out / "encoded_labels.csv").read_text().count("\n") == 41


@pytest.fixture(scope="module")
def jax_flat(tmp_path_factory, jax_hdf5):
    """The JAX package's convert_to_flat of its dataset.hdf5 (first state)."""
    from timed_design_tpu.io.h5frames import convert_to_flat

    return convert_to_flat(jax_hdf5[False], tmp_path_factory.mktemp("torch_predict_flat") / "f.hdf5")


H5_E2E = {
    "tree_ensemble_20": (False, ["TIMED", "ProDCoNN"], ["--ensemble"]),
    "tree_rotamer": (False, ["TIMED_rotamer"], ["--predict_rotamers"]),
    "nmr_consensus": (True, ["TIMED_rotamer"], ["--predict_rotamers", "--is_structure_nmr"]),
    "flat_rotamer": ("flat", ["TIMED_rotamer"], ["--predict_rotamers"]),
}


@pytest.mark.parametrize("run", list(H5_E2E))
def test_td_predict_hdf5_matches_jax(tmp_path, jax_hdf5, jax_flat, ckpts, run):
    """JAX ``td-predict`` on an HDF5 dataset against the port's on the same
    file, float32, batch 32: the JAX package's dataset.hdf5 of the fixture
    directory (tree layout; every NMR state for the consensus) and its flat
    conversion."""
    which, models, flags = H5_E2E[run]
    path = jax_flat if which == "flat" else jax_hdf5[which]
    argv = ["--path_to_dataset", str(path), "--batch_size", str(BATCH), "--path_to_model",
            *[ckpts[m] for m in models], *flags]
    _run_jax(argv, tmp_path / "jax")
    _run_port(argv, tmp_path / "port")
    _compare_runs(tmp_path / "jax", tmp_path / "port", rotamer="--predict_rotamers" in flags)


def test_bf16_flat_file_equals_the_wire_cast(tmp_path, jax_hdf5, ckpts):
    """``--compute_dtype bfloat16`` on the tree file and on its bfloat16 flat
    conversion (frames rounded to bfloat16 once, on the host, as the engine
    rounds float32 frames on the device): every file byte-equal."""
    from timed_design_tpu_torch.io import convert_to_flat

    flat = convert_to_flat(jax_hdf5[False], tmp_path / "bf16.hdf5", frame_dtype="bfloat16")
    for name, path in (("tree", jax_hdf5[False]), ("flat", flat)):
        _run_port(["--path_to_dataset", str(path), "--batch_size", str(BATCH),
                   "--compute_dtype", "bfloat16", "--path_to_model", ckpts["TIMED_rotamer"],
                   "--predict_rotamers"], tmp_path / name)
    files = sorted(p.name for p in (tmp_path / "tree").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "flat").iterdir())
    for name in files:
        assert (tmp_path / "flat" / name).read_bytes() == (tmp_path / "tree" / name).read_bytes()


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_stale_datasetmap_is_regenerated_hdf5(tmp_path, jax_hdf5, jax_flat, ckpts, layout):
    """On an HDF5 dataset the JAX package's check decides: a map naming a
    residue the file lacks is regenerated; a map of a subset of the file's
    rows is followed, its rows read by key."""
    from timed_design_tpu_torch.io import load_datasetmap

    path = jax_flat if layout == "flat" else jax_hdf5[False]
    argv = ["--path_to_dataset", str(path), "--batch_size", str(BATCH),
            "--path_to_model", ckpts["TIMED"]]
    out = tmp_path / "out"
    out.mkdir()
    (out / "datasetmap.txt").write_text("9zzz,A,1,ALA\n")
    _run_port(argv, out)
    full = (out / "datasetmap.txt").read_text().splitlines()
    assert len(load_datasetmap(out / "datasetmap.txt", is_old=True).entries) == 138
    subset = full[40:76] + full[:5]
    (out / "datasetmap.txt").write_text("\n".join(subset) + "\n")
    _run_port(argv, out)
    assert (out / "datasetmap.txt").read_text().splitlines() == subset
    assert (out / "encoded_labels.csv").read_text().count("\n") == 41
    fresh = tmp_path / "fresh"
    _run_port(argv, fresh)
    rows = {l: i for i, l in enumerate(full)}
    want = _csv(fresh / "TIMED.csv")[[rows[l] for l in subset]]
    np.testing.assert_array_equal(_csv(out / "TIMED.csv"), want)


def test_profile_writes_a_trace(tmp_path, structures, ckpts):
    """--profile DIR writes a torch.profiler chrome trace there, and the
    port's spans beside it in the same format."""
    import json

    argv = ["--voxelize", "--path_to_dataset", str(structures / "b" / "Ains.pdb"),
            "--batch_size", str(BATCH), "--path_to_model", ckpts["TIMED"]]
    _run_port(argv, tmp_path / "out", ["--profile", str(tmp_path / "trace")])
    trace = json.loads((tmp_path / "trace" / "td_predict_trace.json").read_text())
    assert any("conv3d" in e.get("name", "") for e in trace["traceEvents"])
    spans = json.loads((tmp_path / "trace" / "td_predict_spans.json").read_text())
    names = {e["name"] for e in spans["traceEvents"] if e["ph"] == "X"}
    assert {"frame_set", "frame_set.parse", "frame_set.frame_atoms", "frame_set.index",
            "td_predict", "predict", "next_batch", "fetch_wait", "write_batch"} <= names
    assert spans["otherData"]["counters"]["voxelize.pairs_real"] > 0
    assert len(_fasta(tmp_path / "out" / "TIMED.fasta")[">AinsA"]) == 12


# flag -> (argv, the message it exits with; None: ported, so it runs)
REFUSALS = {
    "hdf5": ([], None),
    "hdf5_voxelize": (["--path_to_dataset", "x.hdf5", "--voxelize"], "read as it is"),
    "no_voxelize": (["--path_to_dataset", "x.pdb"], "--voxelize is required"),
    "quantize": (["--voxelize", "--quantize", "w8"], None),
    "report": (["--voxelize", "--path_to_dataset", "x.pdb", "--report"], None),
    "output_analysis": (["--voxelize", "--output_analysis"], None),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals(case, tmp_path, structures, ckpts, jax_hdf5):
    """What the port does not take exits with a message; an HDF5 dataset,
    ``--quantize``, ``--report`` and ``--output_analysis``, ported, run (the
    JAX package's dataset.hdf5 of the fixture directory; ``--quantize w8
    --device cpu`` on a small checkpoint; the design report of ``--report``,
    named after the model; the analysis graphs of ``--output_analysis``, one
    set per chain)."""
    from timed_design_tpu_torch.cli.predict import main

    argv, message = REFUSALS[case]
    if message is None:
        dataset = jax_hdf5[False] if case == "hdf5" else structures / "b" / "Ains.pdb"
        argv = argv + ["--path_to_dataset", str(dataset),
                       "--batch_size", str(BATCH), "--path_to_model", ckpts["TIMED"]]
        _run_port(argv, tmp_path)
        assert len(_fasta(tmp_path / "TIMED.fasta")[">AinsA"]) == 12
        graphs = {"AinsA_probabilities_heatmap.png", "AinsA_mean_var.png", "AinsA_logo.png"}
        written = {p.name for p in tmp_path.iterdir()}
        assert (graphs <= written) is (case == "output_analysis")
        report = Path(ckpts["TIMED"].split("@")[1]).stem + "_report.html"
        assert (report in written) is (case == "report")
        return
    with pytest.raises(SystemExit, match=message):
        main(argv + ["--path_to_model", "TIMED", "--device", "cpu"])


def test_needs_a_card_unless_told_cpu(structures, ckpts):
    """Without --device cpu, on a machine with no card, td-predict exits
    non-zero with a message; the default device is cuda."""
    from timed_design_tpu_torch.cli.predict import build_parser, main

    argv = ["--voxelize", "--path_to_dataset", str(structures / "1ubq.pdb1.gz"),
            "--path_to_model", ckpts["TIMED"]]
    assert build_parser().parse_args(argv).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            main(argv)


_HYGIENE = """
import sys
for name in ("timed_design_tpu", "jax", "flax", "h5py", "ml_dtypes", "matplotlib"):
    sys.modules[name] = None  # any import of these now raises ImportError
import runpy
sys.argv = ["predict", "--voxelize", "--device", "cpu", "--batch_size", "32",
            "--path_to_dataset", sys.argv[1], "--path_to_model", sys.argv[2],
            "--path_to_output", sys.argv[3], "--path_to_datasetmap", sys.argv[3] + "/map.txt"]
runpy.run_module("timed_design_tpu_torch.cli.predict", run_name="__main__")
"""


def test_predict_path_imports_no_jax(tmp_path, structures, ckpts):
    """td-predict --voxelize runs with the JAX package, jax, flax, h5py,
    ml_dtypes and matplotlib unimportable, as on a machine without them."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _HYGIENE, str(structures / "1ubq.pdb1.gz"), ckpts["TIMED"],
         str(tmp_path)], capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Predicted 76 residues across 1 chains." in proc.stdout
    assert {"datasetmap", "predict", "decode", "write"} <= {
        l.split(":")[0].strip() for l in proc.stdout.splitlines() if l.startswith("  ")}
    assert not list(tmp_path.glob("*.hdf5"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_load_dataset_and_predict_card_equals_cpu(tmp_path, cuda_device):
    """load_dataset_and_predict on the card and on the CPU, 1ubq, float32, a
    small rotamer TIMED: probabilities within 1e-4, the files without a
    probability byte-equal."""
    import copy

    from timed_design_tpu_torch.engine import load_dataset_and_predict
    from timed_design_tpu_torch.models import timed_rotamer
    from timed_design_tpu_torch.voxel import make_frame_set

    torch.manual_seed(0)
    model = timed_rotamer(filters=(4, 8)).eval()
    # the file's path, not conftest's fixture: on the card the tests run with --noconftest
    fs = make_frame_set([REPO / "tests" / "testing_files" / "1ubq.pdb1.gz"])
    for dev in ("cpu", cuda_device):
        out = tmp_path / str(dev)
        out.mkdir()
        load_dataset_and_predict([copy.deepcopy(model)], fs, batch_size=BATCH,
                                 dataset_map_path=out / "datasetmap.txt", predict_rotamers=True,
                                 path_to_output=out, device=dev)
    cpu, gpu = tmp_path / "cpu", tmp_path / str(cuda_device)
    np.testing.assert_allclose(_csv(gpu / "model_rot.csv"), _csv(cpu / "model_rot.csv"),
                               atol=1e-4, rtol=0)
    for name in NO_PROBABILITY + ("model.txt",):
        assert (gpu / name).read_bytes() == (cpu / name).read_bytes(), name
