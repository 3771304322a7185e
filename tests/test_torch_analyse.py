"""PyTorch port, analysis stack: ``analyse/`` (metrics, rotamer evaluation,
structure analyses, AF2, NetSolP and SCWRL adapters, plots, sweeps),
``structure/geometry.py``, the ``Structure`` methods analysis calls and
``constants/blosum.py``, held to the JAX package's on the same inputs; the
metric passes and the packing count on the card against the CPU.

Tolerances:
  - the metrics' integer passes (top-k, confusion counts, bias, report,
    precision and recall) and every class pair's AUC: exact; the macro AUCs
    are too (their means are taken in numpy in the JAX package's order), and
    are held within the 1e-12 they are specified to;
  - the weighted confusion matrix: exact on the CPU (weights summed in row
    order, as numpy's ``add.at``), 1e-12 relative on the card (atomic order);
  - packing counts: exact; rotamer codes: equal, NaN included;
    superposition, RMSD and GDT: 1e-6;
  - sweeps: model-benchmark metrics 1e-6; sampled files equal where they
    carry no float32 metric, metrics 1e-4.
"""
import functools
import gzip
import http.server
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several workers per host
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# ------------------------------------------------------------------ metrics

# (rows, classes, seed, absent classes): float16-quantized rows, peaked so
# that most of a row rounds to the same few float16 values (heavy ties)
METRIC_CASES = {
    "20_classes": (300, 20, 0, ()),
    "20_absent": (250, 20, 1, (3, 7)),
    "338_rotamers": (900, 338, 2, ()),
    "one_hot_rows": (120, 20, 3, (19,)),
}


def _metric_inputs(case):
    n, c, seed, absent = METRIC_CASES[case]
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n)
    for a in absent:
        y[y == a] = (a + 1) % c
    if case == "one_hot_rows":
        scores = np.eye(c)[rng.integers(0, c, n)]
    else:
        p = rng.random((n, c)) ** 24
        p[np.arange(n), y] += rng.random(n) * 0.3 * p.max(1)
        scores = (p / p.sum(1, keepdims=True)).astype(np.float16).astype(np.float64)
    return y, scores


@pytest.mark.parametrize("case", list(METRIC_CASES))
def test_top_k_accuracy_equals_jax(case):
    """sklearn's tie-break (a stable ascending sort, reversed) on rows that
    tie often: every k exactly, and each row's rank of its true class."""
    import timed_design_tpu.analyse.metrics as J

    import timed_design_tpu_torch.analyse.metrics as T

    y, s = _metric_inputs(case)
    ties = (np.diff(np.sort(s, 1), axis=1) == 0).mean()
    assert ties > 0.3, "the case must tie heavily"
    for k in range(1, 6):
        assert T.top_k_accuracy(y, s, k) == J.top_k_accuracy(y, s, k), k
    order = np.argsort(s, axis=1, kind="stable")[:, ::-1]
    want = np.nonzero(order == y[:, None])[1]
    np.testing.assert_array_equal(T.true_class_rank(y, s).numpy(), want)


@pytest.mark.parametrize("case", list(METRIC_CASES))
def test_counting_metrics_equal_jax(case):
    """accuracy, confusion (every normalization, weighted), precision,
    recall, F1, the report and the bias: equal to the JAX package's."""
    import timed_design_tpu.analyse.metrics as J

    import timed_design_tpu_torch.analyse.metrics as T

    y, s = _metric_inputs(case)
    yp = s.argmax(1)
    c = s.shape[1]
    names = [f"c{i}" for i in range(c)]
    assert T.accuracy(y, yp) == J.accuracy(y, yp)
    for norm in ("all", "true", "pred", None):
        np.testing.assert_array_equal(T.confusion(y, yp, c, norm), J.confusion(y, yp, c, norm))
    w = np.bincount(y, minlength=c) / len(y)
    np.testing.assert_array_equal(T.confusion(y, yp, c, sample_weight=w[y]),
                                  J.confusion(y, yp, c, sample_weight=w[y]))
    for got, want in zip(T.precision_recall_f1(y, yp, c), J.precision_recall_f1(y, yp, c)):
        np.testing.assert_array_equal(got, want)
    assert repr(T.classification_report(y, yp, names)) == repr(J.classification_report(y, yp, names))
    assert T.prediction_bias(y, yp, names) == J.prediction_bias(y, yp, names)
    # tensors give what arrays give
    yt, ypt = torch.from_numpy(y), torch.from_numpy(yp)
    assert T.prediction_bias(yt, ypt, names) == J.prediction_bias(y, yp, names)


@pytest.mark.parametrize("case", list(METRIC_CASES))
def test_pair_aucs_equal_jax(case):
    """Every class pair's binary AUC, from the pair counts, equals the JAX
    package's rank-sum AUC on that pair's rows bit for bit; the macro
    one-vs-one and one-vs-rest AUCs within 1e-12 (NaN with an absent class
    for one-vs-rest)."""
    import timed_design_tpu.analyse.metrics as J

    import timed_design_tpu_torch.analyse.metrics as T

    y, s = _metric_inputs(case)
    twice_u = T.pair_rank_counts(y, s, max_elements=len(y) * 7).numpy()  # several blocks
    np.testing.assert_array_equal(twice_u, T.pair_rank_counts(y, s).numpy())
    n = np.bincount(y, minlength=s.shape[1])
    present = np.nonzero(n)[0]
    rng = np.random.default_rng(0)
    pairs = [(a, b) for a in present for b in present if a != b]
    for i in rng.choice(len(pairs), min(len(pairs), 60), replace=False):
        a, b = pairs[i]
        mask = (y == a) | (y == b)
        want = J._binary_auc(y[mask] == a, s[mask, a])
        assert T._pair_aucs(twice_u, n, a, b) == want, (a, b)
    ovo, ovr = T.roc_auc_ovo_macro(y, s), T.roc_auc_ovr_macro(y, s)
    np.testing.assert_allclose(ovo, J.roc_auc_ovo_macro(y, s), rtol=1e-12, atol=0)
    if METRIC_CASES[case][3]:
        assert np.isnan(ovr) and np.isnan(J.roc_auc_ovr_macro(y, s))
    else:
        np.testing.assert_allclose(ovr, J.roc_auc_ovr_macro(y, s), rtol=1e-12, atol=0)


def test_one_class_gives_nan_aucs():
    import timed_design_tpu.analyse.metrics as J

    import timed_design_tpu_torch.analyse.metrics as T

    y, s = np.zeros(6, int), np.random.default_rng(0).random((6, 4))
    assert np.isnan(T.roc_auc_ovo_macro(y, s)) and np.isnan(J.roc_auc_ovo_macro(y, s))
    assert np.isnan(T.roc_auc_ovr_macro(y, s)) and np.isnan(J.roc_auc_ovr_macro(y, s))


def _sequence_dicts():
    rng = np.random.default_rng(4)
    letters = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    real = {f"p{i}A": "".join(rng.choice(letters, 30 + i)) for i in range(4)}
    real["p1A"] = "X" + real["p1A"][1:]  # a non-standard residue is skipped
    pred = {k: "".join(c if rng.random() < 0.6 else rng.choice(letters) for c in v)
            for k, v in real.items()}
    pred["zzzzA"] = "ACD"  # not in the real map: skipped with a message
    probs = {k: rng.dirichlet(np.ones(20) * 0.3, len(v)).astype(np.float16).astype(np.float64)
             for k, v in pred.items()}
    return pred, real, probs


@pytest.mark.parametrize("with_probabilities", [False, True])
def test_calculate_metrics_equals_jax(with_probabilities):
    from timed_design_tpu.analyse.metrics import calculate_metrics as jax_metrics
    from timed_design_tpu.analyse.metrics import sequences_to_labels as jax_labels

    from timed_design_tpu_torch.analyse.metrics import calculate_metrics, sequences_to_labels

    pred, real, probs = _sequence_dicts()
    for got, want in zip(sequences_to_labels(pred, real), jax_labels(pred, real)):
        np.testing.assert_array_equal(got, want)
    kw = {"pdb_to_probability": probs} if with_probabilities else {}
    got = calculate_metrics(pred, real, device="cpu", **kw)
    want = jax_metrics(pred, real, **kw)
    assert list(got) == list(want)
    for key in want:
        if key == "unweighted_cm":
            np.testing.assert_array_equal(got[key], want[key])
        else:
            assert repr(got[key]) == repr(want[key]), key
    with pytest.raises(ValueError, match="missing an entry"):
        calculate_metrics(pred, real, {"p0A": probs["p0A"]}, device="cpu")


def test_renormalize_float16_rows_equals_jax():
    """Float16 rows that do not sum to 1 get the residual spread, bit for
    bit as the JAX package spreads it; rows that do are left alone."""
    from timed_design_tpu.analyse.rotamer import renormalize_float16_rows as jax_renorm

    from timed_design_tpu_torch.analyse.rotamer import renormalize_float16_rows

    p = np.random.default_rng(5).random((200, 338)) ** 4
    p = (p / p.sum(1, keepdims=True)).astype(np.float16)
    p[:3] = np.float16(0.0)
    p[:3, :2] = np.float16(0.5)  # sums to 1 exactly
    got = renormalize_float16_rows(p)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), jax_renorm(p))
    np.testing.assert_array_equal(got.numpy()[:3], p[:3].astype(np.float64))


def _rotamer_inputs(ubq_pdb_gz):
    """Two chains' float16 rotamer rows against 1ubq's crystal tags: one
    near-right, one noisy, one structure absent from the tags and one
    length-mismatched."""
    from timed_design_tpu_torch.structure import encode_structure_rotamers, load_pdb

    tags = np.array(encode_structure_rotamers(load_pdb(ubq_pdb_gz)))
    rng = np.random.default_rng(6)
    good = rng.random((76, 338)) ** 6
    good[np.arange(76), np.nan_to_num(tags).astype(int)] += 0.5 * good.max(1)
    noisy = rng.random((76, 338)) ** 6
    probs = {k: (p / p.sum(1, keepdims=True)).astype(np.float16)
             for k, p in (("1ubqA", good), ("1ubqB", noisy), ("9zzzA", noisy[:5]),
                          ("1ubqC", noisy[:70]))}
    tags_b = tags.copy()
    tags_b[[4, 9]] = np.nan  # untaggable residues are dropped
    return probs, {"1ubqA": list(tags), "1ubqB": list(tags_b), "1ubqC": list(tags)}


def _results_lines(path):
    """results_*.txt split into its AUC values and the rest of its lines."""
    lines = Path(path).read_text().splitlines()
    aucs = [float(l.split(": ")[1]) for l in lines if l.startswith("Metrics AUC_")]
    return aucs, [l for l in lines if not l.startswith("Metrics AUC_")]


def test_calculate_rotamer_metrics_equals_jax(tmp_path, ubq_pdb_gz):
    """The bundle and ``results_{suffix}.txt``: byte-equal apart from the AUC
    lines, which agree within 1e-12; the weighted confusion matrix exact on
    the CPU."""
    from timed_design_tpu.analyse.rotamer import calculate_rotamer_metrics as jax_rot

    from timed_design_tpu_torch.analyse.rotamer import calculate_rotamer_metrics

    probs, tags = _rotamer_inputs(ubq_pdb_gz)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jax_rot(probs, tags, suffix="wt", output_path=tmp_path / "jax")
    got = calculate_rotamer_metrics(probs, tags, suffix="wt", output_path=tmp_path / "port",
                                    device="cpu")
    assert list(got) == list(want)
    for key in ("unweighted_cm", "weighted_cm"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in set(want) - {"unweighted_cm", "weighted_cm", "auc_ovo", "auc_ovr"}:
        assert repr(got[key]) == repr(want[key]), key
    (a_got, rest_got), (a_want, rest_want) = (_results_lines(tmp_path / d / "results_wt.txt")
                                              for d in ("port", "jax"))
    assert rest_got == rest_want
    np.testing.assert_allclose(a_got, a_want, rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="No structure overlaps"):
        calculate_rotamer_metrics({"9zzzA": probs["9zzzA"]}, tags, device="cpu")


def test_rotamer_metrics_need_a_card_unless_told_cpu(ubq_pdb_gz):
    from timed_design_tpu_torch.analyse import calculate_rotamer_metrics

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    probs, tags = _rotamer_inputs(ubq_pdb_gz)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calculate_rotamer_metrics(probs, tags)


# ------------------------------------------------- structure and constants

def _two_chain_text(ubq_pdb_gz):
    """1ubq residues 1-20 as chain B then as chain A shifted 40 A, and
    residue 5's side chain cut to CB (untaggable)."""
    atoms = [l for l in gzip.decompress(ubq_pdb_gz.read_bytes()).decode().splitlines()
             if l.startswith("ATOM") and int(l[22:26]) <= 20]
    cut = [l for l in atoms
           if not (int(l[22:26]) == 5 and l[12:16].strip() not in ("N", "CA", "C", "O", "CB"))]
    b = [f"{l[:21]}B{l[22:]}" for l in cut]
    a = [f"{l[:21]}A{l[22:30]}{float(l[30:38]) + 40:8.3f}{l[38:]}" for l in cut]
    return "\n".join(b + ["TER"] + a + ["END"]) + "\n"


@pytest.fixture(scope="module")
def two_chain_pdb(tmp_path_factory, ubq_pdb_gz):
    path = tmp_path_factory.mktemp("torch_analyse_pdb") / "2chn.pdb"
    path.write_text(_two_chain_text(ubq_pdb_gz))
    return path


@pytest.fixture(scope="module")
def noisy_pdb(tmp_path_factory, ubq_pdb_gz):
    """Three copies of 1ubq as chains A-C, every atom moved by seeded noise
    of 0.3 A: chi angles off the crystal's, some near the bin edges."""
    rng = np.random.default_rng(14)
    atoms = [l for l in gzip.decompress(ubq_pdb_gz.read_bytes()).decode().splitlines()
             if l.startswith("ATOM")]
    lines = []
    for k, chain in enumerate("ABC"):
        for l in atoms:
            x, y, z = np.array([float(l[30:38]), float(l[38:46]), float(l[46:54])]) + rng.normal(
                0, 0.3, 3)
            lines.append(f"{l[:21]}{chain}{l[22:30]}{x + 60 * k:8.3f}{y:8.3f}{z:8.3f}{l[54:]}")
        lines.append("TER")
    path = tmp_path_factory.mktemp("torch_analyse_noisy") / "3nsy.pdb"
    path.write_text("\n".join(lines + ["END"]) + "\n")
    return path


@pytest.mark.parametrize("which", ["1ubq", "two_chain"])
def test_structure_methods_equal_jax(which, ubq_pdb_gz, two_chain_pdb):
    """``to_pdb`` (the text SCWRL is given), ``sequence1``, ``n_residues``,
    ``select_chain`` and ``residue_labels`` as in the JAX package."""
    from timed_design_tpu.structure import load_pdb as jax_load
    from timed_design_tpu.structure import residue_labels as jax_labels

    from timed_design_tpu_torch.structure import load_pdb, residue_labels

    path = ubq_pdb_gz if which == "1ubq" else two_chain_pdb
    got, want = load_pdb(path), jax_load(path)
    assert got.to_pdb() == want.to_pdb()
    assert got.sequence1() == want.sequence1() and got.n_residues == want.n_residues
    assert [c.sequence1() for c in got.chains] == [c.sequence1() for c in want.chains]
    assert residue_labels(got) == jax_labels(want)
    for chain in want.chains:
        g, w = got.select_chain(chain.chain_id), want.select_chain(chain.chain_id)
        for field in ("coords", "elements", "atom_names", "res_index", "bfactors"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
        assert g.to_pdb() == w.to_pdb()
    with pytest.raises(KeyError, match="no chain"):
        got.select_chain("Z")


@pytest.mark.parametrize("which", ["1ubq", "two_chain", "noisy"])
def test_geometry_equals_jax(which, ubq_pdb_gz, two_chain_pdb, noisy_pdb):
    """Chi angles (bit for bit: the port computes a structure's chis in one
    call, the JAX package one at a time), bins and rotamer codes equal, NaN
    where a side chain is cut; dihedrals of random points within 1e-9
    degrees."""
    import timed_design_tpu.structure.geometry as J
    from timed_design_tpu.structure import load_pdb as jax_load

    import timed_design_tpu_torch.structure.geometry as T
    from timed_design_tpu_torch.structure import load_pdb

    path = {"1ubq": ubq_pdb_gz, "two_chain": two_chain_pdb, "noisy": noisy_pdb}[which]
    got, want = load_pdb(path), jax_load(path)
    np.testing.assert_array_equal(T.encode_structure_rotamers(got),
                                  J.encode_structure_rotamers(want))
    assert repr(T.tag_chi_angles(got)) == repr(J.tag_chi_angles(want))
    if which == "two_chain":
        assert np.isnan(T.encode_structure_rotamers(got)[4])
    pts = np.random.default_rng(7).normal(size=(4, 50, 3))
    np.testing.assert_allclose(T.dihedral(*pts), J.dihedral(*pts), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(T.chi_bin(np.arange(-400, 800, 7.5)),
                                  J.chi_bin(np.arange(-400, 800, 7.5)))


def test_superposition_equals_jax(ubq_pdb_gz):
    """superpose, kabsch, ca_rmsd and gdt within 1e-6, on 1ubq's CA moved by
    a rotation, a translation and noise."""
    import timed_design_tpu.structure.geometry as J

    import timed_design_tpu_torch.structure.geometry as T
    from timed_design_tpu_torch.structure import load_pdb

    ca = load_pdb(ubq_pdb_gz).backbone_arrays()["CA"].astype(np.float64)
    rng = np.random.default_rng(8)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    moved = ca @ q.T + 7.0 + rng.normal(0, 1.5, ca.shape)
    for got, want in zip(T.superpose(moved, ca), J.superpose(moved, ca)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    c = ca - ca.mean(0)
    for got, want in zip(T.kabsch(c @ q.T, c), J.kabsch(c @ q.T, c)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert abs(T.ca_rmsd(moved, ca) - J.ca_rmsd(moved, ca)) < 1e-6
    assert T.gdt(moved, ca) == J.gdt(moved, ca)


def test_constants_equal_jax():
    """The chi definitions, the codec's helpers and BLOSUM62."""
    import timed_design_tpu.constants as J

    import timed_design_tpu_torch.constants as T

    assert T.SIDE_CHAIN_DIHEDRALS == J.SIDE_CHAIN_DIHEDRALS
    np.testing.assert_array_equal(T.REDUCTION_GUIDE, J.REDUCTION_GUIDE)
    assert list(T.REDUCTION_GUIDE) == [0, 1, 4, 13, 40, 49, 50, 59, 68, 149, 158, 185, 194,
                                      203, 230, 311, 314, 317, 320, 329]
    for ret in (False, True):
        got, want = T.get_rotamer_codec(ret), J.get_rotamer_codec(ret)
        assert got[1:] == want[1:]
        assert all((got[0][k] == want[0][k]).all() for k in range(338))
    for aa in range(20):
        for bins in [(), (1,), (3, 2), (1, 2, 3), (3, 3, 3, 3), (4,), (0, 1)]:
            assert T.encode_chi_bins_to_rotamer(aa, bins) == J.encode_chi_bins_to_rotamer(aa, bins)
    np.testing.assert_array_equal(T.BLOSUM62_MATRIX, J.BLOSUM62_MATRIX)
    a, b = "ARNDCQEGHILKMFPSTWYVBZX", "XZBVYWTSPFMKLIHGEQCDNRA"
    np.testing.assert_array_equal(T.blosum62_scores(a, b), J.blosum62_scores(a, b))
    assert T.lookup_blosum62("W", "Y") == J.lookup_blosum62("W", "Y") == 2
    assert T.sequence_similarity(a, b) == J.sequence_similarity(a, b)
    with pytest.raises(ValueError, match="Length mismatch"):
        T.sequence_similarity("AA", "A")


# ------------------------------------------------------ structure analyses

def test_packing_density_equals_jax(ubq_pdb_gz, two_chain_pdb):
    """Contact counts exactly, per atom and per residue with every filter
    and both aggregations, on 1ubq and on the two chains; B-factors and
    entropy as the JAX package's."""
    import timed_design_tpu.analyse.structure_analysis as J
    from timed_design_tpu.structure import load_pdb as jax_load

    import timed_design_tpu_torch.analyse.structure_analysis as T
    from timed_design_tpu_torch.structure import load_pdb

    for path in (ubq_pdb_gz, two_chain_pdb):
        got, want = load_pdb(path), jax_load(path)
        np.testing.assert_array_equal(
            T.atom_packing_density(got.coords, chunk=97, device="cpu"),
            J.atom_packing_density(want.coords))
        np.testing.assert_array_equal(T.structure_packing_density(got, 6.0, device="cpu"),
                                      J.structure_packing_density(want, 6.0))
        for filt in ("ca", "backbone", "all"):
            for compat in (False, True):
                assert (T.extract_packdensity_from_structure(got, filt, reference_compat=compat,
                                                             device="cpu")
                        == J.extract_packdensity_from_structure(want, filt,
                                                                reference_compat=compat))
        assert T.extract_bfactor_from_structure(got) == J.extract_bfactor_from_structure(want)
    with pytest.raises(ValueError, match="Atom filter"):
        T.extract_packdensity_from_structure(got, "side", device="cpu")
    p = np.random.default_rng(9).dirichlet(np.ones(20) * 0.2, 30)
    p[0] = 0.0
    p[0, 3] = 1.0
    np.testing.assert_array_equal(T.calculate_prediction_entropy(p),
                                  J.calculate_prediction_entropy(p))


def test_prediction_entropy_from_files_equals_jax(tmp_path):
    import timed_design_tpu.analyse.structure_analysis as J

    import timed_design_tpu_torch.analyse.structure_analysis as T

    p = np.random.default_rng(10).dirichlet(np.ones(338) * 0.1, 25)
    np.savetxt(tmp_path / "M_rot.csv", p, delimiter=",")
    (tmp_path / "M.txt").write_text("ignore_uncommon False\ninclude_pdbs\n##########\n"
                                    "1abcA 15\n2xyzB 10\n")
    got = T.extract_prediction_entropy_to_dict(tmp_path / "M_rot.csv", tmp_path / "M.txt", True)
    want = J.extract_prediction_entropy_to_dict(tmp_path / "M_rot.csv", tmp_path / "M.txt", True)
    assert list(got) == list(want) == ["1abcA", "2xyzB"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------- AF2, plots

@pytest.fixture
def af2_tree(tmp_path, ubq_pdb_gz):
    """The AF2 output tree of tests/test_af2_plots.py (a translated refold,
    a truncated one, an unranked file) and 1ubq as the reference."""
    from tests.test_af2_plots import _translate_pdb, _truncate_pdb

    text = gzip.decompress(ubq_pdb_gz.read_bytes()).decode()
    d = tmp_path / "af2_out" / "job_0"
    d.mkdir(parents=True)
    (d / "designA_rank_001_model_1.pdb").write_text(_translate_pdb(text, 25.0))
    (d / "designB_rank_001_model_1.pdb").write_text(_truncate_pdb(text, 50))
    (d / "not_ranked.pdb").write_text(text)
    ref = tmp_path / "1ubq.pdb"
    ref.write_text(text)
    return tmp_path / "af2_out", ref


def _same_refolds(got, want):
    assert [r.design for r in got] == [r.design for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([g.rmsd, g.mean_plddt, *g.gdt.values()],
                                   [w.rmsd, w.mean_plddt, *w.gdt.values()], rtol=0, atol=1e-6)
        assert list(g.gdt) == list(w.gdt)


def test_af2_equals_jax(tmp_path, af2_tree):
    """Fasta partitioning, the SLURM script, output renaming, the folder's
    refolds (RMSD, GDT, pLDDT; NaN on a length mismatch) and the combined
    property table, as the JAX package gives them."""
    import timed_design_tpu.analyse.af2 as J
    from timed_design_tpu.structure import load_pdb as jax_load

    import timed_design_tpu_torch.analyse.af2 as T
    from timed_design_tpu_torch.structure import load_pdb

    af2_dir, ref = af2_tree
    fasta = tmp_path / "s.fasta"
    fasta.write_text("".join(f">d{i}\nMKV{'A' * i}\n" for i in range(7)))
    for mod, name in ((T, "port"), (J, "jax")):
        folders = mod.partition_fastas(fasta, tmp_path / name, per_folder=3)
        assert [f.name for f in folders] == ["job_0", "job_1", "job_2"]
        mod.make_af2_slurm_script(folders[1], tmp_path / name)
    for p in sorted((tmp_path / "jax").rglob("*.*")):
        got = (tmp_path / "port" / p.relative_to(tmp_path / "jax")).read_text()
        assert got.replace("/port/", "/jax/") == p.read_text(), p.name
    assert T.read_fasta(fasta) == J.read_fasta(fasta)
    assert T.rename_af2_outputs(af2_dir) == J.rename_af2_outputs(af2_dir)
    got, want = T.analyse_af2_folder(ref, af2_dir), J.analyse_af2_folder(ref, af2_dir)
    _same_refolds(got, want)
    assert np.isnan(got[1].rmsd)
    probs = np.random.default_rng(0).dirichlet(np.ones(20), size=76)
    tg = T.combined_property_table(probs, load_pdb(ref), got, device="cpu")
    tw = J.combined_property_table(probs, jax_load(ref), want)
    assert tg["mean_entropy"] == tw["mean_entropy"]
    assert tg["mean_packing_density"] == tw["mean_packing_density"]
    assert repr(tg["designs"]) == repr(tw["designs"])


def test_analyse_cherrypicked_equals_jax(tmp_path, ubq_pdb_gz):
    """Per-position CA deviation, pLDDT, packing density and entropy across
    models, and the long-format CSV, as the JAX package writes them."""
    import timed_design_tpu.analyse.af2 as J

    import timed_design_tpu_torch.analyse.af2 as T
    from tests.test_af2_plots import _translate_pdb, _truncate_pdb

    text = gzip.decompress(ubq_pdb_gz.read_bytes()).decode()
    ref = tmp_path / "1ubq.pdb"
    ref.write_text(text)
    for model, body in (("TIMED", _translate_pdb(text, 3.0)), ("DenseCPD", _truncate_pdb(text, 60))):
        (tmp_path / "af2" / model).mkdir(parents=True)
        (tmp_path / "af2" / model / f"x_1ubq_ranked_0.pdb").write_text(body)
    preds = tmp_path / "preds"
    preds.mkdir()
    np.savetxt(preds / "TIMED.csv", np.random.default_rng(1).dirichlet(np.ones(20), 76),
               delimiter=",")
    (preds / "TIMED.txt").write_text("ignore_uncommon False\ninclude_pdbs\n##########\n1ubqA 76\n")
    got = T.analyse_cherrypicked(ref, tmp_path / "af2", preds, tmp_path / "port", device="cpu")
    want = J.analyse_cherrypicked(ref, tmp_path / "af2", preds, tmp_path / "jax")
    assert got["models"] == want["models"] == ["DenseCPD", "TIMED"]
    np.testing.assert_allclose(list(got["rmsd"].values()), list(want["rmsd"].values()),
                               rtol=0, atol=1e-6)
    for k, v in want["per_position"].items():
        np.testing.assert_allclose(got["per_position"][k], v, rtol=0, atol=1e-6)
    assert ((tmp_path / "port" / "1ubq_cherrypicked.csv").read_text()
            == (tmp_path / "jax" / "1ubq_cherrypicked.csv").read_text())
    assert {p.name for p in (tmp_path / "port").iterdir()} == {
        p.name for p in (tmp_path / "jax").iterdir()}


def _pixels(path):
    import matplotlib.image

    return matplotlib.image.imread(str(path))


def test_plots_draw_what_jax_draws(tmp_path):
    """Every plot writes its file, and the image drawn is the JAX package's
    pixel for pixel: confusion matrix, mean/variance, heatmap, logo, the
    sweep and SCWRL-score plots."""
    import matplotlib.pyplot as plt

    import timed_design_tpu.analyse as J

    import timed_design_tpu_torch.analyse as T

    rng = np.random.default_rng(11)
    cm = rng.random((12, 12))
    P = rng.dirichlet(np.ones(20), size=30)
    P338 = rng.dirichlet(np.ones(338) * 0.1, size=6)
    points = [J.SweepPoint(t, rng.normal(t, 0.2, 20)) for t in (0.1, 0.5, 1.0)]
    for model, scores in (("TIMED", (-40.0, -35.0)), ("DenseCPD", (-30.0, -25.0))):
        (tmp_path / model).mkdir()
        (tmp_path / model / "scwrl_scores.csv").write_text(
            f"pdb,score_pred,score_real\n1abcA,{scores[0]},-50.0\n2xyzB,{scores[1]},nan\n")
    dirs = {m: tmp_path / m for m in ("TIMED", "DenseCPD")}
    for mod, name in ((T, "port"), (J, "jax")):
        out = tmp_path / name
        out.mkdir()
        paths = [
            mod.plot_cm(cm, list("abcdefghijkl"), list("ABCDEFGHIJKL"), "cm test", out, True),
            mod.plot_mean_var_probs(P, "m", out),
            mod.plot_sequence_heatmap(P, "m", out),
            mod.plot_metric_vs_temperature(points, "RMSD", out),
            mod.plot_models_comparison({"TIMED": points, "X": points[:2]}, "RMSD", out),
            mod.plot_scwrl_scores(dirs, out),
            *mod.plot_patterns({"1abcA": P[:10]}, "m", out, prediction_csv=tmp_path / "none.csv"),
        ]
        for i, probs in enumerate((P[:12], P338)):
            fig = mod.create_sequence_logo(probs)
            fig.savefig(out / f"logo{i}.png")
            plt.close(fig)
        assert all(p.exists() for p in paths)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(names) == 9
    for name in names:
        np.testing.assert_array_equal(_pixels(tmp_path / "port" / name),
                                      _pixels(tmp_path / "jax" / name), err_msg=name)


def test_create_rot_cm_panels_equal_jax(tmp_path, monkeypatch):
    """create_rot_cm hands plot_cm the JAX package's panels (matrices,
    labels and titles), without rendering its 58 large images."""
    import timed_design_tpu.analyse.plots as J

    import timed_design_tpu_torch.analyse.plots as T
    from timed_design_tpu_torch.constants import ROTAMER_CATEGORIES

    cm = np.random.default_rng(3).random((338, 338))
    calls = {}
    for mod, name in ((T, "port"), (J, "jax")):
        calls[name] = []
        monkeypatch.setattr(mod, "plot_cm", lambda c, y, x, title, out, _l=calls[name], **kw:
                            _l.append((np.asarray(c), list(y), list(x), title)))
        mod.create_rot_cm(cm, ROTAMER_CATEGORIES, "unweighted", tmp_path)
    assert len(calls["port"]) == len(calls["jax"]) == 58
    for (gc, gy, gx, gt), (wc, wy, wx, wt) in zip(calls["port"], calls["jax"]):
        assert (gy, gx, gt) == (wy, wx, wt)
        np.testing.assert_array_equal(gc, wc)


# -------------------------------------------------------- NetSolP and SCWRL

def test_netsolp_equals_jax(tmp_path):
    """Against the fake predict.py of tests/test_netsolp_fake.py: the scores
    and the joined metrics CSV as the JAX package's; a missing checkout
    raises."""
    import timed_design_tpu.analyse.netsolp as J

    import timed_design_tpu_torch.analyse.netsolp as T
    from tests.test_netsolp_fake import _FAKE_PREDICT

    d = tmp_path / "netsolp"
    d.mkdir()
    (d / "predict.py").write_text(_FAKE_PREDICT)
    fasta = tmp_path / "samples.fasta"
    fasta.write_text(">1ubqA_0\nMQIFVK\n>1ubqA_1\nAQIFVK\n>2xyzB_0\nKVFIQM\n")
    metrics = tmp_path / "samples_metrics.csv"
    metrics.write_text("pdb,sequence,charge\n1ubqA,MQIFVK,0.9\n1ubqA,AQIFVK,0.9\n2xyzB,KVFIQM,0.1\n")
    assert T.run_netsolp(fasta, d) == J.run_netsolp(fasta, d)
    out = T.annotate_samples_with_netsolp(fasta, metrics, d)
    text = out.read_text()
    assert J.annotate_samples_with_netsolp(fasta, metrics, d).read_text() == text
    assert "predicted_solubility" in text.splitlines()[0]
    with pytest.raises(T.NetSolPNotFoundError):
        T.run_netsolp(fasta, tmp_path / "nowhere")


def test_scwrl_adapter_equals_jax(tmp_path, ubq_pdb_gz, two_chain_pdb, monkeypatch):
    """Against the fake Scwrl4 of tests/test_scwrl_fake_binary.py: the
    packed structure and score, and analyse_with_scwrl's scores, files and
    errors (an unknown assembly, an unpackable sequence, an existing
    output), as the JAX package's."""
    import stat

    import timed_design_tpu.analyse.scwrl as J
    from timed_design_tpu.structure import load_pdb as jax_load

    import timed_design_tpu_torch.analyse.scwrl as T
    from tests.test_scwrl_fake_binary import _FAKE
    from timed_design_tpu_torch.structure import load_pdb

    exe = tmp_path / "Scwrl4"
    exe.write_text(_FAKE)
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    assert T.find_scwrl(exe) == exe
    assert T.parse_scwrl_score("x\nTotal minimal energy of the graph = -55.25\n") == -55.25
    with pytest.raises(ChildProcessError):
        T.parse_scwrl_score("nothing")
    s, w = load_pdb(two_chain_pdb), jax_load(two_chain_pdb)
    (gp, gs), (wp, ws) = T.pack_side_chains_scwrl(s, ["AC"], exe), J.pack_side_chains_scwrl(w, ["AC"], exe)
    assert gs == ws and gp.to_pdb() == wp.to_pdb()
    seqs = {"1ubqA": "M" * 76, "2chnA": "xx", "2chnB": "AC", "9zzzA": "AAA"}
    for mod, load, name in ((T, load_pdb, "port"), (J, jax_load, "jax")):
        out = tmp_path / name
        out.mkdir()
        (out / "2chnB__p.pdb").write_text("exists")
        asm = {"1ubq": load(ubq_pdb_gz), "2chn": load(two_chain_pdb)}
        scores, errors = mod.analyse_with_scwrl(seqs, asm, out, "_p", exe)
        assert list(scores) == ["1ubqA"] and set(errors) == {"2chnA", "2chnB", "9zzzA"}
    for p in sorted((tmp_path / "jax").iterdir()):
        got = (tmp_path / "port" / p.name).read_text().replace(str(tmp_path / "port"), "OUT")
        assert got == p.read_text().replace(str(tmp_path / "jax"), "OUT"), p.name
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(T.ScwrlNotFoundError):
        T.find_scwrl(None)


# -------------------------------------------------------------- fetcher

@pytest.fixture(scope="module")
def pdb_server(tmp_path_factory, ubq_pdb_gz):
    """A localhost HTTP server: 1ubq.pdb1.gz, 9abc.pdb1 (plain only),
    2bad.pdb1.gz (not gzip) + 2bad.pdb1, 3htm.pdb1 (an HTML page)."""
    docroot = tmp_path_factory.mktemp("torch_rcsb")
    raw = ubq_pdb_gz.read_bytes()
    plain = gzip.decompress(raw)
    (docroot / "1ubq.pdb1.gz").write_bytes(raw)
    (docroot / "9abc.pdb1").write_bytes(plain)
    (docroot / "2bad.pdb1.gz").write_bytes(b"this is not gzip data")
    (docroot / "2bad.pdb1").write_bytes(plain)
    (docroot / "3htm.pdb1").write_bytes(b"<html>proxy error</html>")

    class QuietHandler(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *a, **k):
            pass

    server = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(QuietHandler, directory=str(docroot)))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{server.server_address[1]}/"
    server.shutdown()
    th.join(timeout=10)


@pytest.mark.parametrize("code,want", [("1UBQ", "1ubq.pdb1.gz"), ("9abc", "9abc.pdb1"),
                                       ("2bad", "2bad.pdb1"), ("3htm", None), ("0zzz", None)])
def test_fetch_pdb_equals_jax(tmp_path, pdb_server, code, want):
    """fetch_pdb takes the file the JAX package takes (gzip, the plain
    fallback, a .gz that is not gzip skipped, an HTML page refused) and
    raises where it raises."""
    from timed_design_tpu.io.fetch import fetch_pdb as jax_fetch

    from timed_design_tpu_torch.io.fetch import fetch_pdb

    for fetch, name in ((fetch_pdb, "port"), (jax_fetch, "jax")):
        if want is None:
            with pytest.raises(FileNotFoundError, match=code):
                fetch(code, tmp_path / name, base_url=pdb_server, verbosity=0)
        else:
            out = fetch(code, tmp_path / name, base_url=pdb_server, verbosity=0)
            assert out == tmp_path / name / want
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())


def test_fetcher_resolve_and_tag_equal_jax(tmp_path, pdb_server):
    """make_fetcher's sharded mirror, resolve_structure_paths (a code
    fetched once for all its chains, then found locally) and
    tag_structures_with_rotamers with a fetcher, as in the JAX package."""
    from timed_design_tpu.analyse.rotamer import resolve_structure_paths as jax_resolve
    from timed_design_tpu.analyse.rotamer import tag_structures_with_rotamers as jax_tag
    from timed_design_tpu.io.fetch import make_fetcher as jax_fetcher

    from timed_design_tpu_torch.analyse.rotamer import (
        resolve_structure_paths,
        tag_structures_with_rotamers,
    )
    from timed_design_tpu_torch.io.fetch import make_fetcher

    calls = []

    def counting(opener):
        def fetcher(code):
            calls.append(code)
            return opener(code)
        return fetcher

    for fetcher, resolve, tag, name in (
            (make_fetcher, resolve_structure_paths, tag_structures_with_rotamers, "port"),
            (jax_fetcher, jax_resolve, jax_tag, "jax")):
        calls.clear()
        f = counting(fetcher(tmp_path / name, base_url=pdb_server))
        paths = resolve(["1ubqA", "1ubqB", "0zzzA"], tmp_path / name, fetcher=f)
        assert calls == ["1ubq", "0zzz"] and paths["0zzz"] is None
        assert paths["1ubq"] == tmp_path / name / "ub" / "1ubq.pdb1.gz"
        assert resolve(["1ubqA"], tmp_path / name)["1ubq"] == paths["1ubq"]
        tags, asm = tag({"9abc": None, "0zzz": None}, fetcher=fetcher(tmp_path / name,
                                                                       base_url=pdb_server))
        if name == "port":
            got = (tags, asm["9abc"].to_pdb())
        else:
            want = (tags, asm["9abc"].to_pdb())
    assert repr(got) == repr(want)


# ------------------------------------------------------------------ sweeps

def _peaked_timed_checkpoint(path, n_classes, seed):
    """A small TIMED checkpoint written by the JAX package's trainer, its
    head scaled by 64 so that argmax and top-3 margins are wide."""
    import types

    import jax

    from timed_design_tpu.models import timed
    from timed_design_tpu.train.train import save_checkpoint

    v = timed(n_classes=n_classes, filters=(4, 8)).init(
        jax.random.key(seed), np.zeros((1, 21, 21, 21, 5), np.float32))
    params = jax.tree.map(np.asarray, v["params"])
    params["Conv_0"]["kernel"] = params["Conv_0"]["kernel"] * 64.0
    save_checkpoint(types.SimpleNamespace(params=params,
                                          batch_stats=jax.tree.map(np.asarray, v["batch_stats"])),
                    path, build_kwargs={"filters": (4, 8)})
    return f"TIMED@{path}"


def test_run_model_benchmark_equals_jax(tmp_path, ubq_pdb_gz):
    """The port's run_model_benchmark on 1ubq's PDB file against the JAX
    package's on its HDF5 frames of the same file, same weights: metrics
    within 1e-6, the same files per model."""
    import warnings

    from timed_design_tpu.analyse import run_model_benchmark as jax_bench
    from timed_design_tpu.voxel import make_frame_dataset

    from timed_design_tpu_torch.analyse import run_model_benchmark

    ckpt = _peaked_timed_checkpoint(tmp_path / "t.npz", 20, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        h5 = make_frame_dataset([ubq_pdb_gz], tmp_path / "d.hdf5")
        want = jax_bench([ckpt], h5, tmp_path / "jax", batch_size=32)
        got = run_model_benchmark([ckpt], ubq_pdb_gz, tmp_path / "port", batch_size=32,
                                  device="cpu")
    assert list(got) == list(want) == [ckpt]
    for key in ("accuracy_1", "accuracy_3", "precision", "recall"):
        assert abs(got[ckpt][key] - want[ckpt][key]) <= 1e-6, key
    assert set(got[ckpt]["timings"]) == {"datasetmap", "predict", "decode", "write"}
    assert sorted(str(p.relative_to(tmp_path / "port")) for p in (tmp_path / "port").rglob("*")) \
        == sorted(str(p.relative_to(tmp_path / "jax")) for p in (tmp_path / "jax").rglob("*"))


def test_run_model_benchmark_on_one_hdf5_file_equals_jax(tmp_path, ubq_pdb_gz):
    """Both packages' run_model_benchmark on the same ``.hdf5`` frame
    dataset (the JAX package's ``make_frame_dataset`` of 1ubq), as
    ``scripts/run_benchmark_models.py`` passes it: metrics within 1e-6 and
    the same file tree; over a mesh of one (no world joined), the same."""
    import warnings

    from timed_design_tpu.analyse import run_model_benchmark as jax_bench
    from timed_design_tpu.voxel import make_frame_dataset

    from timed_design_tpu_torch.analyse import run_model_benchmark
    from timed_design_tpu_torch.parallel import make_mesh

    ckpt = _peaked_timed_checkpoint(tmp_path / "t.npz", 20, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        h5 = make_frame_dataset([ubq_pdb_gz], tmp_path / "d.hdf5")
        want = jax_bench([ckpt], h5, tmp_path / "jax", batch_size=32)
        got = run_model_benchmark([ckpt], h5, tmp_path / "port", batch_size=32, device="cpu")
        over = run_model_benchmark([ckpt], h5, tmp_path / "mesh", batch_size=32, device="cpu",
                                   mesh=make_mesh())
    assert list(got) == list(want) == list(over) == [ckpt]
    for key in ("accuracy_1", "accuracy_3", "precision", "recall"):
        assert abs(got[ckpt][key] - want[ckpt][key]) <= 1e-6, key
        assert over[ckpt][key] == got[ckpt][key], key
    assert got[ckpt]["accuracy_1"] > 0

    def tree(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*"))

    assert tree(tmp_path / "port") == tree(tmp_path / "jax") == tree(tmp_path / "mesh")


# Public names of the JAX package that ROADMAP.md lists under "Not ported":
# orbax checkpoints, jax.profiler helpers and the TPU-measured dispatch
NOT_PORTED = {"train": {"save_checkpoint_orbax", "load_checkpoint_orbax"},
              "utils": {"trace", "block_until_ready"},
              "sample": {"sample_class_indices"}}


def test_every_public_name_of_the_jax_subpackages_is_in_the_port():
    """Each name that a JAX subpackage's ``__init__.py`` imports or assigns
    (read with ast) is an attribute of the port's subpackage of the same
    name, less ``NOT_PORTED``."""
    import ast
    import importlib

    root = Path(__file__).resolve().parent.parent / "timed_design_tpu"
    missing = {}
    for init in sorted(root.glob("*/__init__.py")):
        names = set()
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names |= {(a.asname or a.name).split(".")[0] for a in node.names}
            elif isinstance(node, ast.Assign):
                names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        names = {n for n in names if not n.startswith("_") and n != "annotations"}
        sub = init.parent.name
        port = importlib.import_module(f"timed_design_tpu_torch.{sub}")
        gone = sorted(n for n in names - NOT_PORTED.get(sub, set()) if not hasattr(port, n))
        if gone:
            missing[sub] = gone
    assert not missing


def _jax_structure_uniforms(seed, n, offsets, pad_to=32):
    """The (n, sum L) uniforms JAX's sample_all_structures draws (one key
    per structure from ``split``, drawn at the padded length)."""
    import jax

    lengths = np.diff(np.asarray(offsets))
    keys = jax.random.split(jax.random.key(seed), len(lengths))
    return np.concatenate([
        np.asarray(jax.random.uniform(keys[i], (n, -(-int(L) // pad_to) * pad_to, 1)))[:, :L, 0]
        for i, L in enumerate(lengths)], axis=1)


def test_run_temperature_sweep_equals_jax(tmp_path, monkeypatch):
    """Fed JAX's uniforms, the port's sweep writes the JAX package's files
    per temperature: names, fasta byte for byte, metrics within 1e-4; one
    sampling call per temperature."""
    import json

    from timed_design_tpu.analyse import run_temperature_sweep as jax_sweep

    import timed_design_tpu_torch.ops.sample as ops_sample
    from timed_design_tpu_torch.analyse import run_temperature_sweep

    p = np.random.default_rng(12).random((23, 338)) ** 4
    np.savetxt(tmp_path / "M_rot.csv", p / p.sum(1, keepdims=True), delimiter=",")
    (tmp_path / "M.txt").write_text("ignore_uncommon False\ninclude_pdbs\n##########\n"
                                    "1abcA 9\n1abcB 14\n")
    calls = []

    def jax_uniforms(seed, n, offsets):
        calls.append(seed)
        return _jax_structure_uniforms(seed, n, offsets)

    monkeypatch.setattr(ops_sample, "philox_uniforms_batched", jax_uniforms)
    temps = (0.1, 1.0, 5.0)
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        if name == "jax":
            want = jax_sweep(tmp_path / "M_rot.csv", tmp_path / "M.txt", sample_n=7,
                             temperatures=temps)
        else:
            got = run_temperature_sweep(tmp_path / "M_rot.csv", tmp_path / "M.txt", sample_n=7,
                                        temperatures=temps, device="cpu")
    assert got == want and len(calls) == 3
    for t in temps:
        js, fasta, csv = got[t]
        assert js.endswith(".json") and fasta.endswith(".fasta") and csv.endswith("_metrics.csv")
        assert (tmp_path / "port" / fasta).read_bytes() == (tmp_path / "jax" / fasta).read_bytes()
        g, w = (json.loads((tmp_path / d / js).read_text()) for d in ("port", "jax"))
        assert {k: [s for s, *_ in v] for k, v in g.items()} == {
            k: [s for s, *_ in v] for k, v in w.items()}
        np.testing.assert_allclose([m for v in g.values() for _, *m in v],
                                   [m for v in w.values() for _, *m in v], rtol=1e-4)
        rows = [np.genfromtxt(tmp_path / d / csv, delimiter=",", skip_header=1, dtype=None,
                              encoding="ascii") for d in ("port", "jax")]
        assert [tuple(r)[:2] for r in rows[0]] == [tuple(r)[:2] for r in rows[1]]
        np.testing.assert_allclose([tuple(r)[2:] for r in rows[0]],
                                   [tuple(r)[2:] for r in rows[1]], rtol=1e-4)


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("case", list(METRIC_CASES))
def test_metric_passes_card_equal_cpu(case, cuda_device):
    """The card's top-k ranks, pair counts, confusion counts and bias equal
    the CPU's; the weighted confusion matrix within 1e-12."""
    import timed_design_tpu_torch.analyse.metrics as T

    y, s = _metric_inputs(case)
    yc, sc = torch.from_numpy(y).to(cuda_device), torch.from_numpy(s).to(cuda_device)
    assert torch.equal(T.true_class_rank(yc, sc).cpu(), T.true_class_rank(y, s))
    assert torch.equal(T.pair_rank_counts(yc, sc).cpu(), T.pair_rank_counts(y, s))
    yp = s.argmax(1)
    ypc = sc.argmax(1)
    np.testing.assert_array_equal(ypc.cpu().numpy(), yp)
    c = s.shape[1]
    np.testing.assert_array_equal(T.confusion(yc, ypc, c), T.confusion(y, yp, c))
    w = np.bincount(y, minlength=c) / len(y)
    np.testing.assert_allclose(T.confusion(yc, ypc, c, sample_weight=torch.from_numpy(w[y]).to(
        cuda_device)), T.confusion(y, yp, c, sample_weight=w[y]), rtol=1e-12, atol=0)
    names = [str(i) for i in range(c)]
    assert T.prediction_bias(yc, ypc, names) == T.prediction_bias(y, yp, names)


@pytest.mark.cuda
def test_packing_density_card_equals_cpu(cuda_device):
    from timed_design_tpu_torch.analyse import atom_packing_density
    from timed_design_tpu_torch.structure import load_pdb

    xyz = load_pdb(REPO / "tests" / "testing_files" / "1ubq.pdb1.gz").coords
    many = np.concatenate([xyz + [40.0 * k, 0, 0] for k in range(10)])
    np.testing.assert_array_equal(atom_packing_density(many, device=cuda_device),
                                  atom_packing_density(many, device="cpu"))
