"""PyTorch port, ``td-analyse-rotamers``: the port's CLI against the JAX
package's on the fixtures of tests/test_analyse_rotamers_cli.py (1ubq and
its crystal rotamers): without SCWRL, with the fake Scwrl4 binary of
tests/test_scwrl_fake_binary.py on an old-format and a new-format map (the
real sequences rebuilt from the structures), and with ``--allow-fetch``
against a localhost HTTP server. The port runs with ``--device cpu``.

Outputs: the same files; ``results_*.txt`` byte-equal apart from the AUC
lines, which agree within 1e-12; ``scwrl_scores.csv``, the packed PDBs and
the SCWRL error files byte-equal.
"""
import functools
import gzip
import http.server
import os
import shutil
import stat
import subprocess
import sys
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


def _fake_scwrl(d: Path) -> Path:
    from tests.test_scwrl_fake_binary import _FAKE

    exe = d / "Scwrl4"
    exe.write_text(_FAKE)
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    return exe


def _inputs(d: Path, ubq_pdb_gz, old_map: bool, noisy: bool, mirror: bool = True):
    """The prediction CSV (np.savetxt, as td-predict writes it), the map and
    the PDB mirror of tests/test_analyse_rotamers_cli.py; ``noisy`` mixes
    in random rows so that the AUCs and top-k are not trivial."""
    from timed_design_tpu_torch.structure import encode_structure_rotamers, load_pdb

    d.mkdir()
    pdb_dir = d / "pdbs"
    pdb_dir.mkdir()
    if mirror:
        shutil.copy(ubq_pdb_gz, pdb_dir / "1ubq.pdb1.gz")
    structure = load_pdb(ubq_pdb_gz)
    truth = np.array(encode_structure_rotamers(structure), float)
    P = np.full((76, 338), 0.1 / 337)
    P[np.arange(76), truth.astype(int)] = 0.9
    if noisy:
        rng = np.random.default_rng(0)
        R = rng.random((76, 338)) ** 12
        P = 0.05 * P + 0.95 * R / R.sum(1, keepdims=True)
    np.savetxt(d / "TIMED_rot.csv", P, delimiter=",")
    if old_map:
        res = [r for r in structure.residues if r.is_standard_aa]
        (d / "TIMED.txt").write_text("".join(f"1ubq,A,{r.id},{r.res_name}\n" for r in res))
    else:
        (d / "TIMED.txt").write_text("ignore_uncommon False\ninclude_pdbs\n##########\n1ubqA 76\n")
    return ["--path_to_pred_matrix", str(d / "TIMED_rot.csv"), "--path_to_datasetmap",
            str(d / "TIMED.txt"), "--path_to_pdb", str(pdb_dir)] + (
        ["--support_old_datasetmap"] if old_map else [])


def _run_both(tmp_path, argv, capsys):
    from timed_design_tpu.cli.analyse_rotamers import main as jax_main

    from timed_design_tpu_torch.cli.analyse_rotamers import main

    jax_main(argv + ["--path_to_output", str(tmp_path / "jax")])
    want = capsys.readouterr().out
    main(argv + ["--path_to_output", str(tmp_path / "port"), "--device", "cpu"])
    got = capsys.readouterr().out
    return got, want


def _compare_outputs(tmp_path):
    got_dir, want_dir = tmp_path / "port", tmp_path / "jax"
    names = sorted(p.name for p in want_dir.iterdir())
    assert sorted(p.name for p in got_dir.iterdir()) == names
    for name in names:
        got, want = (got_dir / name).read_text(), (want_dir / name).read_text()
        if name.startswith("results_"):
            g = [l for l in got.splitlines() if not l.startswith("Metrics AUC_")]
            w = [l for l in want.splitlines() if not l.startswith("Metrics AUC_")]
            assert g == w, name
            auc = [[float(l.split(": ")[1]) for l in t.splitlines() if l.startswith("Metrics AUC_")]
                   for t in (got, want)]
            assert len(auc[0]) == 2
            np.testing.assert_allclose(auc[0], auc[1], rtol=1e-12, atol=0, err_msg=name)
        else:
            assert got.replace(str(got_dir), "OUT") == want.replace(str(want_dir), "OUT"), name
    return names


def _summary(out: str) -> list[str]:
    return [l for l in out.splitlines() if l.startswith(("[", "Skipping", "Tagging"))]


@pytest.mark.parametrize("noisy", [False, True])
def test_without_scwrl_equals_jax(tmp_path, ubq_pdb_gz, capsys, monkeypatch, noisy):
    """No SCWRL4 on the PATH: the wild-type analysis, then the skip."""
    monkeypatch.setenv("PATH", "/nonexistent")
    argv = _inputs(tmp_path / "in", ubq_pdb_gz, old_map=False, noisy=noisy)
    got, want = _run_both(tmp_path, argv, capsys)
    assert _summary(got) == _summary(want)
    assert "Skipping SCWRL analyses" in got
    assert ("[wt] top-1 1.0000" in got) is not noisy
    assert _compare_outputs(tmp_path) == ["results_wt.txt"]


@pytest.mark.parametrize("old_map", [True, False])
def test_with_fake_scwrl_equals_jax(tmp_path, ubq_pdb_gz, capsys, old_map):
    """The three analyses and scwrl_scores.csv with the fake Scwrl4, on an
    old-format map and on a new-format one (the real sequences rebuilt from
    the structures, so the wild-type packing runs)."""
    exe = _fake_scwrl(tmp_path)
    argv = _inputs(tmp_path / "in", ubq_pdb_gz, old_map=old_map, noisy=True)
    got, want = _run_both(tmp_path, argv + ["--path_to_scwrl", str(exe)], capsys)
    assert _summary(got) == _summary(want)
    assert "[scwrl-pred] top-1" in got and "[scwrl-real] top-1" in got
    names = _compare_outputs(tmp_path)
    assert {"results_wt.txt", "results_scwrl_pred.txt", "results_scwrl_real.txt",
            "scwrl_scores.csv", "1ubqA__pred.pdb", "1ubqA__real.pdb"} <= set(names)
    scores = (tmp_path / "port" / "scwrl_scores.csv").read_text().splitlines()
    assert scores[0] == "pdb,score_pred,score_real" and scores[1].startswith("1ubqA,")


@pytest.fixture(scope="module")
def pdb_server(tmp_path_factory, ubq_pdb_gz):
    docroot = tmp_path_factory.mktemp("torch_rot_rcsb")
    (docroot / "1ubq.pdb1.gz").write_bytes(ubq_pdb_gz.read_bytes())

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


def test_allow_fetch_equals_jax(tmp_path, ubq_pdb_gz, capsys, pdb_server, monkeypatch):
    """An empty mirror and ``--allow-fetch`` from a localhost server: both
    packages fetch 1ubq into the sharded mirror and score it alike; without
    the flag nothing is fetched and nothing is scored."""
    monkeypatch.setenv("PATH", "/nonexistent")
    argv = _inputs(tmp_path / "in", ubq_pdb_gz, old_map=False, noisy=True, mirror=False)
    from timed_design_tpu_torch.cli.analyse_rotamers import main

    with pytest.raises(ValueError, match="No structure overlaps"):
        main(argv + ["--path_to_output", str(tmp_path / "none"), "--device", "cpu"])
    capsys.readouterr()
    mirror = Path(argv[argv.index("--path_to_pdb") + 1])
    assert not list(mirror.rglob("*.gz"))
    fetch = ["--allow-fetch", "--fetch_base_url", pdb_server]
    from timed_design_tpu.cli.analyse_rotamers import main as jax_main

    jax_main(argv + fetch + ["--path_to_output", str(tmp_path / "jax")])
    want = capsys.readouterr().out
    assert (mirror / "ub" / "1ubq.pdb1.gz").exists()
    (mirror / "ub" / "1ubq.pdb1.gz").unlink()  # the port fetches it again
    main(argv + fetch + ["--path_to_output", str(tmp_path / "port"), "--device", "cpu"])
    got = capsys.readouterr().out
    assert "Fetched 1ubq" in got and "Fetched 1ubq" in want
    assert _summary(got) == _summary(want)
    assert _compare_outputs(tmp_path) == ["results_wt.txt"]


def test_flags_and_device(tmp_path):
    """The JAX CLI's flags and aliases plus --device (default cuda); without
    a card the default exits with a message naming --device cpu."""
    from timed_design_tpu.cli.analyse_rotamers import build_parser as jax_parser

    from timed_design_tpu_torch.cli.analyse_rotamers import build_parser, main

    argv = ["--path_to_pred_matrix", "m.csv", "--path_to_pdb", "pdbs", "--output_path", "out",
            "--scwrl_path", "scwrl4", "--workers", "8", "--allow-fetch", "--plot_confusion"]
    got, want = vars(build_parser().parse_args(argv)), vars(jax_parser().parse_args(argv))
    assert got.pop("device") == "cuda" and got == want
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            main(argv)


_HYGIENE = """
import sys
for name in ("timed_design_tpu", "jax", "flax", "h5py", "ml_dtypes", "matplotlib"):
    sys.modules[name] = None  # any import of these now raises ImportError
import runpy
sys.argv = ["td-analyse-rotamers", *sys.argv[1:]]
runpy.run_module("timed_design_tpu_torch.cli.analyse_rotamers", run_name="__main__")
"""


@pytest.mark.parametrize("plot", [False, True])
def test_runs_without_jax_or_matplotlib(tmp_path, ubq_pdb_gz, plot):
    """With the JAX package, jax, flax, h5py, ml_dtypes and matplotlib
    unimportable, as on the card's machine: the analysis runs with the fake
    Scwrl4; ``--plot_confusion`` exits non-zero before any analysis, with a
    message that names matplotlib and the flag."""
    exe = _fake_scwrl(tmp_path)
    argv = _inputs(tmp_path / "in", ubq_pdb_gz, old_map=False, noisy=True)
    argv += ["--path_to_scwrl", str(exe), "--path_to_output", str(tmp_path / "out"),
             "--device", "cpu"] + (["--plot_confusion"] if plot else [])
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _HYGIENE, *argv], capture_output=True,
                          text=True, env=env, cwd=tmp_path, timeout=600)
    if plot:
        assert proc.returncode != 0
        assert "matplotlib" in proc.stderr and "--plot_confusion" in proc.stderr
        assert not (tmp_path / "out").exists()
    else:
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "[scwrl-real] top-1" in proc.stdout
        assert (tmp_path / "out" / "scwrl_scores.csv").exists()
