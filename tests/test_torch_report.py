"""PyTorch port, the design report: ``report.py``, ``td-report``,
``td-predict --report`` and ``/report`` against the JAX package's.

The documents' text must be equal once the inline images are cut out, and
each image equal pixel for pixel after decoding where both packages draw the
same arrays with the same matplotlib calls. ``/report`` draws each server's
own float32 probabilities, which differ by up to 1e-5 (convolutions summed
in another order), and the entropy panel's axis scales itself to near-flat
random-weight rows, so a difference of 1e-6 moves its line by pixels. There
the arrays drawn are compared instead: probabilities within 1e-5, entropies
within 1e-4 bits (20 terms of p log2 p). Where matplotlib is missing, each
entry point refuses with a message that names it, before any work.
"""
import base64
import gzip
import io
import json
import os
import subprocess
import sys
import threading
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
IMAGE = 'src="data:image/png;base64,'


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several workers per host
    yield
    torch.set_num_threads(n)


def _split(doc: str) -> tuple[str, list[np.ndarray]]:
    """(the document with each inline PNG replaced by a marker, the PNGs
    decoded to pixel arrays)."""
    from matplotlib.image import imread

    head, *rest = doc.split(IMAGE)
    text, images = [head], []
    for part in rest:
        b64, tail = part.split('"', 1)
        images.append(imread(io.BytesIO(base64.b64decode(b64)), format="png"))
        text.append('src="IMAGE"' + tail)
    return "".join(text), images


def assert_same_report(got: str, want: str, n_images: int, pixels: bool = True) -> None:
    """Text equal, ``n_images`` images each; with ``pixels``, the images
    equal pixel for pixel."""
    got_text, got_images = _split(got)
    want_text, want_images = _split(want)
    assert got_text == want_text
    assert len(got_images) == len(want_images) == n_images
    for a, b in zip(got_images, want_images) if pixels else ():
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _record_drawn(monkeypatch, report, analyse) -> list:
    """Records, in order, the array each figure of ``report`` draws: the
    heatmap's and the logo's probabilities, the entropies."""
    drawn = []

    def recorder(name, fn):
        def record(arr, *args, **kw):
            drawn.append((name, np.asarray(arr, np.float64)))
            return fn(arr, *args, **kw)
        return record

    for name in ("_heatmap_fig", "_entropy_fig"):
        monkeypatch.setattr(report, name, recorder(name, getattr(report, name)))
    monkeypatch.setattr(analyse, "create_sequence_logo",
                        recorder("logo", analyse.create_sequence_logo))
    return drawn


def _result(n=12, classes=20, seed=0):
    """tests/test_report.py's inputs: seeded probabilities, the argmax
    design and a random native sequence."""
    from timed_design_tpu.constants import AA1

    rng = np.random.default_rng(seed)
    P = rng.random((n, classes))
    P /= P.sum(1, keepdims=True)
    aa = np.array(list(AA1))
    designed = "".join(aa[P[:, :20].argmax(1) % 20])
    native = "".join(rng.choice(list(AA1), n))
    return designed, native, P


def _cases():
    d, nat, P = _result()
    d2, nat2, P2 = _result(n=7, seed=5)
    r, rnat, R = _result(n=9, classes=338, seed=1)
    m, _, M = _result(n=6, seed=2)
    flat = np.full((4, 20), 1 / 20.0)
    return {
        "20-class, two chains": ({"1abcA": d, "1abcB": d2}, {"1abcA": nat, "1abcB": nat2},
                                 {"1abcA": P, "1abcB": P2}, "TIMED", None),
        "338-class with consensus": ({"2xyzA": r}, {"2xyzA": rnat}, {"2xyzA": R},
                                     "TIMED_rotamer", {"2xyzA": rnat}),
        "missing native": ({"3qqqA": m}, {}, {"3qqqA": M}, "model", None),
        "length mismatch": ({"aA": "MKYW"}, {"aA": "MK"}, {"aA": flat}, "T", None),
        "no native in the sequence block": ({"aA": "MKYW"}, {"aA": ""}, {"aA": flat}, "T", None),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_render_design_report_equals_jax(case):
    from timed_design_tpu.report import render_design_report as jax_render

    from timed_design_tpu_torch.report import render_design_report

    seqs, natives, probs, name, consensus = _cases()[case]
    got = render_design_report(seqs, natives, probs, model_name=name, pdb_to_consensus=consensus)
    want = jax_render(seqs, natives, probs, model_name=name, pdb_to_consensus=consensus)
    assert_same_report(got, want, 3 * len(seqs))


@pytest.mark.parametrize("designed,native", [("MKYW", ""), ("MKYW", "MK"), ("MKYW", "MKAW")])
def test_seq_block_equals_jax(designed, native):
    from timed_design_tpu.report import _seq_block as jax_seq_block

    from timed_design_tpu_torch.report import _seq_block

    assert _seq_block(designed, native) == jax_seq_block(designed, native)


def test_write_design_report_names_the_file(tmp_path):
    from timed_design_tpu_torch.report import write_design_report

    seqs, natives, probs, name, _ = _cases()["missing native"]
    assert write_design_report(seqs, natives, probs, tmp_path).name == "model_report.html"
    out = write_design_report(seqs, natives, probs, tmp_path / "sub", model_name=name,
                              filename="r.html")
    assert out == tmp_path / "sub" / "r.html" and "nan%" in out.read_text()


# ------------------------------------------------------- the entry points

def _write_checkpoint(path, n_classes, seed, filters=(4, 8)):
    import jax

    from timed_design_tpu.models import timed
    from timed_design_tpu.train.train import save_checkpoint

    m = timed(n_classes=n_classes, filters=filters)
    v = m.init(jax.random.key(seed), np.zeros((1, 21, 21, 21, 5), np.float32))
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
        v["batch_stats"],
    )
    save_checkpoint(types.SimpleNamespace(params=v["params"], batch_stats=stats),
                    path, build_kwargs={"filters": filters})
    return path


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _write_checkpoint(tmp_path_factory.mktemp("torch_report") / "timed.npz", 20, 0)


@pytest.fixture(scope="module")
def predicted(tmp_path_factory, ckpt, ubq_pdb_gz):
    """The port's ``td-predict --voxelize --report --device cpu`` on 1ubq:
    (its output directory, the result it returned)."""
    from timed_design_tpu_torch.cli.predict import main

    out = tmp_path_factory.mktemp("torch_report_predict")
    result = main(["--voxelize", "--path_to_dataset", str(ubq_pdb_gz),
                   "--path_to_model", f"TIMED@{ckpt}", "--path_to_output", str(out),
                   "--path_to_datasetmap", str(out / "datasetmap.txt"),
                   "--batch_size", "80", "--report", "--device", "cpu"])
    return out, result


def test_predict_report_equals_jax_write_design_report(predicted, tmp_path):
    """``td-predict --report`` writes ``{model stem}_report.html``, equal to
    the JAX package's ``write_design_report`` of the same predictions."""
    from timed_design_tpu.report import write_design_report as jax_write

    out, result = predicted
    want = jax_write(result.pdb_to_sequence, result.pdb_to_real_sequence,
                     result.pdb_to_probability, tmp_path, model_name="timed",
                     pdb_to_consensus=result.pdb_to_consensus)
    assert_same_report((out / "timed_report.html").read_text(), want.read_text(), 3)


def test_td_report_cli_equals_jax(predicted, tmp_path):
    """``td-report`` of both packages on the port's ``td-predict`` output
    (the float CSV and the SRB map), and both refuse ``--predict_rotamers``
    on a 20-column matrix."""
    from timed_design_tpu.cli.report import main as jax_main

    from timed_design_tpu_torch.cli.report import main

    out, _ = predicted
    argv = ["--path_to_pred_matrix", str(out / "TIMED.csv"),
            "--path_to_datasetmap", str(out / "TIMED.txt")]
    got = main(argv + ["--path_to_output", str(tmp_path / "port")])
    jax_main(argv + ["--path_to_output", str(tmp_path / "jax")])
    assert got == tmp_path / "port" / "TIMED_report.html"
    assert_same_report(got.read_text(), (tmp_path / "jax" / "TIMED_report.html").read_text(), 3)
    for fn in (main, jax_main):
        with pytest.raises(SystemExit, match="338"):
            fn(argv + ["--predict_rotamers", "--path_to_output", str(tmp_path)])


def _serve(make_server, designer):
    server = make_server(designer, "127.0.0.1", 0, "TIMED")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    return server, th, f"http://127.0.0.1:{server.server_address[1]}"


def _post_html(url: str, data: bytes) -> str:
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.status == 200 and r.headers["Content-Type"].startswith("text/html")
        return r.read().decode()


def test_report_endpoint_equals_jax(ckpt, ubq_pdb_gz, monkeypatch):
    """``/report`` of both servers on 1ubq, the same weights in float32:
    the same text, and the arrays drawn within 1e-5 (probabilities) and
    1e-4 (entropies; see the module's docstring)."""
    import timed_design_tpu.analyse as jax_analyse
    import timed_design_tpu.report as jax_report
    from timed_design_tpu.cli.serve import make_server as jax_make_server
    from timed_design_tpu.engine import DesignSession as JaxSession
    from timed_design_tpu.engine.coalescer import SerialDesigner as JaxSerial

    import timed_design_tpu_torch.analyse as analyse
    import timed_design_tpu_torch.report as report
    from timed_design_tpu_torch.cli.serve import make_server
    from timed_design_tpu_torch.engine import DesignSession
    from timed_design_tpu_torch.engine.coalescer import SerialDesigner

    drawn = (_record_drawn(monkeypatch, report, analyse),
             _record_drawn(monkeypatch, jax_report, jax_analyse))

    model = f"TIMED@{ckpt}"
    pdb = gzip.decompress(ubq_pdb_gz.read_bytes())
    docs = []
    for make, designer in (
            (make_server, SerialDesigner(DesignSession(model, compute_dtype="float32",
                                                       batch_size=80, device="cpu"))),
            (jax_make_server, JaxSerial(JaxSession(model, compute_dtype="float32",
                                                   batch_size=80)))):
        server, th, url = _serve(make, designer)
        try:
            docs.append(_post_html(url + "/report", json.dumps({"pdb": pdb.decode()}).encode()))
        finally:
            server.shutdown()
            server.server_close()
            designer.close()
            th.join(timeout=10)
    assert "<h2>queryA</h2>" in docs[0]
    assert_same_report(docs[0], docs[1], 3, pixels=False)
    assert [n for n, _ in drawn[0]] == [n for n, _ in drawn[1]] == [
        "_heatmap_fig", "_entropy_fig", "logo"]
    for (name, got), (_, want) in zip(*drawn):
        assert got.shape == want.shape == (76, 20)[:got.ndim]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 if name == "_entropy_fig" else 1e-5)


# ------------------------------------------------------ without matplotlib

_BLOCK = """
import sys
for name in ("timed_design_tpu", "jax", "flax", "optax", "h5py", "ml_dtypes", "matplotlib"):
    sys.modules[name] = None  # any import of these now raises ImportError
"""


def _run_blocked(module: str, argv: list[str]) -> subprocess.CompletedProcess:
    code = _BLOCK + f"import runpy\nsys.argv = {[module] + argv!r}\n" \
        f"runpy.run_module({module!r}, run_name='__main__')\n"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=300)


def test_clis_refuse_without_matplotlib(tmp_path):
    """``td-report`` and ``td-predict --report`` exit non-zero naming
    matplotlib, before any work: their input files do not exist, and no
    missing file is reported."""
    missing = str(tmp_path / "missing")
    proc = _run_blocked("timed_design_tpu_torch.cli.report",
                        ["--path_to_pred_matrix", missing + ".csv",
                         "--path_to_datasetmap", missing + ".txt"])
    assert proc.returncode != 0 and "td-report" in proc.stderr
    assert "matplotlib" in proc.stderr and "missing" not in proc.stderr
    proc = _run_blocked("timed_design_tpu_torch.cli.predict",
                        ["--voxelize", "--path_to_dataset", missing + ".pdb",
                         "--path_to_model", "TIMED", "--report", "--device", "cpu",
                         "--path_to_output", str(tmp_path)])
    assert proc.returncode != 0 and "--report" in proc.stderr
    assert "matplotlib" in proc.stderr and "missing" not in proc.stderr
    assert list(tmp_path.iterdir()) == []


def _post(url, data: bytes):
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_report_endpoint_refuses_without_matplotlib(ckpt, ubq_pdb_gz):
    """Without matplotlib ``/report`` answers an error that names it, before
    the designer sees the request, and ``/design`` answers 200 right after."""
    code = _BLOCK + ("import runpy\nsys.argv = ['serve', '--model', sys.argv[1], '--port', '0', "
                     "'--batch_size', '80', '--device', 'cpu']\n"
                     "runpy.run_module('timed_design_tpu_torch.cli.serve', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", code, f"TIMED@{ckpt}"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env, cwd=REPO)
    pdb = gzip.decompress(ubq_pdb_gz.read_bytes())
    try:
        line = ""
        for line in proc.stdout:
            if line.startswith("Serving"):
                break
        assert line.startswith("Serving"), line
        url = line.split(" on ")[1].split()[0]
        status, body = _post(url + "/report", pdb)
        assert status == 422 and "matplotlib" in body["error"] and "/report" in body["error"]
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            assert json.loads(r.read())["coalescer"]["requests"] == 0
        status, body = _post(url + "/design", pdb)
        assert status == 200 and len(body["sequence"]) == 76
    finally:
        proc.terminate()
        proc.wait(timeout=30)
