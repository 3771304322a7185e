"""PyTorch port, the slice as a whole: DesignSession and the HTTP design
service against the JAX package, on a checkpoint written by the JAX trainer.

float32 on both sides: probabilities agree to atol 1e-5 (voxelizer and
convolutions summed in another order). Sample metrics agree with the JAX
``sequence_metrics`` of each returned sequence to 1e-4 relative, within
the payload's rounding.
"""
import gzip
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


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several workers per host
    yield
    torch.set_num_threads(n)


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
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serve")
    return {
        "TIMED": _write_checkpoint(d / "timed.npz", 20, 0),
        "TIMED_rotamer": _write_checkpoint(d / "rot.npz", 338, 1),
        "TIMED_rotamer_balanced": _write_checkpoint(d / "balanced.npz", 338, 2),
    }


@pytest.fixture(scope="module")
def pdb_text(ubq_pdb_gz):
    return gzip.decompress(ubq_pdb_gz.read_bytes()).decode()


@pytest.fixture(scope="module")
def server_url(ckpts):
    from timed_design_tpu_torch.cli.serve import build_designers, build_parser, make_server

    args = build_parser().parse_args([
        "--model", f"TIMED@{ckpts['TIMED']}",
        "--model", f"TIMED_rotamer@{ckpts['TIMED_rotamer']}",
        "--compute_dtype", "float32", "--batch_size", "80", "--device", "cpu",
    ])
    designers = build_designers(args)
    server = make_server(designers["TIMED"], "127.0.0.1", 0, "TIMED",
                         extra_designers={"TIMED_rotamer": designers["TIMED_rotamer"]})
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    for d in designers.values():
        d.close()
    th.join(timeout=10)


def _post(url, data: bytes):
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_design_session_matches_jax(ckpts, ubq_pdb_gz):
    from timed_design_tpu.engine import DesignSession as JaxSession

    from timed_design_tpu_torch.engine import DesignSession

    for name in ("TIMED", "TIMED_rotamer"):
        model = f"{name}@{ckpts[name]}"
        want, wfa = JaxSession(model, compute_dtype="float32", batch_size=64).design(ubq_pdb_gz)
        s = DesignSession(model, compute_dtype="float32", batch_size=64, device="cpu")
        got, fa = s.design(ubq_pdb_gz)
        assert s.device.type == "cpu" and set(s.last_timings) == {"voxelisation", "prediction"}
        assert got.shape == want.shape and fa.residue_ids == wfa.residue_ids
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
        np.testing.assert_array_equal(got.argmax(1), np.asarray(want).argmax(1))


def test_serve_quantize_int8_matches_jax(ckpts, pdb_text, ubq_pdb_gz):
    """``td-serve --quantize int8 --device cpu --no-coalesce`` builds its
    designer, and ``/design`` on 1ubq agrees with the JAX package's
    ``DesignSession(quantize="int8")``, float32, batch 80 in both (without
    coalescing: a group's requests share the activation scale, in both
    packages)."""
    from timed_design_tpu.engine import DesignSession as JaxSession

    from timed_design_tpu_torch.cli.serve import build_designers, build_parser, make_server

    model = f"TIMED@{ckpts['TIMED']}"
    designers = build_designers(build_parser().parse_args([
        "--model", model, "--quantize", "int8", "--no-coalesce", "--compute_dtype", "float32",
        "--batch_size", "80", "--device", "cpu"]))
    server = make_server(designers["TIMED"], "127.0.0.1", 0, "TIMED")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        status, body = _post(f"http://127.0.0.1:{server.server_address[1]}/design",
                             pdb_text.encode())
    finally:
        server.shutdown()
        server.server_close()
        designers["TIMED"].close()
        th.join(timeout=10)
    assert status == 200 and designers["TIMED"].session.predictor.quantize == "int8"
    want, _ = JaxSession(model, compute_dtype="float32", batch_size=80,
                         quantize="int8").design(ubq_pdb_gz)
    got = np.array(body["probabilities"])
    assert got.shape == (76, 20)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(got.argmax(1), np.asarray(want).argmax(1))
    unquantized, _ = JaxSession(model, compute_dtype="float32", batch_size=80).design(ubq_pdb_gz)
    assert np.abs(got - np.asarray(unquantized)).max() > 1e-5


def test_predict_structure_caches_predictors(ckpts, ubq_pdb_gz):
    from timed_design_tpu_torch.engine import predictor as P

    model = f"TIMED@{ckpts['TIMED']}"
    a, fa = P.predict_structure(ubq_pdb_gz, model, batch_size=32, device="cpu")
    b, _ = P.predict_structure(ubq_pdb_gz, model, batch_size=32, device="cpu")
    assert a.shape == (76, 20) and len(fa.labels) == 76
    np.testing.assert_array_equal(a, b)
    assert sum(k[0][1] == model for k in P._STRUCTURE_PREDICTOR_CACHE) == 1


def test_healthz(server_url):
    with urllib.request.urlopen(server_url + "/healthz", timeout=60) as r:
        body = json.loads(r.read())
    assert body["status"] == "ok" and body["model"] == "TIMED"
    assert body["models"] == {"TIMED": 20, "TIMED_rotamer": 338}
    assert body["device"] == "cpu"


def test_design_samples_match_jax_metrics(server_url, pdb_text):
    from timed_design_tpu.sample.metrics import sequence_metrics as jax_seq_metrics

    req = {"pdb": pdb_text, "n_samples": 12, "temperature": 0.5, "seed": 1234}
    status, a = _post(server_url + "/design", json.dumps(req).encode())
    assert status == 200 and a["seed"] == 1234 and a["n_residues"] == 76
    np.testing.assert_allclose(np.array(a["probabilities"]).sum(1), 1.0, atol=1e-3)
    assert len(a["samples"]) == 12
    for s in a["samples"]:
        assert len(s["sequence"]) == 76
        want = jax_seq_metrics(s["sequence"])
        got = (s["charge"], s["isoelectric_point"], s["molecular_weight"], s["molar_extinction"])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.05)  # payload rounds
    _, b = _post(server_url + "/design", json.dumps(req).encode())
    assert [s["sequence"] for s in a["samples"]] == [s["sequence"] for s in b["samples"]]
    del req["seed"]
    _, c = _post(server_url + "/design", json.dumps(req).encode())
    _, d = _post(server_url + "/design", json.dumps(req).encode())
    assert c["seed"] != d["seed"]
    assert [s["sequence"] for s in c["samples"]] != [s["sequence"] for s in d["samples"]]


def test_design_rotamer_model_and_raw_pdb(server_url, pdb_text):
    status, body = _post(server_url + "/design", json.dumps(
        {"pdb": pdb_text, "model": "TIMED_rotamer", "n_samples": 3, "seed": 5}).encode())
    assert status == 200 and body["rotamer_head"] is True
    assert len(body["probabilities"][0]) == 20 and len(body["samples"]) == 3
    assert {"parse", "voxelisation", "prediction", "sampling"} <= set(body["timings_s"])
    status, body = _post(server_url + "/design", pdb_text.encode())
    assert status == 200 and "samples" not in body
    assert body["residues"][0] == "A1" and "voxelisation" in body["timings_s"]
    assert "parse" in body["timings_s"] and "sampling" not in body["timings_s"]


@pytest.mark.parametrize("payload,code", [
    (b'{"broken": true}', 400),
    (b"[1, 2]", 400),
    (b'{"pdb": null}', 400),
    (b'{"pdb": "x", "n_samples": "many"}', 400),
    (b'{"pdb": "x", "n_samples": 1e400}', 400),
    (b'{"pdb": "x", "n_samples": 10001}', 400),
    (b'{"pdb": "x", "temperature": -1}', 400),
    (b'{"pdb": "x", "model": "NOPE"}', 400),
    (b'{"pdb": "x", "model": ""}', 400),
    (b'{"pdb": "x", "model": 7}', 400),
    (b"not a pdb at all", 422),
    (b"\x1f\x8b\x08binary", 400),
])
def test_design_bad_inputs(server_url, payload, code):
    status, body = _post(server_url + "/design", payload)
    assert status == code and "error" in body


def test_unknown_paths(server_url, pdb_text):
    """/report, ported, answers 200 with the HTML design report; an unknown
    path answers 404."""
    req = urllib.request.Request(server_url + "/report", data=pdb_text.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.status == 200 and r.headers["Content-Type"].startswith("text/html")
        doc = r.read().decode()
    assert "<h2>queryA</h2>" in doc and doc.count("data:image/png;base64,") == 3
    status, _ = _post(server_url + "/nope", b"x")
    assert status == 404


def test_metrics_endpoint(server_url, pdb_text):
    assert _post(server_url + "/design", pdb_text.encode())[0] == 200
    assert _post(server_url + "/design", b'{"pdb": 5}')[0] == 400
    with urllib.request.urlopen(server_url + "/metrics", timeout=60) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    lines = text.splitlines()
    ok = [l for l in lines if l.startswith('td_requests_total{endpoint="/design",status="200"}')]
    assert ok and int(ok[0].split()[-1]) >= 1
    assert 'td_requests_total{endpoint="/design",status="400"}' in text
    inf = [l for l in lines if l.startswith('td_request_duration_seconds_bucket{endpoint="/design",le="+Inf"}')]
    cnt = [l for l in lines if l.startswith('td_request_duration_seconds_count{endpoint="/design"}')]
    assert inf[0].split()[-1] == cnt[0].split()[-1]
    assert 'td_model_n_classes{model="TIMED_rotamer"} 338' in text
    assert 'td_coalescer_stat{model="TIMED",stat="requests"}' in text


def test_coalescer_packs_requests_like_solo_runs(ckpts, ubq_pdb_gz):
    """Requests packed into one buffer get the rows a solo run gives."""
    from timed_design_tpu_torch.engine import DesignSession
    from timed_design_tpu_torch.engine.coalescer import CoalescingDesigner
    from timed_design_tpu_torch.structure import load_pdb

    session = DesignSession(f"TIMED@{ckpts['TIMED']}", compute_dtype="float32", batch_size=32,
                            device="cpu")
    s = load_pdb(ubq_pdb_gz)
    parts = [session.voxelize(s)[0][:n] for n in (76, 30, 5)]
    d = CoalescingDesigner(session, window_ms=300)
    try:
        futs = [d.submit_frames(p, None) for p in parts]
        results = [f.result(timeout=120) for f in futs]
    finally:
        d.close()
    assert d.stats["max_group_requests"] == 3 and d.stats["groups"] == 1
    for p, (probs, _, timings) in zip(parts, results):
        assert timings["group_residues"] == 111
        np.testing.assert_allclose(probs, session.predictor.predict_probs(p), atol=1e-6)


def test_serial_and_ensemble_designers(ckpts, ubq_pdb_gz):
    from timed_design_tpu_torch.cli.serve import build_designers, build_parser
    from timed_design_tpu_torch.structure import load_pdb

    args = build_parser().parse_args([
        "--model", f"TIMED_rotamer@{ckpts['TIMED_rotamer']}",
        "--model", f"TIMED_rotamer_balanced@{ckpts['TIMED_rotamer_balanced']}",
        "--compute_dtype", "float32", "--batch_size", "80", "--no-coalesce", "--ensemble",
        "--device", "cpu",
    ])
    designers = build_designers(args)
    s = load_pdb(ubq_pdb_gz)
    members = [designers[k].design(s)[0] for k in ("TIMED_rotamer", "TIMED_rotamer_balanced")]
    probs, fa, timings = designers["ensemble"].design(s)
    assert timings["ensemble_members"] == 2 and len(fa.labels) == 76
    np.testing.assert_allclose(probs, (members[0] + members[1]) / 2, atol=1e-6)
    quantized = build_designers(build_parser().parse_args([
        "--model", f"TIMED_rotamer@{ckpts['TIMED_rotamer']}", "--quantize", "w8",
        "--compute_dtype", "float32", "--batch_size", "80", "--device", "cpu"]))
    try:
        assert quantized["TIMED_rotamer"].session.predictor.quantize == "w8"
        q = quantized["TIMED_rotamer"].design(s)[0]
    finally:
        quantized["TIMED_rotamer"].close()
    assert 0 < np.abs(q - members[0]).max() < 2e-3


_HYGIENE = """
import sys
for name in ("timed_design_tpu", "jax", "flax", "optax", "h5py", "ml_dtypes", "matplotlib"):
    sys.modules[name] = None  # any import of these now raises ImportError
import runpy
sys.argv = ["serve", "--model", sys.argv[1], "--port", "0", "--batch_size", "80",
            "--device", "cpu"]
runpy.run_module("timed_design_tpu_torch.cli.serve", run_name="__main__")
"""


def test_serving_path_imports_no_jax(ckpts, pdb_text):
    """The server starts and answers /design with the JAX package, jax,
    flax, optax, h5py, ml_dtypes and matplotlib unimportable, as on a
    machine without them."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", _HYGIENE, f"TIMED@{ckpts['TIMED']}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO,
    )
    try:
        line = ""
        for line in proc.stdout:
            if line.startswith("Serving"):
                break
        assert line.startswith("Serving"), line
        url = line.split(" on ")[1].split()[0]
        status, body = _post(url + "/design", json.dumps(
            {"pdb": pdb_text, "n_samples": 2, "seed": 3}).encode())
        assert status == 200 and len(body["samples"]) == 2
    finally:
        proc.terminate()
        proc.wait(timeout=30)


_TRAIN_HYGIENE = """
import sys
for name in ("timed_design_tpu", "jax", "flax", "optax", "h5py", "ml_dtypes", "matplotlib"):
    sys.modules[name] = None  # any import of these now raises ImportError
import torch
from timed_design_tpu_torch.models import TIMED
from timed_design_tpu_torch.train import fit, load_checkpoint_params, save_checkpoint
from timed_design_tpu_torch.voxel import FrameBatchSource, create_flat_dataset_map, make_frame_set

fs = make_frame_set([sys.argv[1]])
source = FrameBatchSource(fs, create_flat_dataset_map(fs), 40, device="cpu", shuffle=True)
torch.manual_seed(0)
state = fit(TIMED(filters=(4,)), source, n_classes=20, log_every=1, device="cpu")
save_checkpoint(state, sys.argv[2], build_kwargs={"filters": (4,)})
print("trained", state.step, "steps;", len(load_checkpoint_params(sys.argv[2])["params"]), "leaves")
"""


def test_training_path_imports_no_jax(tmp_path, ubq_pdb_gz):
    """Two steps of the port's fit over 1ubq's frames (shuffled, batch 40)
    and its npz checkpoint, with the JAX package, jax, flax, optax, h5py,
    ml_dtypes and matplotlib unimportable."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _TRAIN_HYGIENE, str(ubq_pdb_gz), str(tmp_path / "ckpt.npz")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "step 1: loss=" in proc.stdout and "trained 2 steps; 2 leaves" in proc.stdout


def test_default_device_is_the_card():
    """No silent CPU fallback: the default device is CUDA, and without a
    card asking for it raises."""
    from timed_design_tpu_torch.engine.predictor import default_device

    if torch.cuda.is_available():
        assert default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            default_device()


def test_serve_needs_a_card_unless_told_cpu(ckpts):
    """td-serve without --device cpu on a machine with no card exits
    non-zero with a message; with --device cpu it builds its designers."""
    from timed_design_tpu_torch.cli.serve import build_designers, build_parser

    model = f"TIMED@{ckpts['TIMED']}"
    if not torch.cuda.is_available():
        env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
        proc = subprocess.run(
            [sys.executable, "-m", "timed_design_tpu_torch.cli.serve", "--model", model,
             "--port", "0"], capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
        assert proc.returncode != 0 and "--device cpu" in proc.stderr
    args = build_parser().parse_args(["--model", model, "--device", "cpu", "--no-coalesce"])
    assert build_parser().parse_args(["--model", model]).device == "cuda"
    designers = build_designers(args)
    assert designers["TIMED"].session.device == torch.device("cpu")


def test_design_with_a_prodconn_checkpoint_matches_jax(tmp_path, pdb_text, ubq_pdb_gz):
    """``/design`` served from a ProDCoNN checkpoint written by the JAX
    trainer, on the CPU in float32: the JAX package's probabilities to 1e-5
    (the payload rounds to 6 decimals), its argmax sequence, and samples."""
    import jax

    from timed_design_tpu.engine import DesignSession as JaxSession
    from timed_design_tpu.models import prodconn
    from timed_design_tpu.train.train import save_checkpoint

    from timed_design_tpu_torch.cli.serve import build_designers, build_parser, make_server

    v = prodconn().init(jax.random.key(4), np.zeros((1, 21, 21, 21, 5), np.float32))
    ckpt = tmp_path / "prodconn.npz"
    save_checkpoint(types.SimpleNamespace(params=v["params"], batch_stats={}), ckpt)
    want, _ = JaxSession(f"ProDCoNN@{ckpt}", compute_dtype="float32", batch_size=80).design(
        ubq_pdb_gz)
    args = build_parser().parse_args([
        "--model", f"ProDCoNN@{ckpt}", "--compute_dtype", "float32", "--batch_size", "80",
        "--device", "cpu", "--no-coalesce"])
    designers = build_designers(args)
    server = make_server(designers["ProDCoNN"], "127.0.0.1", 0, "ProDCoNN")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        status, body = _post(f"http://127.0.0.1:{server.server_address[1]}/design", json.dumps(
            {"pdb": pdb_text, "n_samples": 4, "seed": 2}).encode())
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)
    assert status == 200 and body["model"] == "ProDCoNN" and body["rotamer_head"] is False
    got = np.array(body["probabilities"])
    assert got.shape == (76, 20)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    assert body["sequence"] == "".join(np.array(list("ACDEFGHIKLMNPQRSTVWY"))[np.asarray(want).argmax(1)])
    assert len(body["samples"]) == 4 and all(len(s["sequence"]) == 76 for s in body["samples"])
