"""PyTorch port, the rank-0 front end: ``td-serve`` and the design app across
ranks (``timed_design_tpu_torch/parallel/frontend.py``), against the JAX
server and app on the JAX package's mesh of virtual CPU devices
(``tests/conftest.py``).

The port's worlds are gloo ranks on the CPU, as ``tests/test_torch_parallel.py``
runs them: port-only child processes (a folder that shadows the JAX
package, jax, flax, optax, h5py and ml_dtypes with packages that refuse to
import comes first on their path, so it reaches the followers that a server
starts too), one thread a rank, and a wall limit of their own (``WALL_S``)
past which every process of the world is killed. The weights are
``tests/test_torch_parallel.py``'s (TIMED at filters (8, 16), a Flax init
with its running statistics moved off 0/1, as the JAX package's
checkpoint), 1ubq, float32, batch 40: two batches of 20 rows a rank.

Tolerances: probabilities 1e-5 (the payload rounds to 1e-6), float32 on
both sides; ``int8`` 1e-5 with equal argmax (``tests/test_torch_quantize.py``'s);
the app's page as ``tests/test_torch_ui.py`` holds it.
"""
import gzip
import json
import os
import re
import signal
import subprocess
import sys
import textwrap
import threading
import time
import types
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_parallel import inputs  # noqa: F401 - a fixture
from tests.test_torch_ui import (  # noqa: F401 - fixtures
    Upload,
    _jax_release,
    _run,
    _sessions,
    assert_same_page,
    f32,
    logos,
)

REPO = Path(__file__).resolve().parent.parent
UBQ = REPO / "tests" / "testing_files" / "1ubq.pdb1.gz"
WALL_S = 240
# the world's and the control group's timeouts in the torchrun worlds: a
# request after an idle stretch longer than both must still be answered
TIMEOUT_S, CONTROL_TIMEOUT_S, IDLE_S = 8.0, 4.0, 10.0
UNIMPORTABLE = ("timed_design_tpu", "jax", "flax", "optax", "h5py", "ml_dtypes")

# torchrun's target: the port's td-serve with the test's timeouts
_SERVE = textwrap.dedent(f'''
    import sys
    import torch
    torch.set_num_threads(1)
    import timed_design_tpu_torch.parallel.distributed as distributed
    import timed_design_tpu_torch.parallel.frontend as frontend
    distributed.TIMEOUT_S, frontend.CONTROL_TIMEOUT_S = {TIMEOUT_S}, {CONTROL_TIMEOUT_S}
    from timed_design_tpu_torch.cli.serve import main
    main(sys.argv[1:])
''')

# rank 0 of a server that starts its followers itself (``start_followers``);
# argv[1]: the followers, "no-python" to give them an interpreter that
# cannot start
_SERVE_FOLLOWERS = textwrap.dedent('''
    import sys
    import torch
    torch.set_num_threads(1)
    from timed_design_tpu_torch.cli.serve import build_parser, serve
    from timed_design_tpu_torch.parallel.frontend import lead
    if sys.argv[1] == "no-python":
        sys.executable = "/bin/false"  # what start_followers launches
        sys.argv[1] = "1"
    args = build_parser().parse_args(sys.argv[2:])
    lead(args.device, lambda front: serve(args, front), followers=int(sys.argv[1]))
''')

# the design app as rank 0 of two (one follower started here), through the
# recording stand-in of tests/test_torch_ui.py; sessions in float32, the
# sequence logo a stub recording its array; the page goes to argv[1]
_APP = textwrap.dedent('''
    import pickle, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from timed_design_tpu_torch.parallel.frontend import shared_front_end
    front = shared_front_end("cpu", followers=1)
    load = front.load
    front.load = lambda model, **kw: load(model, **{**kw, "compute_dtype": "float32"})
    import timed_design_tpu_torch.analyse as analyse
    import timed_design_tpu_torch.ui as ui
    from timed_design_tpu_torch.analyse.plots import pyplot
    from tests.test_torch_ui import Recorder, Upload
    logos = []
    def logo(P):
        logos.append(np.asarray(P, np.float64))
        return pyplot("the test").figure(figsize=(1, 1))
    analyse.create_sequence_logo = logo
    rec = Recorder({"Upload your backbone/PDB of interest": Upload(__import__("pathlib").Path(
        sys.argv[2])), "Choose your Model": sys.argv[3], "Design!": True})
    ui.st = rec
    ui.main(sys.argv[4:])
    with open(sys.argv[1], "wb") as f:
        pickle.dump({"calls": rec.calls, "data": rec.data, "figures": len(rec.figures),
                     "design": list(rec.session_state["design_cache"].values()),
                     "logos": logos, "ranks": front.n_ranks}, f)
''')


# rank 0 of two (one follower started here): 8 threads at once, each
# predicting 6 batches of random frames through one of two sessions, every
# answer held to a one-process predictor of the same weights
_THREADS = textwrap.dedent('''
    import sys
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from timed_design_tpu_torch.engine import DesignSession
    from timed_design_tpu_torch.parallel.frontend import start_followers
    models = sys.argv[1:3]
    front = start_followers(1, "cpu")
    try:
        kw = dict(compute_dtype="float32", batch_size=4)
        over = [front.load(m, **kw).predictor for m in models]
        alone = [DesignSession(m, device="cpu", **kw).predictor for m in models]
        def work(t):
            rng = np.random.default_rng(t)
            worst = 0.0
            for _ in range(6):
                x = rng.random((int(rng.integers(1, 9)), 21, 21, 21, 5), np.float32)
                got = over[t % 2].predict_probs(x)
                worst = max(worst, float(np.abs(got - alone[t % 2].predict_probs(x)).max()))
            return worst
        sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
        with ThreadPoolExecutor(8) as pool:
            print("worst", max(pool.map(work, range(8))))
    finally:
        front.close()
''')


@pytest.fixture(scope="module")
def world_env(tmp_path_factory) -> dict:
    """The child processes' environment: the shadowing folder, then the
    repository, on their path; one thread."""
    block = tmp_path_factory.mktemp("unimportable")
    for name in UNIMPORTABLE:
        (block / name).mkdir()
        (block / name / "__init__.py").write_text(
            f"raise ImportError('{name} is unimportable in the port\\'s processes')\n")
    return dict(os.environ, PYTHONPATH=f"{block}{os.pathsep}{REPO}", OMP_NUM_THREADS="1")


class Server:
    """A server's process group: its output read on a thread, its URL from
    the "Serving ... on http://host:port" line."""

    def __init__(self, cmd: list, cwd: Path, env: dict):
        self.proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True,
                                     start_new_session=True)
        self.lines: list[str] = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        self.deadline = time.monotonic() + WALL_S
        line = self.wait_for(r"Serving .* on http://")
        self.url = re.search(r"(http://[0-9.]+:[0-9]+)", line).group(1)

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)

    @property
    def output(self) -> str:
        return "".join(self.lines)

    def wait_for(self, pattern: str) -> str:
        while time.monotonic() < self.deadline:
            for line in list(self.lines):
                if re.search(pattern, line):
                    return line
            if self.proc.poll() is not None and not self._reader.is_alive():
                pytest.fail(f"the server exited {self.proc.returncode}:\n{self.output[-4000:]}")
            time.sleep(0.1)
        self.kill()
        pytest.fail(f"no {pattern!r} within {WALL_S} s:\n{self.output[-4000:]}")

    def follower_pids(self) -> list[int]:
        return [int(m) for m in re.findall(r"started follower rank \d+ \(pid (\d+)\)",
                                           self.output)]

    def kill(self):
        """SIGTERM to the process group, which torchrun passes on to its
        workers (each runs in a session of its own), then SIGKILL."""
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGTERM)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()

    def post(self, payload: dict) -> tuple[int, dict]:
        req = urllib.request.Request(self.url + "/design", data=json.dumps(payload).encode(),
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:  # a zombie has exited
        return Path(f"/proc/{pid}/stat").read_text().split()[2] != "Z"
    except OSError:
        return False


def _gone_within(pids: list[int], seconds: float) -> bool:
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if not any(_alive(p) for p in pids):
            return True
        time.sleep(0.2)
    return False


@pytest.fixture(scope="module")
def pdb_text() -> str:
    return gzip.decompress(UBQ.read_bytes()).decode()


@pytest.fixture(scope="module")
def models(inputs, tmp_path_factory) -> dict:  # noqa: F811 - the fixture
    """TIMED@init.npz (``tests/test_torch_parallel.py``'s weights) and a
    second 20-class model for the ensemble, OTHER.h5 (the JAX exporter's)."""
    d = tmp_path_factory.mktemp("frontend_models")
    return {"TIMED": f"TIMED@{inputs[0] / 'init.npz'}",
            "OTHER": str(_jax_release(d / "OTHER.h5", 9))}


def _torchrun(world_env, cwd: Path, *serve_args) -> Server:
    script = cwd / "serve.py"
    script.write_text(_SERVE)
    return Server([sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", "2", str(script), "--device", "cpu", "--port", "0",
                   "--compute_dtype", "float32", "--batch_size", "40", *serve_args],
                  cwd, world_env)


@pytest.fixture(scope="module")
def coalescing(world_env, models, tmp_path_factory):
    """``torchrun --nproc_per_node 2`` of td-serve: TIMED and OTHER, the
    ensemble, coalescing with a 300 ms window (so that concurrent requests
    pack)."""
    server = _torchrun(world_env, tmp_path_factory.mktemp("coalescing"),
                       "--model", models["TIMED"], "--model", models["OTHER"], "--ensemble",
                       "--coalesce_window_ms", "300")
    yield server
    server.kill()


@pytest.fixture(scope="module")
def int8(world_env, models, tmp_path_factory):
    """``torchrun --nproc_per_node 2`` of td-serve ``--quantize int8
    --no-coalesce``."""
    server = _torchrun(world_env, tmp_path_factory.mktemp("int8"),
                       "--model", models["TIMED"], "--quantize", "int8", "--no-coalesce")
    yield server
    server.kill()


def _jax_designer(model, quantize=None, serial=False):
    from timed_design_tpu.engine import DesignSession as JaxSession
    from timed_design_tpu.engine.coalescer import CoalescingDesigner, SerialDesigner
    from timed_design_tpu.parallel import make_mesh

    session = JaxSession(model, compute_dtype="float32", batch_size=40, quantize=quantize,
                         mesh=make_mesh(n_data=2))
    return SerialDesigner(session) if serial else CoalescingDesigner(session)


def _jax_probs(designer, pdb_text) -> np.ndarray:
    from timed_design_tpu.cli.serve import _design_payload

    try:
        return np.array(_design_payload(designer, pdb_text)["probabilities"])
    finally:
        designer.close()


@pytest.fixture(scope="module")
def jax_float32(models, pdb_text) -> np.ndarray:
    """The JAX server's /design probabilities of 1ubq over make_mesh(n_data=2)."""
    return _jax_probs(_jax_designer(models["TIMED"]), pdb_text)


def test_two_rank_serve_equals_jax_mesh(coalescing, jax_float32, pdb_text):
    """(1) /design of 1ubq from a two-rank td-serve: the probabilities within
    1e-5 of the JAX server over ``make_mesh(n_data=2)``; Monte-Carlo
    samples drawn on rank 0 after the gather."""
    status, body = coalescing.post({"pdb": pdb_text, "n_samples": 5, "seed": 3})
    assert status == 200, body
    got = np.array(body["probabilities"])
    assert got.shape == jax_float32.shape == (76, 20)
    np.testing.assert_allclose(got, jax_float32, rtol=0, atol=1e-5)
    assert len(body["samples"]) == 5 and body["seed"] == 3
    assert "cpu, 2 ranks" in coalescing.output


def test_concurrent_requests_coalesce_across_ranks(coalescing, models, jax_float32,
                                                 pdb_text):
    """(2) Four concurrent requests to TIMED, packed into shared batches
    across the ranks, while four go to OTHER and two to the ensemble (three
    designers' threads issuing forwards at once): each answer within 1e-5
    of one rank's (the port's one-process DesignSession, float32), TIMED's
    of the JAX server's too."""
    from timed_design_tpu_torch.engine import DesignSession
    from timed_design_tpu_torch.structure import parse_pdb_string

    structure = parse_pdb_string(pdb_text, name="query")[0]
    solo = {name: DesignSession(models[name], compute_dtype="float32", batch_size=40,
                                device="cpu").design(structure)[0] for name in ("TIMED", "OTHER")}
    solo["ensemble"] = ((solo["TIMED"].astype(np.float64) + solo["OTHER"]) / 2).astype(np.float32)
    names = ["TIMED", "OTHER", "ensemble"] * 2 + ["TIMED", "OTHER"] * 2
    with ThreadPoolExecutor(len(names)) as pool:
        answers = list(pool.map(lambda m: coalescing.post({"pdb": pdb_text, "model": m}), names))
    assert all(status == 200 for status, _ in answers), answers
    assert max(b["timings_s"]["group_requests"] for _, b in answers) >= 2
    for name, (_, body) in zip(names, answers):
        got = np.array(body["probabilities"])
        np.testing.assert_allclose(got, solo[name], rtol=0, atol=1e-5, err_msg=name)
        if name == "TIMED":
            np.testing.assert_allclose(got, jax_float32, rtol=0, atol=1e-5)


def test_threads_never_interleave_collectives(world_env, models, tmp_path):
    """Eight threads of rank 0 predicting at once through two sessions of a
    two-rank front end (``start_followers``): every batch's rows reach the
    right rank and session, within 1e-5 of a one-process predictor."""
    script = tmp_path / "threads.py"
    script.write_text(_THREADS)
    proc = subprocess.run([sys.executable, str(script), models["TIMED"], models["OTHER"]],
                          cwd=tmp_path, env=world_env, capture_output=True, text=True,
                          timeout=WALL_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert float(proc.stdout.rsplit("worst ", 1)[1]) <= 1e-5, proc.stdout


def test_int8_serve_equals_jax_mesh(int8, models, pdb_text):
    """(3) ``--quantize int8 --no-coalesce`` over two ranks (the activation
    scale the max over both ranks' rows): argmax equal to the JAX server's
    int8 over ``make_mesh(n_data=2)``, probabilities within 1e-5."""
    import jax

    optimize = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", False)  # JAX's int8 is emulated
    try:
        want = _jax_probs(_jax_designer(models["TIMED"], "int8", serial=True), pdb_text)
    finally:
        jax.config.update("jax_disable_most_optimizations", optimize)
    status, body = int8.post({"pdb": pdb_text})
    assert status == 200, body
    got = np.array(body["probabilities"])
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_ensemble_serve_equals_jax_mesh(coalescing, models, pdb_text):
    """(4) The ensemble of TIMED and OTHER over two ranks against the JAX
    server's ensemble over ``make_mesh(n_data=2)``."""
    from timed_design_tpu.engine.coalescer import EnsembleDesigner

    members = [_jax_designer(models[k]) for k in ("TIMED", "OTHER")]
    try:
        want = _jax_probs(EnsembleDesigner(members), pdb_text)
    finally:
        for m in members:
            m.close()
    status, body = coalescing.post({"pdb": pdb_text, "model": "ensemble"})
    assert status == 200, body
    np.testing.assert_allclose(np.array(body["probabilities"]), want, rtol=0, atol=1e-5)


def test_request_after_idle_past_the_timeouts(coalescing, jax_float32, pdb_text):
    """(5) The world sits idle for longer than its timeout and the control
    group's (rank 0's heartbeat keeps the followers waiting), then answers."""
    time.sleep(IDLE_S)
    status, body = coalescing.post({"pdb": pdb_text})
    assert status == 200, body
    np.testing.assert_allclose(np.array(body["probabilities"]), jax_float32, rtol=0, atol=1e-5)


def _started(world_env, tmp_path, *serve_args, followers="1") -> Server:
    script = tmp_path / "serve.py"
    script.write_text(_SERVE_FOLLOWERS)
    return Server([sys.executable, str(script), followers, "--device", "cpu", "--port", "0",
                   "--compute_dtype", "float32", "--batch_size", "40", *serve_args],
                  tmp_path, world_env)


def test_start_followers_serves_as_torchrun(world_env, models, jax_float32, pdb_text,
                                            tmp_path):
    """(7) td-serve with no launcher, one follower started by
    ``start_followers``: the same answer as the JAX server over two
    devices; a registry model with random weights (ProDCoNN) answers as a
    one-process server does, so both ranks hold the same weights. (6) After
    the server closes (SIGINT), no follower is alive within 10 s."""
    from timed_design_tpu_torch.engine import DesignSession

    server = _started(world_env, tmp_path, "--model", models["TIMED"], "--model",
                      "ProDCoNN", "--allow-random-weights")
    try:
        (pid,) = server.follower_pids()
        status, body = server.post({"pdb": pdb_text})
        assert status == 200, body
        np.testing.assert_allclose(np.array(body["probabilities"]), jax_float32, rtol=0,
                                   atol=1e-5)
        status, body = server.post({"pdb": pdb_text, "model": "ProDCoNN"})
        assert status == 200, body
        one = DesignSession("ProDCoNN", compute_dtype="float32", batch_size=40, device="cpu",
                            allow_random_weights=True).design(UBQ)[0]
        np.testing.assert_allclose(np.array(body["probabilities"]), one, rtol=0, atol=1e-5)
        server.proc.send_signal(signal.SIGINT)
        assert server.proc.wait(timeout=60) == 0, server.output[-3000:]
        assert _gone_within([pid], 10), "a follower outlived its server"
    finally:
        server.kill()


def test_followers_exit_when_rank_0_is_killed(world_env, models, pdb_text, tmp_path):
    """(6) Rank 0 killed (SIGKILL, no STOP sent): its follower leaves within
    10 s."""
    server = _started(world_env, tmp_path, "--model", models["TIMED"])
    try:
        (pid,) = server.follower_pids()
        assert server.post({"pdb": pdb_text})[0] == 200
        os.kill(server.proc.pid, signal.SIGKILL)
        server.proc.wait()
        assert _gone_within([pid], 10), "a follower outlived rank 0"
    finally:
        if server.follower_pids() and _alive(server.follower_pids()[0]):
            os.kill(server.follower_pids()[0], signal.SIGKILL)


def test_a_follower_that_cannot_start_fails_the_server(world_env, models, tmp_path):
    """No fallback: a follower whose interpreter cannot start makes td-serve
    exit non-zero, naming it, instead of serving on one rank."""
    script = tmp_path / "serve.py"
    script.write_text(_SERVE_FOLLOWERS)
    proc = subprocess.run([sys.executable, str(script), "no-python", "--device", "cpu",
                           "--port", "0", "--model", models["TIMED"]],
                          cwd=tmp_path, env=world_env, capture_output=True, text=True,
                          timeout=WALL_S)
    assert proc.returncode != 0
    assert "follower rank 1 exited with code 1 before it joined the world" in proc.stderr
    assert "Serving" not in proc.stdout


def test_app_over_two_ranks_equals_jax_app(monkeypatch, tmp_path, world_env, f32,  # noqa: F811
                                           logos):  # noqa: F811 - the fixtures
    """(8) The design app as rank 0 of two ranks (its follower started by
    ``shared_front_end``), the page of 1ubq with TIMED.h5, against the JAX
    app on its mesh (the 8 virtual devices): the same page, the
    probabilities and the logo's array within 1e-5."""
    import pickle

    import timed_design_tpu.ui as jax_ui

    models_dir = tmp_path / "models"
    models_dir.mkdir()
    _jax_release(models_dir / "TIMED.h5", 0)
    argv = ["--path_to_models", str(models_dir), "--batch_size", "80"]
    script, out = tmp_path / "app.py", tmp_path / "page.pkl"
    script.write_text(_APP)
    proc = subprocess.run([sys.executable, str(script), str(out), str(UBQ), "TIMED", *argv,
                           "--device", "cpu"], cwd=tmp_path, env=world_env,
                          capture_output=True, text=True, timeout=WALL_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    page = pickle.loads(out.read_bytes())
    assert page["ranks"] == 2
    port = types.SimpleNamespace(calls=page["calls"], data=page["data"],
                                 figures=[None] * page["figures"])
    responses = {"Upload your backbone/PDB of interest": Upload(UBQ),
                 "Choose your Model": "TIMED", "Design!": True}
    ref = _run(monkeypatch, jax_ui, responses, argv)
    assert "error" not in [k for k, _ in port.calls]
    assert_same_page(ref, port)
    ((got,), native, rmap), = page["design"]
    ((want,), want_native, want_rmap), = ref.session_state["design_cache"].values()
    assert got.shape == (76, 20)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (native, rmap) == (want_native, want_rmap)
    for got_logo, want_logo in zip(page["logos"], logos["jax"], strict=True):
        np.testing.assert_allclose(got_logo, want_logo, atol=1e-5)
