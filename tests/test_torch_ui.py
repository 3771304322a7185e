"""PyTorch port, the Streamlit design app: ``timed_design_tpu_torch/ui.py``
against ``timed_design_tpu/ui.py`` on the CPU.

Neither machine has streamlit, so both apps are driven by one recording
stand-in (``Recorder``): the same widget answers, the same ``.h5`` files
(written by the JAX package's exporter) in one ``--path_to_models``, the port
with ``--device cpu``. Each flow must draw the same page: the same calls in
the same order, the same labels, the same chart data, metrics, download and
Monte-Carlo table. The departures are the page title (each names its own
target) and the design time in the success line.

Tolerances: probabilities in float32 (both packages' ``DesignSession``
patched to float32) within 1e-5, the designed sequence equal; in bfloat16,
the packages' default, argmax agreement >= 0.95 (cuDNN/oneDNN and XLA sum
in other orders); sequence metrics 1e-4 relative. The Monte-Carlo draws are
not compared (Philox against threefry): both apps get the one sample list
that the port's sampler drew, and must rank it into the same table. The
sequence logo takes seconds of matplotlib per page, so the flows record the
array each app gives it (within 1e-5) and draw a stub; the figures
themselves are compared pixel for pixel where both apps draw them from the
same arrays (``test_figures_pixel_for_pixel``).

Subprocesses drive the port's app as ``streamlit run`` runs a script, with
a stub ``streamlit`` package and with the JAX package, jax, flax, h5py,
ml_dtypes, pandas and matplotlib unimportable, as on the card's machine.
"""
import functools
import http.server
import json
import os
import shutil
import subprocess
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
UBQ = REPO / "tests" / "testing_files" / "1ubq.pdb1.gz"
UPLOAD = "Upload your backbone/PDB of interest"
BATCH = "80"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several workers per host
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the stand-in

class _Ctx:
    """Context manager returned by layout elements; attribute calls go to
    the recorder (``col.metric(...)``)."""

    def __init__(self, st):
        self._st = st

    def __enter__(self):
        return self._st

    def __exit__(self, *a):
        return False

    def __getattr__(self, name):
        return getattr(self._st, name)


class Upload:
    def __init__(self, path: Path):
        self.name = path.name
        self._data = path.read_bytes()

    def read(self):
        return self._data


def _columns(data, x=None) -> tuple:
    """A chart's data as (row labels or None, {column: float64 values}),
    whether it came as a DataFrame, a Series, an array or a dict of columns
    with ``x`` naming the label column. Where pandas is installed the data
    must build a DataFrame, as streamlit builds one from it."""
    try:
        import pandas as pd
    except ImportError:
        pd = None
    if pd is not None:
        frame = pd.DataFrame(data)
        if x is not None:
            frame.set_index(x)
    if isinstance(data, dict):
        index = list(map(str, data[x])) if x is not None else None
        return index, {k: np.asarray(v, np.float64) for k, v in data.items() if k != x}
    if hasattr(data, "to_frame"):  # a Series
        data = data.to_frame()
    if hasattr(data, "columns"):  # a DataFrame
        return ([str(i) for i in data.index],
                {str(c): data[c].to_numpy(np.float64) for c in data.columns})
    return None, {"": np.asarray(data, np.float64)}


class Recorder:
    """streamlit's API as the apps use it. Widgets answer from ``responses``
    (else their default); every call is recorded as (kind, its text label or
    None), and the data behind charts, metrics, tables, writes and the
    download, and the figures passed to ``pyplot``, are kept."""

    def __init__(self, responses, session_state=None):
        self.responses = dict(responses)
        self.session_state = {} if session_state is None else session_state
        self.calls = []
        self.data = []
        self.figures = []
        self.sidebar = _Ctx(self)
        self.components = types.SimpleNamespace(
            v1=types.SimpleNamespace(html=lambda *a, **k: self._record("html")))

    def _record(self, kind, label=None, payload=None):
        self.calls.append((kind, label if isinstance(label, str) else None))
        if payload is not None:
            self.data.append((kind, payload))

    def _widget(self, kind, label, default):
        self._record(kind, label)
        return self.responses.get(label, default)

    def text_input(self, label, value="", **k):
        return self._widget("text_input", label, value)

    def file_uploader(self, label, **k):
        return self._widget("file_uploader", label, None)

    def selectbox(self, label, options, **k):
        v = self._widget("selectbox", label, list(options)[0])
        assert v in list(options), (v, list(options))
        return v

    def multiselect(self, label, options, default=None, **k):
        v = self._widget("multiselect", label, default or [])
        assert set(v) <= set(options), (v, options)
        return v

    def checkbox(self, label, value=False, **k):
        return self._widget("checkbox", label, value)

    def number_input(self, label, mn=None, mx=None, value=None, **k):
        return self._widget("number_input", label, value)

    def slider(self, label, mn=None, mx=None, value=None, **k):
        return self._widget("slider", label, value)

    def button(self, label, **k):
        return self._widget("button", label, False)

    def bar_chart(self, data=None, x=None, **k):
        self._record("bar_chart", payload=_columns(data, x))

    def line_chart(self, data=None, x=None, **k):
        self._record("line_chart", payload=_columns(data, x))

    def pyplot(self, fig=None, **k):
        self._record("pyplot")
        self.figures.append(fig)

    def download_button(self, label, data, file_name=None, **k):
        self._record("download_button", label, (file_name, data))

    def metric(self, label, value, delta=None, **k):
        self._record("metric", label, (label, value, delta))

    def dataframe(self, data, **k):
        self._record("dataframe", payload=dict(data))

    def write(self, obj, **k):
        self._record("write", obj, None if isinstance(obj, str) else obj)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)

        def fn(*args, **kwargs):
            self._record(name, args[0] if args else None)
            if name == "columns":
                return [_Ctx(self) for _ in range(args[0])]
            if name == "tabs":
                return [_Ctx(self) for _ in args[0]]
            return _Ctx(self)

        return fn

    def kinds(self):
        return [k for k, _ in self.calls]

    def texts(self, kind):
        return [a for k, a in self.calls if k == kind]

    def payloads(self, kind):
        return [p for k, p in self.data if k == kind]


def _page(rec) -> list:
    """The page's calls with the two listed departures folded: the title
    names each package's target, the success line carries a wall time."""
    out = []
    for kind, label in rec.calls:
        if kind == "title" and label and label.startswith("TIMED-Design"):
            label = "TIMED-Design"
        elif kind == "success":
            label = label.split(" in ")[0]
        out.append((kind, label))
    return out


def _csv_rows(text: str) -> np.ndarray:
    return np.array([[float(v) for v in row.split(",")] for row in text.split("\n")])


def assert_same_page(ref, port, atol=1e-5):
    """The same calls in the same order, and the same data behind them:
    chart values and the download's probabilities within ``atol``, sequence
    metrics as displayed, the performance numbers and the Monte-Carlo table
    (1e-5 relative)."""
    assert _page(port) == _page(ref)
    assert len(port.data) == len(ref.data)
    for (kind, got), (_, want) in zip(port.data, ref.data):
        if kind in ("bar_chart", "line_chart"):
            assert got[0] == want[0] and got[1].keys() == want[1].keys()
            tol = 1e-4 if kind == "line_chart" else atol  # entropy: 20 terms of p log2 p
            for k in got[1]:
                np.testing.assert_allclose(got[1][k], want[1][k], rtol=0, atol=tol)
        elif kind == "download_button":
            assert got[0] == want[0]
            np.testing.assert_allclose(_csv_rows(got[1]), _csv_rows(want[1]), atol=atol + 1e-6)
        elif kind == "metric":
            assert got == want
        elif kind == "write":
            assert got.keys() == want.keys()
            np.testing.assert_allclose([got[k] for k in got], [want[k] for k in want],
                                       rtol=1e-12)
        elif kind == "dataframe":
            assert got.keys() == want.keys() and got["sequence"] == want["sequence"]
            for k in ("charge", "pI", "MW", "MAE"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
        else:
            raise AssertionError(f"unexpected payload of {kind}")
    assert len(port.figures) == len(ref.figures)


# ----------------------------------------------------------------- fixtures

def _jax_release(path: Path, key: int, n_classes=20, channels=5) -> Path:
    import jax

    from timed_design_tpu.models import export_timed_to_h5, timed

    module = timed(n_classes=n_classes, filters=(8,))
    variables = module.init(jax.random.key(key), np.zeros((1, 21, 21, 21, channels), np.float32))
    return export_timed_to_h5(variables["params"], variables["batch_stats"], path,
                              n_classes=n_classes, input_channels=channels)


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory):
    """Tiny TIMED-shaped release files (filters (8,)) written by the JAX
    package's exporter: TIMED, a second 20-class model, TIMED_rotamer and
    the 6-channel TIMED_Charge."""
    d = tmp_path_factory.mktemp("models")
    _jax_release(d / "TIMED.h5", 0)
    _jax_release(d / "OTHER.h5", 9)
    _jax_release(d / "TIMED_rotamer.h5", 1, n_classes=338)
    _jax_release(d / "TIMED_Charge.h5", 2, channels=6)
    return d


@pytest.fixture(scope="module")
def _sessions():
    return {}


@pytest.fixture
def f32(monkeypatch, _sessions):
    """Both packages' ``DesignSession`` built in float32, each built once
    for the module (streamlit keeps a session's objects across reruns; a
    new JAX session would compile again). Records the keywords the port's
    app passes."""
    import timed_design_tpu.engine as jax_engine

    import timed_design_tpu_torch.engine as port_engine

    passed = []

    def factory(pkg, cls):
        def make(model, **kw):
            if pkg == "port":
                passed.append(kw)
            key = (pkg, str(model), tuple(sorted((k, str(v)) for k, v in kw.items())))
            if key not in _sessions:
                _sessions[key] = cls(model, compute_dtype="float32", **kw)
            return _sessions[key]
        return make

    monkeypatch.setattr(jax_engine, "DesignSession", factory("jax", jax_engine.DesignSession))
    monkeypatch.setattr(port_engine, "DesignSession", factory("port", port_engine.DesignSession))
    return passed


@pytest.fixture
def logos(monkeypatch):
    """Both apps' sequence logo replaced by a stub that records the array
    it was given."""
    import timed_design_tpu.analyse as jax_analyse

    import timed_design_tpu_torch.analyse as port_analyse
    from timed_design_tpu_torch.analyse.plots import pyplot

    drawn = {"jax": [], "port": []}

    def stub(pkg):
        def draw(P):
            drawn[pkg].append(np.asarray(P, np.float64))
            return pyplot("the test").figure(figsize=(1, 1))
        return draw

    monkeypatch.setattr(jax_analyse, "create_sequence_logo", stub("jax"))
    monkeypatch.setattr(port_analyse, "create_sequence_logo", stub("port"))
    return drawn


@pytest.fixture
def samples(monkeypatch):
    """The port's app draws with its own sampler (recorded); the JAX app's
    ``sample_structure`` returns that same list (its tempered input
    recorded)."""
    import timed_design_tpu.sample.sampler as jax_sampler

    import timed_design_tpu_torch.sample.sampler as port_sampler

    real = port_sampler.sample_structure
    drawn = {}

    def port_sample(probs, n, seed, **kw):
        drawn["port"] = (np.array(probs), n, seed, kw)
        drawn["samples"] = real(probs, n, seed, **kw)
        return drawn["samples"]

    def jax_sample(probs, n, key, rotamer_mode=False, **kw):
        drawn["jax"] = (np.asarray(probs), n, rotamer_mode)
        return drawn["samples"]

    monkeypatch.setattr(port_sampler, "sample_structure", port_sample)
    monkeypatch.setattr(jax_sampler, "sample_structure", jax_sample)
    return drawn


def _run(monkeypatch, module, responses, argv, state=None):
    rec = Recorder(responses, state)
    monkeypatch.setattr(module, "st", rec)
    module.main(list(argv))
    return rec


def _run_both(monkeypatch, responses, argv, states=(None, None)):
    """(the JAX app's page, the port's page), the port with --device cpu."""
    import timed_design_tpu.ui as jax_ui

    import timed_design_tpu_torch.ui as ui

    port = _run(monkeypatch, ui, responses, [*argv, "--device", "cpu"], states[1])
    ref = _run(monkeypatch, jax_ui, responses, argv, states[0])
    return ref, port


def _design(rec):
    """The cached design: (per-state probabilities, native sequence, map)."""
    (entry,) = rec.session_state["design_cache"].values()
    return entry


def _argv(models_dir, *more):
    return ["--path_to_models", str(models_dir), "--batch_size", BATCH, *more]


def _base(model="TIMED", **more):
    return {UPLOAD: Upload(UBQ), "Choose your Model": model, "Design!": True, **more}


# ------------------------------------------------------------------- flows

def test_idle_prompt(monkeypatch):
    ref, port = _run_both(monkeypatch, {}, [])
    assert port.texts("info") == ["Upload a backbone (or give a PDB code) and press Design!"]
    assert_same_page(ref, port)


@pytest.mark.parametrize("model", ["TIMED", "TIMED_rotamer"])
def test_full_design_flow(monkeypatch, models_dir, f32, logos, samples, model):
    """Upload, design, every section, Monte-Carlo on: the same page; the
    probabilities within 1e-5 and the designed sequence equal; the table is
    the port's draws ranked by summed normalised MAE, top 25."""
    from timed_design_tpu.sample.metrics import sequence_metrics as jax_metrics

    from timed_design_tpu_torch.constants import AA1, compress_rotamer_probs
    from timed_design_tpu_torch.sample.metrics import sequence_metrics
    from timed_design_tpu_torch.sample.sampler import apply_temperature

    responses = _base(model, **{"Optimize sequences using Monte Carlo": True,
                                "Number of samples": 40, "Temperature": 0.5})
    ref, port = _run_both(monkeypatch, responses, _argv(models_dir))
    assert "warning" not in port.kinds() and "error" not in port.kinds()
    assert all(kw["device"] == torch.device("cpu") for kw in f32)
    assert_same_page(ref, port)
    (got,), native, rmap = _design(port)
    (want,), want_native, want_rmap = _design(ref)
    assert got.dtype == np.float32 and got.shape == (76, 338 if "rot" in model else 20)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (native, rmap) == (want_native, want_rmap)
    probs20 = compress_rotamer_probs(got) if got.shape[1] == 338 else got
    designed = "".join(np.array(list(AA1))[probs20.argmax(1)])
    assert port.texts("code")[0] == ref.texts("code")[0] == designed
    np.testing.assert_allclose(sequence_metrics(designed), jax_metrics(designed), rtol=1e-4)
    for got_logo, want_logo in zip(logos["port"], logos["jax"], strict=True):
        np.testing.assert_allclose(got_logo, want_logo, atol=1e-5)
    # the draws: seed 0, the tempered probabilities, on the app's device
    probs, n, seed, kw = samples["port"]
    assert (n, seed) == (40, 0) and kw == {"rotamer_mode": "rot" in model,
                                           "temperature": 0.5, "device": torch.device("cpu")}
    np.testing.assert_array_equal(probs, got)
    np.testing.assert_allclose(apply_temperature(torch.from_numpy(got), 0.5).numpy(),
                               samples["jax"][0], atol=1e-6)
    ref_m = np.array(sequence_metrics(native))
    mae = [np.abs((np.array(s[1:]) - ref_m) / np.where(ref_m == 0, 1, ref_m)).sum()
           for s in samples["samples"]]
    order = np.argsort(mae, kind="stable")[:25]
    (table,) = port.payloads("dataframe")
    assert table["sequence"] == [samples["samples"][i][0] for i in order]
    np.testing.assert_allclose(table["MAE"], np.array(mae)[order], rtol=1e-12)


def test_bf16_argmax_agrees(monkeypatch, models_dir, logos):
    """The packages' default bfloat16: the designed residues agree at >= 0.95."""
    ref, port = _run_both(monkeypatch, _base("TIMED_rotamer"), _argv(models_dir))
    (got,), _, _ = _design(port)
    (want,), _, _ = _design(ref)
    assert (got.argmax(1) == want.argmax(1)).mean() >= 0.95
    assert _page(port) == _page(ref)


def test_missing_weights(monkeypatch, tmp_path):
    ref, port = _run_both(monkeypatch, _base(), ["--path_to_models", str(tmp_path)])
    assert port.texts("error")[0].startswith("No weights found for TIMED")
    assert_same_page(ref, port)


def _nmr_file(tmp_path: Path) -> Path:
    """1ubq's first model twice, the second moved by 0.2 A of noise."""
    import gzip

    rng = np.random.default_rng(0)
    atoms = [l for l in gzip.decompress(UBQ.read_bytes()).decode().splitlines()
             if l.startswith("ATOM")]
    out = []
    for k, noise in enumerate((0.0, 0.2)):
        out.append(f"MODEL     {k + 1:4d}")
        for line in atoms:
            x, y, z = np.array([line[30:38], line[38:46], line[46:54]], float) + rng.normal(
                0, noise, 3)
            out.append(f"{line[:30]}{x:8.3f}{y:8.3f}{z:8.3f}{line[54:]}")
        out.append("ENDMDL")
    path = tmp_path / "two_state.pdb"
    path.write_text("\n".join(out + ["END"]) + "\n")
    return path


def test_nmr_consensus_flow(monkeypatch, models_dir, tmp_path, f32, logos):
    """Two states designed and averaged: the page's matrix is the running
    consensus of the two designs, in both apps."""
    from timed_design_tpu_torch.io.decode import consensus_running_average

    responses = {**_base(), UPLOAD: Upload(_nmr_file(tmp_path)),
                 "Design all NMR states (consensus)": True}
    ref, port = _run_both(monkeypatch, responses, _argv(models_dir))
    assert "2 NMR states" in port.texts("success")[0]
    assert_same_page(ref, port)
    got, _, _ = _design(port)
    want, _, _ = _design(ref)
    assert len(got) == len(want) == 2 and np.abs(got[0] - got[1]).max() > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5)
    rows = _csv_rows(port.payloads("download_button")[0][1])
    np.testing.assert_allclose(rows, consensus_running_average(got), atol=1e-6)


def test_rerun_from_the_cache(monkeypatch, models_dir, f32, logos):
    """After Design!, a rerun with the button off redraws the page from the
    design cache: no forward, one cached design, the same page."""
    from timed_design_tpu_torch.engine.session import DesignSession

    forwards = []
    real = DesignSession.design
    monkeypatch.setattr(DesignSession, "design",
                        lambda self, s: forwards.append(1) or real(self, s))
    responses = _base()
    states = ({}, {})
    first = _run_both(monkeypatch, responses, _argv(models_dir), states)
    assert len(forwards) == 1
    responses["Design!"] = False
    ref, port = _run_both(monkeypatch, responses, _argv(models_dir), states)
    assert len(forwards) == 1
    assert len(port.session_state["design_cache"]) == 1
    assert "press Design!" not in " ".join(port.texts("info"))
    assert_same_page(ref, port)
    assert _page(port) == _page(first[1])


def test_discover_models(tmp_path):
    import timed_design_tpu.ui as jax_ui

    from timed_design_tpu_torch import ui

    (tmp_path / "TIMED.h5").write_bytes(b"x")
    (tmp_path / "Custom_model.h5").write_bytes(b"x")
    for d in (tmp_path, tmp_path / "absent"):
        assert ui.discover_models(d) == jax_ui.discover_models(d)
    opts = ui.discover_models(tmp_path)
    assert list(opts)[:2] == ["Custom_model", "TIMED"] and opts["ProDCoNN"] is None


def test_nmr_consensus_function():
    import timed_design_tpu.ui as jax_ui

    from timed_design_tpu_torch import ui

    rng = np.random.default_rng(3)
    states = [rng.random((5, 20)).astype(np.float32) for _ in range(3)]
    np.testing.assert_array_equal(ui._nmr_consensus(states), jax_ui._nmr_consensus(states))
    a, b, c = (np.full((2, 3), v) for v in (1.0, 2.0, 4.0))
    np.testing.assert_allclose(ui._nmr_consensus([a, b, c]), ((1 + 2) / 2 + 4) / 2)


def test_aligned_design_outputs_ragged_states():
    """States that drop different residues align on the common ones, with a
    frame-derived residue map, as in the JAX app."""
    import timed_design_tpu.ui as jax_ui
    from timed_design_tpu.voxel.frames import FrameAtoms as JaxFrameAtoms

    from timed_design_tpu_torch import ui
    from timed_design_tpu_torch.voxel.frames import FrameAtoms

    def fa_for(cls, rids, labels, chains):
        n = len(rids)
        return cls(atoms_xyz=np.zeros((1, 3), np.float32), atom_channel=np.zeros(1, np.int32),
                   atom_sigma=np.ones(1, np.float32), atom_prop=np.zeros(1, np.float32),
                   ca=np.zeros((n, 3), np.float32),
                   rot=np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)),
                   valid=np.ones(n, bool), labels=labels, chain_ids=chains, residue_ids=rids)

    rng = np.random.default_rng(1)
    p0, p1 = rng.random((4, 20)), rng.random((4, 20))
    s0 = (["1", "2", "4", "1"], ["MET", "GLN", "PHE", "GLY"], ["A", "A", "A", "B"])
    s1 = (["2", "3", "4", "1"], ["GLN", "ILE", "PHE", "GLY"], ["A", "A", "A", "B"])
    got = ui._aligned_design_outputs([(p0, fa_for(FrameAtoms, *s0)),
                                      (p1, fa_for(FrameAtoms, *s1))])
    want = jax_ui._aligned_design_outputs([(p0, fa_for(JaxFrameAtoms, *s0)),
                                           (p1, fa_for(JaxFrameAtoms, *s1))])
    for g, w in zip(got[0], want[0], strict=True):
        np.testing.assert_array_equal(g, w)
    assert got[1:] == want[1:] == ("QFG", ["Q2 (Chain A)", "F4 (Chain A)", "G1 (Chain B)"])


def test_property_design(monkeypatch, models_dir, f32, logos):
    """TIMED_Charge: the charge multiselects drawn once with the native
    charges, the design on the rewritten structure (CNOCACBQ), then a rerun
    with the positive residues cleared: a new design, the same pages in both
    apps, and the parse cache's native structure left as it was."""
    responses = _base("TIMED_Charge")
    states = ({}, {})
    for rerun in (False, True):
        if rerun:
            responses["Positive (+1) residues"] = []
        ref, port = _run_both(monkeypatch, responses, _argv(models_dir), states)
        assert "Constrain charge" in port.texts("subheader")
        picks = port.texts("multiselect")
        assert picks.count("Positive (+1) residues") == picks.count("Negative (-1) residues") == 1
        assert_same_page(ref, port)
    assert len(port.session_state["design_cache"]) == 2
    for got, want in zip(port.session_state["design_cache"].values(),
                         ref.session_state["design_cache"].values()):
        np.testing.assert_allclose(got[0][0], want[0][0], atol=1e-5)
        assert got[1:] == want[1:]
    (cached,) = port.session_state["parse_cache"].values()
    assert cached[0].sequence1().count("K") == 7  # 1ubq's lysines, not rewritten


def test_pdb_code_mirror_lookup(monkeypatch, models_dir, tmp_path, f32, logos):
    """A code found in the mirror (assembly first, code lower-cased); a
    missing code's error."""
    mirror = tmp_path / "mirror" / "ub"
    mirror.mkdir(parents=True)
    shutil.copy(UBQ, mirror / "1ubq.pdb1.gz")
    (mirror / "1ubq.pdb").write_text("ATOM\n")  # sorts after the assembly
    responses = {"Enter a PDB Code:": "1UBQ", "Choose your Model": "TIMED", "Design!": True}
    argv = _argv(models_dir, "--path_to_pdb", str(tmp_path / "mirror"))
    ref, port = _run_both(monkeypatch, responses, argv)
    assert "success" in port.kinds()
    assert_same_page(ref, port)
    responses["Enter a PDB Code:"] = "9zzz"
    ref, port = _run_both(monkeypatch, responses, argv)
    assert port.texts("error")[0].startswith("No structure for code 9zzz")
    assert_same_page(ref, port)


def test_pdb_code_fetch(monkeypatch, models_dir, tmp_path, f32, logos):
    """--allow-fetch: a code missing from the mirror is downloaded from a
    local server into the mirror's sharded layout and designed; without the
    flag the app errors and downloads nothing."""
    docroot = tmp_path / "docroot"
    docroot.mkdir()
    shutil.copy(UBQ, docroot / "1ubq.pdb1.gz")

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *a, **k):
            pass

    server = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(Quiet, directory=str(docroot)))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/"
    import timed_design_tpu.ui as jax_ui

    import timed_design_tpu_torch.ui as ui

    responses = {"Enter a PDB Code:": "1ubq", "Choose your Model": "TIMED", "Design!": True}
    try:
        pages = []
        for flags in ([], ["--allow-fetch", "--fetch_base_url", url]):
            # one mirror path for both apps (it is in the error text), each
            # app starting from it empty
            mirror = tmp_path / f"mirror{len(flags)}"
            mirror.mkdir()
            argv = _argv(models_dir, "--path_to_pdb", str(mirror), *flags)
            port = _run(monkeypatch, ui, responses, [*argv, "--device", "cpu"])
            kept = tmp_path / f"port_mirror{len(flags)}"
            shutil.move(mirror, kept)
            mirror.mkdir()
            ref = _run(monkeypatch, jax_ui, responses, argv)
            assert_same_page(ref, port)
            pages.append((port, kept))
    finally:
        server.shutdown()
    (idle, idle_mirror), (fetched, mirror) = pages
    assert idle.texts("error")[0].startswith("No structure for code 1ubq")
    assert not list(idle_mirror.rglob("*"))
    assert "success" in fetched.kinds()
    assert (mirror / "ub" / "1ubq.pdb1.gz").read_bytes() == UBQ.read_bytes()


def test_ensemble_flow(monkeypatch, models_dir, f32, logos):
    """Two picks average the members: the joined name labels the design and
    the page's matrix is the float64 mean of the members' (2e-6), in both
    apps."""
    members = {}
    for name in ("TIMED", "OTHER"):
        ref, port = _run_both(monkeypatch, _base(name), _argv(models_dir))
        members[name] = (_design(ref)[0][0], _design(port)[0][0])
    responses = _base(**{"Ensemble: average several models (optional)": ["TIMED", "OTHER"]})
    ref, port = _run_both(monkeypatch, responses, _argv(models_dir))
    assert "error" not in port.kinds()
    assert "TIMED + OTHER ensemble" in port.texts("success")[0]
    assert_same_page(ref, port)
    for k, rec in enumerate((ref, port)):
        want = (members["TIMED"][k].astype(np.float64) + members["OTHER"][k]) / 2.0
        np.testing.assert_allclose(_design(rec)[0][0], want, atol=2e-6)
    np.testing.assert_allclose(_design(port)[0][0], _design(ref)[0][0], atol=1e-5)


def test_ensemble_single_pick_errors(monkeypatch, models_dir):
    responses = _base(**{"Ensemble: average several models (optional)": ["TIMED"]})
    ref, port = _run_both(monkeypatch, responses, _argv(models_dir))
    assert "at least two" in port.texts("error")[0] and "success" not in port.kinds()
    assert_same_page(ref, port)


def _pixels(fig) -> np.ndarray:
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


def test_figures_pixel_for_pixel(monkeypatch):
    """Every figure of a rotamer design's page, drawn by both apps from the
    same arrays (seeded rows over 30 residues; 1ubq's CA trace; one
    designed and native sequence): the heatmap, the 338-class chart, the
    logo, the confusion matrix and the CA trace, equal pixel for pixel."""
    import timed_design_tpu.ui as jax_ui
    from timed_design_tpu.structure import load_pdb as jax_load_pdb

    import timed_design_tpu_torch.ui as ui
    from timed_design_tpu_torch.constants import AA1, ROTAMER_TO_AA, compress_rotamer_probs
    from timed_design_tpu_torch.structure import load_pdb

    rng = np.random.default_rng(7)
    L = 30
    logits = rng.normal(0, 1, (L, 338))
    # peaked rows draw one letter of the logo, flatter ones a stack of 20
    logits[np.arange(L), rng.integers(0, 338, L)] += rng.choice([6.0, 12.0], L)
    probs = np.exp(logits)
    probs = (probs / probs.sum(1, keepdims=True)).astype(np.float32)
    probs20 = compress_rotamer_probs(probs)
    aa = np.array(list(AA1))
    designed = "".join(aa[probs20.argmax(1)])
    native = "".join(aa[ROTAMER_TO_AA[rng.integers(0, 338, L)]])
    rmap = [f"{a}{i + 1} (Chain A)" for i, a in enumerate(native)]
    pages = []
    for module, structure, kw in ((jax_ui, jax_load_pdb(UBQ), {}),
                                  (ui, load_pdb(UBQ), {"device": "cpu"})):
        rec = Recorder({})
        monkeypatch.setattr(module, "st", rec)
        module._draw_structure_view(structure)
        module._draw_output_section("TIMED_rotamer", probs, probs20, designed, native, rmap,
                                    True, per_state_seqs=[designed, designed])
        module._draw_performance_section(designed, native, *kw.values())
        pages.append(rec)
    ref, port = pages
    assert_same_page(ref, port, atol=0)
    assert len(port.figures) == 5
    for got, want in zip(port.figures, ref.figures):
        a, b = _pixels(got), _pixels(want)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_needs_a_card_unless_told_cpu(monkeypatch):
    """The default --device cuda: without a card the app shows the error
    and exits naming --device cpu; with --device cpu it reaches its prompt."""
    import timed_design_tpu_torch.ui as ui

    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    with pytest.raises(SystemExit, match="--device cpu"):
        _run(monkeypatch, ui, {}, [])
    assert "info" in _run(monkeypatch, ui, {}, ["--device", "cpu"]).kinds()


def test_missing_streamlit_exits_naming_it(monkeypatch):
    import timed_design_tpu_torch.ui as ui

    monkeypatch.setattr(ui, "st", None)
    monkeypatch.setattr(ui, "_STREAMLIT_ERR", ImportError("No module named 'streamlit'"),
                        raising=False)
    with pytest.raises(SystemExit, match="streamlit is required.*timed_design_tpu_torch"):
        ui.main([])


# ----------------------------------------------- as a script, in a subprocess

# A stub ``streamlit`` package: widgets answer from $UI_RESPONSES (JSON; an
# upload as {"upload": path}), every call is written to $UI_CALLS at exit.
_STUB = r'''
import atexit, json, os, types
_calls = []
_responses = json.loads(os.environ.get("UI_RESPONSES", "{}"))
session_state = {}


class _Ctx:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def __getattr__(self, name):
        return __getattr__(name)


class _Upload:
    def __init__(self, path):
        self.name = os.path.basename(path)
        with open(path, "rb") as f:
            self._data = f.read()

    def read(self):
        return self._data


def _widget(kind, label, default):
    _calls.append([kind, label])
    v = _responses.get(label, default)
    return _Upload(v["upload"]) if isinstance(v, dict) else v


def text_input(label, value="", **k): return _widget("text_input", label, value)
def file_uploader(label, **k): return _widget("file_uploader", label, None)
def selectbox(label, options, **k): return _widget("selectbox", label, list(options)[0])
def multiselect(label, options, default=None, **k): return _widget("multiselect", label, default or [])
def checkbox(label, value=False, **k): return _widget("checkbox", label, value)
def number_input(label, a=None, b=None, value=None, **k): return _widget("number_input", label, value)
def slider(label, a=None, b=None, value=None, **k): return _widget("slider", label, value)
def button(label, **k): return _widget("button", label, False)


sidebar = _Ctx()
components = types.SimpleNamespace(v1=types.SimpleNamespace(html=lambda *a, **k: None))


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)

    def fn(*args, **kwargs):
        label = args[0] if args and isinstance(args[0], str) else None
        _calls.append([name, label] + ([len(args[0]["sequence"])] if name == "dataframe" else []))
        if name == "columns":
            return [_Ctx() for _ in range(args[0])]
        if name == "tabs":
            return [_Ctx() for _ in args[0]]
        return _Ctx()
    return fn


atexit.register(lambda: open(os.environ["UI_CALLS"], "w").write(json.dumps(_calls)))
'''

# Runs a script as ``streamlit run`` does: as __main__, its folder first on
# the path. With BLOCK=1 the JAX package and the libraries the card's
# machine lacks cannot be imported.
_LAUNCH = r'''
import os, runpy, sys
if os.environ.get("BLOCK") == "1":
    for name in ("timed_design_tpu", "jax", "flax", "optax", "h5py", "ml_dtypes", "pandas",
                 "matplotlib", "py3Dmol"):
        sys.modules[name] = None  # any import of these now raises ImportError
script = os.path.abspath(sys.argv[1])
sys.argv = [script, *sys.argv[2:]]
sys.path.insert(0, os.path.dirname(script))
runpy.run_path(script, run_name="__main__")
'''


def _launch(tmp_path, script, argv, responses=None, block=True):
    """(the finished process, the calls the stub recorded)."""
    stub = tmp_path / "stub"
    (stub / "streamlit").mkdir(parents=True, exist_ok=True)
    (stub / "streamlit" / "__init__.py").write_text(_STUB)
    calls = tmp_path / "calls.json"
    env = dict(os.environ, PYTHONPATH=str(stub), OMP_NUM_THREADS="1",
               UI_RESPONSES=json.dumps(responses or {}), UI_CALLS=str(calls),
               BLOCK="1" if block else "0")
    proc = subprocess.run([sys.executable, "-c", _LAUNCH, str(script), *argv],
                          capture_output=True, text=True, env=env, cwd=tmp_path, timeout=600)
    return proc, (json.loads(calls.read_text()) if calls.exists() else [])


def test_script_start_reaches_the_prompt(tmp_path):
    """``streamlit run timed_design_tpu_torch/ui.py -- --device cpu``, from
    another folder and without the repository on the path: the idle prompt,
    exit 0."""
    proc, calls = _launch(tmp_path, REPO / "timed_design_tpu_torch" / "ui.py",
                          ["--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert ["info", "Upload a backbone (or give a PDB code) and press Design!"] in calls


def test_full_flow_as_a_script_without_jax_pandas_or_matplotlib(tmp_path, models_dir):
    """The card's machine: the whole design page with Monte-Carlo, run as a
    script with the JAX package, jax, flax, h5py, ml_dtypes, pandas,
    matplotlib and py3Dmol unimportable. Each figure's place holds one error
    naming matplotlib (the CA trace, the heatmap, the logo, the confusion
    matrix), no other error; the table has 25 rows."""
    responses = {UPLOAD: {"upload": str(UBQ)}, "Choose your Model": "TIMED", "Design!": True,
                 "Optimize sequences using Monte Carlo": True}
    proc, calls = _launch(tmp_path, REPO / "timed_design_tpu_torch" / "ui.py",
                          _argv(models_dir, "--device", "cpu"), responses)
    assert proc.returncode == 0, proc.stderr[-3000:]
    errors = [label for kind, label, *_ in calls if kind == "error"]
    assert len(errors) == 4 and all("matplotlib" in e for e in errors), errors
    assert "py3Dmol" in errors[0]
    kinds = [c[0] for c in calls]
    assert "success" in kinds and "pyplot" not in kinds
    assert [c for c in calls if c[0] == "dataframe"][0][2] == 25
    assert ["subheader", "Prediction entropy"] in calls


def test_reference_app_cannot_start_as_a_script(tmp_path):
    """A known divergence the port does not share: the JAX app, run as
    ``streamlit run timed_design_tpu/ui.py`` runs it, dies at its first
    relative import (``from .constants ...`` in ``main``)."""
    proc, calls = _launch(tmp_path, REPO / "timed_design_tpu" / "ui.py", [], block=False)
    assert proc.returncode != 0
    assert "ImportError: attempted relative import with no known parent package" in proc.stderr
    assert calls == []  # nothing reached the page


# ---------------------------------------------------------------- the card

@pytest.mark.cuda
def test_monte_carlo_tab_on_card(monkeypatch, tmp_path):
    """On the card (the default --device cuda): the Optimisation tab makes
    one launch of the sampling kernel, whose codes and counts equal the
    plain version run on a CPU copy of its inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    import timed_design_tpu_torch.sample.sampler as sampler
    import timed_design_tpu_torch.ui as ui
    from timed_design_tpu_torch.models import TIMED, export_timed_to_h5
    from timed_design_tpu_torch.ops.sample import (
        philox_uniforms,
        sample_codes_plain,
        sample_inverse_cdf,
    )
    from timed_design_tpu_torch.train.train import flax_variables

    torch.manual_seed(0)
    tree = flax_variables(TIMED(n_classes=338, filters=(8,)).eval())
    export_timed_to_h5(tree["params"], tree["batch_stats"], tmp_path / "TIMED_rotamer.h5",
                       n_classes=338)
    launched = []
    real = sampler.sample_inverse_cdf

    def spy(probs, n, seed, class_map=None):
        out = real(probs, n, seed, class_map)
        launched.append((probs.cpu(), n, seed, None if class_map is None else class_map.cpu(),
                         [t.cpu() for t in out]))
        return out

    monkeypatch.setattr(sampler, "sample_inverse_cdf", spy)
    responses = _base("TIMED_rotamer", **{"Optimize sequences using Monte Carlo": True})
    before = sample_inverse_cdf.launches
    rec = _run(monkeypatch, ui, responses, _argv(tmp_path))
    assert sample_inverse_cdf.launches == before + 1 and len(launched) == 1
    probs, n, seed, cmap, (codes, counts) = launched[0]
    assert (n, seed) == (200, 0) and probs.shape == (76, 338) and cmap is not None
    want_codes, want_counts = sample_codes_plain(
        probs, torch.from_numpy(philox_uniforms(seed, n, 76)), cmap)
    torch.testing.assert_close(codes, want_codes, rtol=0, atol=0)
    torch.testing.assert_close(counts, want_counts, rtol=0, atol=0)
    (table,) = rec.payloads("dataframe")
    assert len(table["sequence"]) == 25
