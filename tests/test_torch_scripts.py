"""PyTorch port, the analysis scripts: ``timed_design_tpu_torch/scripts/``
against the JAX package's ``scripts/``, each run as a subprocess on
the same inputs (the port's with ``--device cpu``, and with the JAX package,
jax, flax, optax, h5py and ml_dtypes unimportable).

What must agree: ``run_benchmark_models``, the skip lines and each model's
metrics within 1e-6 (float32 on both sides, a head peaked so that argmax
margins are wide); ``make_af2_jobs``, its output, the job folders and the
scripts byte for byte; ``analyse_af2_results``, its CSV line for line;
``run_sampling``, the printed temperatures and file names and files of the
same shape (never the sampled sequences: Philox against threefry).
"""
import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def _analyse_tests():
    """``tests/test_torch_analyse.py`` loaded by its path (a ``tests``
    package of another distribution may shadow this folder's)."""
    spec = importlib.util.spec_from_file_location(
        "_torch_analyse_tests", REPO / "tests" / "test_torch_analyse.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


af2_tree = _analyse_tests().af2_tree  # a fixture
UBQ = REPO / "tests" / "testing_files" / "1ubq.pdb1.gz"
WALL_S = 300

_HYGIENE = textwrap.dedent("""
    import runpy, sys
    for _name in ("timed_design_tpu", "jax", "flax", "optax", "h5py", "ml_dtypes"):
        sys.modules[_name] = None  # any import of these now raises ImportError
    sys.argv = [sys.argv[1], *sys.argv[2:]]
    runpy.run_module(sys.argv[0], run_name="__main__")
""")


def _port(name: str, *args, cwd: Path, device: str = "cpu") -> str:
    """``python -m timed_design_tpu_torch.scripts.<name> ... --device``,
    port-only; its standard output (rc 0 asserted)."""
    proc = subprocess.run(
        [sys.executable, "-c", _HYGIENE, f"timed_design_tpu_torch.scripts.{name}",
         *map(str, args), "--device", device],
        cwd=cwd, capture_output=True, text=True, timeout=WALL_S,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _jax(name: str, *args, cwd: Path) -> str:
    """The JAX package's ``scripts/<name>.py ...`` on the CPU; its output."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / f"{name}.py"), *map(str, args)],
        cwd=cwd, capture_output=True, text=True, timeout=WALL_S,
        env=dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _dirs(tmp_path: Path) -> tuple[Path, Path]:
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    return tmp_path / "jax", tmp_path / "port"


def _tree(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _peaked_release(path: Path) -> Path:
    """A TIMED release file (filters (8,)) written by the JAX package's
    exporter, its first convolution scaled by 64 so that argmax margins are
    wide."""
    import jax

    from timed_design_tpu.models import export_timed_to_h5, timed

    v = timed(filters=(8,)).init(jax.random.key(3), np.zeros((1, 21, 21, 21, 5), np.float32))
    params = jax.tree.map(np.asarray, v["params"])
    params["Conv_0"]["kernel"] = params["Conv_0"]["kernel"] * 64.0
    return export_timed_to_h5(params, jax.tree.map(np.asarray, v["batch_stats"]), path,
                              n_classes=20, input_channels=5)


def _json_tail(out: str) -> tuple[list[str], dict]:
    """The lines before the JSON and the JSON."""
    head, _, tail = out.partition("{")
    return head.splitlines(), json.loads("{" + tail)


def test_run_benchmark_models_equals_jax(tmp_path):
    """One ``TIMED.h5`` in ``--models-dir`` and an ``.hdf5`` of 1ubq (the JAX
    package's ``make_frame_dataset``): the same skip lines, the same
    models, metrics within 1e-6, the same files under each output."""
    import warnings

    from timed_design_tpu.voxel import make_frame_dataset

    jax_dir, port_dir = _dirs(tmp_path)
    models = tmp_path / "models"
    models.mkdir()
    _peaked_release(models / "TIMED.h5")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        h5 = make_frame_dataset([UBQ], tmp_path / "ubq.hdf5")
    args = [h5, "out", "--models-dir", models]
    want_head, want = _json_tail(_jax("run_benchmark_models", *args, cwd=jax_dir))
    got_head, got = _json_tail(_port("run_benchmark_models", *args, cwd=port_dir))
    assert got_head == want_head and len(want_head) == 4  # four zoo models have no file
    assert list(got) == list(want) == [str(models / "TIMED.h5")]
    for m in want:
        for key in ("accuracy_1", "accuracy_3", "precision", "recall"):
            assert abs(got[m][key] - want[m][key]) <= 1e-6, (m, key)
        assert got[m]["accuracy_3"] > 0
    assert list(_tree(port_dir / "out")) == list(_tree(jax_dir / "out"))


def test_run_benchmark_models_needs_a_card_unless_told_cpu(tmp_path):
    """The default ``--device cuda`` exits with a message where there is no
    card, before any model loads."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "-c", _HYGIENE, "timed_design_tpu_torch.scripts.run_benchmark_models",
         str(tmp_path / "absent.hdf5")],
        cwd=tmp_path, capture_output=True, text=True, timeout=WALL_S,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def _sampling_inputs(d: Path) -> tuple[Path, Path]:
    """A rotamer prediction matrix of two chains (9 and 14 residues) and its
    datasetmap, as ``td-predict`` writes them."""
    p = np.random.default_rng(12).random((23, 338)) ** 4
    np.savetxt(d / "M_rot.csv", p / p.sum(1, keepdims=True), delimiter=",")
    (d / "M.txt").write_text("ignore_uncommon False\ninclude_pdbs\n##########\n"
                             "1abcA 9\n1abcB 14\n")
    return d / "M_rot.csv", d / "M.txt"


def _shape(path: Path):
    """A file's shape: a JSON's keys and lengths, a fasta's headers, a
    CSV's header and its rows' field counts."""
    text = path.read_text()
    if path.suffix == ".json":
        return {k: [len(s) for s in v] for k, v in json.loads(text).items()}
    lines = text.splitlines()
    if path.suffix == ".fasta":
        return [line for line in lines if line.startswith(">")], len(lines)
    return lines[0], [len(line.split(",")) for line in lines[1:]]


def _temperatures(out: str) -> int:
    return sum(line.startswith("T=") for line in out.splitlines())


def test_run_sampling_equals_jax(tmp_path):
    """``run_sampling MODEL.csv MODEL.txt 5``: the same ``T=...:`` lines and
    paths, and every file of the same shape."""
    jax_dir, port_dir = _dirs(tmp_path)
    csv, dmap = _sampling_inputs(tmp_path)
    want = _jax("run_sampling", csv, dmap, 5, cwd=jax_dir)
    got = _port("run_sampling", csv, dmap, 5, cwd=port_dir)
    assert got == want and _temperatures(want) == 5
    files = sorted(p.name for p in jax_dir.iterdir())
    assert sorted(p.name for p in port_dir.iterdir()) == files and len(files) == 15
    for name in files:
        assert _shape(port_dir / name) == _shape(jax_dir / name), name


def test_make_af2_jobs_equals_jax(tmp_path):
    """170 sampled sequences into jobs of 80: the same ``sbatch`` lines, the
    same folders and fastas, the scripts byte for byte."""
    jax_dir, port_dir = _dirs(tmp_path)
    fasta = tmp_path / "samples.fasta"
    fasta.write_text("".join(f">d{i}\nMKV{'A' * (i % 13)}\n" for i in range(170)))
    want = _jax("make_af2_jobs", fasta, "jobs", cwd=jax_dir)
    got = _port("make_af2_jobs", fasta, "jobs", cwd=port_dir)
    assert got == want and want.count("sbatch ") == 3
    assert _tree(port_dir) == _tree(jax_dir)


def test_analyse_af2_results_equals_jax(tmp_path, af2_tree):
    """The AF2 tree of ``tests/test_torch_analyse.py`` (a translated refold,
    a truncated one, an unranked file): the same CSV, line for line."""
    af2_dir, ref = af2_tree
    jax_dir, port_dir = _dirs(tmp_path)
    want = _jax("analyse_af2_results", ref, af2_dir, cwd=jax_dir)
    got = _port("analyse_af2_results", ref, af2_dir, cwd=port_dir)
    assert got.splitlines() == want.splitlines()
    assert want.splitlines()[0] == "design,rmsd,gdt1,gdt2,gdt4,gdt8,mean_plddt"
    assert len(want.splitlines()) == 3


@pytest.mark.cuda
def test_run_sampling_on_the_card(tmp_path):
    """``run_sampling`` on the card (five batched launches of the sampling
    kernel) against the same script's ``--device cpu`` run: the same output,
    the same files, the fastas byte for byte (the kernel draws what its
    plain version draws); the metrics, float32 sums on the card, within
    1e-5 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    card, cpu = _dirs(tmp_path)
    csv, dmap = _sampling_inputs(tmp_path)
    got = _port("run_sampling", csv, dmap, 50, cwd=card, device="cuda")
    want = _port("run_sampling", csv, dmap, 50, cwd=cpu)
    assert got == want and _temperatures(want) == 5
    got, want = _tree(card), _tree(cpu)
    assert list(got) == list(want) and len(want) == 15
    for name in want:
        if name.endswith(".fasta"):
            assert got[name] == want[name], name
        elif name.endswith(".json"):
            g, w = json.loads(got[name]), json.loads(want[name])
            assert {k: [s for s, *_ in v] for k, v in g.items()} == {
                k: [s for s, *_ in v] for k, v in w.items()}, name
            np.testing.assert_allclose([m for v in g.values() for _, *m in v],
                                       [m for v in w.values() for _, *m in v], rtol=1e-5)
        else:
            rows = [[line.split(",") for line in t.decode().splitlines()]
                    for t in (got[name], want[name])]
            assert [r[:2] for r in rows[0]] == [r[:2] for r in rows[1]], name
            np.testing.assert_allclose([[float(v) for v in r[2:]] for r in rows[0][1:]],
                                       [[float(v) for v in r[2:]] for r in rows[1][1:]],
                                       rtol=1e-5)
