"""PyTorch port, constants and structure layer: the port's own copies of the
JAX package's tables and PDB parser, held to the originals; and the import
boundary (the port imports nothing of ``timed_design_tpu``).

Tables compare exactly; parsed structures compare field by field, exactly:
the port's C++ scanner and its Python scanner, each against the JAX
package's Python scanner.
"""
import ast
import dataclasses
import gzip
import importlib.util
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

TABLES = [
    "AA1", "AA3", "AA1_TO_INT", "AA3_TO_AA1", "AA3_TO_INT", "CHI_COUNTS",
    "STANDARD_AMINO_ACIDS", "UNCOMMON_RESIDUE_DICT", "VDW_RADII", "POLARITY_ZIMMERMAN",
    "RESIDUE_CHARGE", "RESIDUE_MW", "RESIDUE_EXT_280", "MW_ARR", "EXT280_ARR",
    "PKA_POSITIVE", "PKA_NEGATIVE", "PKA_SIDECHAIN_ARR", "PKA_SIGN_ARR", "WATER_MASS",
    "N_ROTAMER_CLASSES", "ROTAMER_TO_AA", "ROTAMER_TO_AA_ONEHOT", "ROTAMER_CATEGORIES",
    "AA1_TO_AA3", "CHARGE_ARR", "IS_POLAR_ARR", "POLARITY_ARR", "CHI_COUNTS_ARR",
    "N_AMINO_ACIDS", "ROTAMER_CATEGORIES_1LETTER", "ROTAMER_CHI_BINS",
]


@pytest.mark.parametrize("name", TABLES)
def test_constant_table_equals_jax_package(name):
    import timed_design_tpu.constants as jax_constants

    import timed_design_tpu_torch.constants as constants

    got, want = getattr(constants, name), getattr(jax_constants, name)
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_compress_rotamer_probs_equals_jax_package():
    from timed_design_tpu.constants import compress_rotamer_probs as jax_compress

    from timed_design_tpu_torch.constants import compress_rotamer_probs

    p = np.random.default_rng(0).random((7, 338)).astype(np.float32)
    np.testing.assert_array_equal(compress_rotamer_probs(p), jax_compress(p))


@pytest.mark.parametrize("prop", ["polarity", "charge"])
def test_convert_seq_to_property_equals_jax_package(prop):
    from timed_design_tpu.structure import convert_seq_to_property as jax_convert

    from timed_design_tpu_torch.structure import convert_seq_to_property

    seq = "ACDEFGHIKLMNPQRSTVWYXB"
    assert convert_seq_to_property(seq, prop) == jax_convert(seq, prop)


def _edge_module():
    spec = importlib.util.spec_from_file_location(
        "_pdb_edge_cases", REPO / "tests" / "test_pdb_edge_cases.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _edge_cases() -> dict[str, str]:
    """The PDB texts of tests/test_pdb_edge_cases.py, by fixture name, and
    those of ``_parser_cases``."""
    mod = _edge_module()
    texts = {k: getattr(mod, k)() for k in dir(mod) if k.startswith("fx_")}
    return {k: v + "END\n" for k, v in {**texts, **_parser_cases(mod)}.items()}


EDGE_CASES = ["fx_ca_only", "fx_chain_break", "fx_duplicate_resseq", "fx_garbage_coords",
              "fx_header_only", "fx_icodes", "fx_many_chains", "fx_missing_ca",
              "fx_missing_nc", "fx_models_differ", "fx_mse_hetatm", "fx_negative_resseq",
              "fx_only_waters", "fx_uncommon_hyp", "fx_waters_and_ligand"]


def _parser_cases(mod) -> dict[str, str]:
    """PDB texts for the paths of the parser's array passes that the edge
    cases above leave out, made with their line helpers (``mod``)."""
    atom, bb = mod.atom, mod.bb

    def no_element(line: str) -> str:
        return line[:66] + "\n"  # the line ends after the B-factor

    return {
        # A and B conformers sharing blank atoms; a residue with B and C
        # only (B kept); GLY A / SER B at one position (A's atoms only)
        "altloc_shared_and_b_only": (
            atom(1, "N", "SER", "A", 1, 0, 0, 0) + atom(2, "CA", "SER", "A", 1, 1.5, 0, 0)
            + atom(3, "CB", "SER", "A", 1, 2, 1, 1, altloc="A")
            + atom(4, "CB", "SER", "A", 1, 2, -1, 1, altloc="B")
            + atom(5, "OG", "SER", "A", 1, 3, 1, 1, altloc="A")
            + atom(6, "OG", "SER", "A", 1, 3, -1, 1, altloc="B")
            + atom(7, "C", "SER", "A", 1, 2.5, 1, 0) + atom(8, "O", "SER", "A", 1, 3.5, 1, 1)
            + bb(9, "VAL", "A", 2, 4.0).replace(" VAL", "BVAL")
            + bb(13, "VAL", "A", 2, 4.3).replace(" VAL", "CVAL")
            + bb(17, "GLY", "A", 3, 8.0).replace(" GLY", "AGLY")
            + bb(21, "SER", "A", 3, 8.2).replace(" SER", "BSER")
            + atom(25, "OG", "SER", "A", 3, 9, 1, 1, altloc="B")
            + bb(26, "LEU", "A", 4, 12.0)),
        "interleaved_chains": (bb(1, "ALA", "A", 1) + bb(5, "GLY", "B", 1, 4.0)
                               + bb(9, "VAL", "A", 2, 8.0) + bb(13, "SER", "B", 2, 12.0)
                               + bb(17, "LEU", "C", 1, 16.0) + bb(21, "LYS", "A", 3, 20.0)),
        "split_residue": (bb(1, "ALA", "A", 1, names=("N", "CA"))
                          + bb(3, "GLY", "A", 2, 4.0)
                          + bb(7, "ALA", "A", 1, names=("N", "C", "O"))
                          + atom(10, "CB", "ALA", "A", 1, 2, 2, 2)),
        "duplicate_atom_name": (bb(1, "ALA", "A", 1)
                                + atom(5, "CA", "ALA", "A", 1, 9, 9, 9, element="SE")
                                + atom(6, "CB", "ALA", "A", 1, 2, 2, 2)
                                + atom(7, "CB", "ALA", "A", 1, 3, 3, 3)
                                + bb(8, "GLY", "A", 2, 4.0)),
        # the element column absent on some lines: inferred from the atom
        # name's first letter (FE -> F, 1HB -> H); present ones capitalised
        "element_column_absent": (
            "".join(no_element(l) for l in bb(1, "ALA", "A", 1).splitlines())
            + no_element(atom(5, "1HB", "ALA", "A", 1, 2, 2, 2))
            + atom(6, "CB", "ALA", "A", 1, 2, 1, 2, element="c")
            + bb(7, "MSE", "A", 2, 4.0)
            + atom(11, "SE", "MSE", "A", 2, 6, 2, 2, element="SE")
            + no_element(atom(12, "FE", "HEM", "A", 3, 9, 9, 9, record="HETATM"))
            + atom(13, "ZN", "ZN", "A", 4, 12, 9, 9, element="zn", record="HETATM")
            + no_element(atom(14, "CL", "CL", "A", 5, 15, 9, 9, record="HETATM"))),
        # non-standard HETATM residues between standard ones (kept only
        # with keep_hetatms=True), a water, an uncommon residue
        "nonstandard_hetatm": (
            bb(1, "ALA", "A", 1)
            + atom(5, "C1", "NAG", "A", 2, 5, 5, 5, record="HETATM")
            + atom(6, "O5", "NAG", "A", 2, 6, 5, 5, record="HETATM")
            + bb(7, "SEP", "A", 3, 8.0, record="HETATM")
            + atom(11, "O", "HOH", "B", 1, 20, 20, 20, record="HETATM")
            + bb(12, "GLY", "A", 4, 12.0)
            + atom(16, "FE", "HEM", "A", 5, 25, 20, 20, element="FE", record="HETATM")),
    }


PARSER_CASES = ["altloc_shared_and_b_only", "interleaved_chains", "split_residue",
                 "duplicate_atom_name", "element_column_absent", "nonstandard_hetatm"]


def _assert_same(got, want, where="structure"):
    """Dataclass trees compared field by field; arrays exactly."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, where
        for f in dataclasses.fields(want):
            _assert_same(getattr(got, f.name), getattr(want, f.name), f"{where}.{f.name}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want and type(got) is type(want), where


@pytest.fixture(params=["native", "python"])
def scanner(request, monkeypatch):
    """The port's parser on its C++ scanner or (with its native binding
    patched out) on its Python one, against the JAX package's parser on its
    Python scanner in both cases.

    The JAX package's C++ scanner is never loaded here: its loader rebuilds
    ``native/libpdbscan.so`` in place (``g++ -o``) whenever the library is
    older than its source, and test workers doing so at once load a library
    that another is rewriting. ``tests/test_native.py`` holds the JAX
    package's two scanners equal."""
    import timed_design_tpu.structure._native as jax_native

    import timed_design_tpu_torch.structure._native as native

    monkeypatch.setattr(jax_native, "scan_pdb_native", lambda text: None)
    if request.param == "native":
        assert native.native_available()
    else:
        monkeypatch.setattr(native, "scan_pdb_native", lambda text: None)
    return request.param


@pytest.mark.parametrize("case", ["1ubq"] + EDGE_CASES + PARSER_CASES)
def test_parse_pdb_string_equals_jax_package(case, scanner, ubq_pdb_gz):
    from timed_design_tpu.structure import parse_pdb_string as jax_parse

    from timed_design_tpu_torch.structure import parse_pdb_string

    text = (gzip.decompress(ubq_pdb_gz.read_bytes()).decode() if case == "1ubq"
            else _edge_cases()[case])
    for all_states in (False, True):
        for keep_hetatms in (False, True):
            kw = dict(name=case, all_states=all_states, keep_hetatms=keep_hetatms)
            try:
                want = jax_parse(text, **kw)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)):
                    parse_pdb_string(text, **kw)
                continue
            _assert_same(parse_pdb_string(text, **kw), want)


def test_load_pdb_and_backbone_equal_jax_package(ubq_pdb_gz, monkeypatch):
    import timed_design_tpu.structure._native as jax_native
    from timed_design_tpu.structure import load_pdb as jax_load

    from timed_design_tpu_torch.structure import load_pdb

    # the JAX package's Python scanner, as in ``scanner`` above
    monkeypatch.setattr(jax_native, "scan_pdb_native", lambda text: None)

    got, want = load_pdb(ubq_pdb_gz), jax_load(ubq_pdb_gz)
    _assert_same(got, want)
    for k, v in want.backbone_arrays().items():
        np.testing.assert_array_equal(got.backbone_arrays()[k], v)


def test_native_scanner_builds_into_the_port():
    """The port's scanner library lives in its own build folder, never in
    the JAX package's native/."""
    import timed_design_tpu_torch.structure._native as native

    assert native.native_available()
    assert native._SRC == REPO / "timed_design_tpu_torch" / "csrc" / "pdbscan.cpp"
    assert native._BUILD_DIR == REPO / "timed_design_tpu_torch" / "_build"
    assert list(native._BUILD_DIR.glob("libpdbscan-*.so"))


# The port's sources: every module but what lies in its build folder.
PORT_FILES = sorted(str(p.relative_to(REPO))
                    for p in (REPO / "timed_design_tpu_torch").rglob("*.py")
                    if "_build" not in p.relative_to(REPO).parts) + ["chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_imports_nothing_of_the_jax_package(path):
    """Every import in the port's modules (``train/`` among them) and in
    chip_smoke.py, read with ast: none names timed_design_tpu, JAX, Flax,
    optax, h5py, ml_dtypes or pandas (the card's machine has none of them)."""
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("timed_design_tpu", "jax", "jaxlib", "flax", "optax", "h5py",
                               "ml_dtypes", "pandas"), (
                f"{path}:{node.lineno} imports {name}")


def test_the_import_check_reads_the_scripts_and_the_front_end():
    """The ast check above reads the analysis scripts (``scripts/``) and the
    rank-0 front end with the rest."""
    for path in ("scripts/__init__.py", "scripts/run_benchmark_models.py",
                 "scripts/run_sampling.py", "scripts/make_af2_jobs.py",
                 "scripts/analyse_af2_results.py", "parallel/frontend.py"):
        assert f"timed_design_tpu_torch/{path}" in PORT_FILES, path


def _imported_tops(tree) -> list[tuple[int, str]]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name.split(".")[0]) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.lineno, (node.module or "").split(".")[0]))
    return out


@pytest.mark.parametrize("path", PORT_FILES)
def test_matplotlib_only_through_pyplot(path):
    """No module of the port imports matplotlib but ``analyse/plots.py``,
    and that one only inside its functions (``pyplot`` and the plots that
    call it first), so the card's machine, which has no matplotlib, imports
    every module."""
    tree = ast.parse((REPO / path).read_text(), filename=path)
    if path == "timed_design_tpu_torch/analyse/plots.py":
        top_level = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        assert "matplotlib" not in [top for _, top in _imported_tops(ast.Module(top_level, []))]
        return
    for lineno, top in _imported_tops(tree):
        assert top != "matplotlib", f"{path}:{lineno} imports matplotlib"
