"""What the benchmark may import: nothing of JAX, Flax or the JAX package
anywhere, and nothing of the program under test in the reference."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "timed_design_tpu"}
MODULES = sorted(HERE.rglob("*.py"))


def imported(path: Path) -> set[str]:
    """Every module name an import statement of ``path`` names, relative
    imports resolved against the ``tdbench`` package."""
    tree = ast.parse(path.read_text(), str(path))
    package = path.relative_to(HERE.parent).with_suffix("").parts[:-1]
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[: len(package) - node.level + 1]
                names.add(".".join([*base, node.module] if node.module else base))
            else:
                names.add(node.module)
    return names


def test_there_are_modules_to_read():
    assert any(p.name == "run.py" for p in MODULES)
    assert any("reference" in p.parts for p in MODULES)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert not tops & FORBIDDEN, f"{path} imports {sorted(tops & FORBIDDEN)}"


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert "timed_design_tpu_torch" not in tops
    # nor anything of the harness that drives the program
    assert not {n for n in imported(path) if n.startswith("tdbench.")
                and not n.startswith("tdbench.reference")}


def test_the_check_compares_whole_names():
    from tdbench import harness

    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "timed_design_tpu")
    import sys

    sys.modules["timed_design_tpu_torch_probe"] = sys
    try:
        assert "timed_design_tpu_torch_probe" not in harness.forbidden_modules()
    finally:
        del sys.modules["timed_design_tpu_torch_probe"]
