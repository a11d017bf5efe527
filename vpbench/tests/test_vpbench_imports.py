"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference (with everything the reference pool loads) imports
nothing of the program. Modules are compared by their top-level name,
whole: the program's name begins with the JAX package's."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "vorbispizza_tpu"}
PROGRAM = "vorbispizza_tpu_torch"
#: modules a spawned reference worker loads, and the inputs' checks
STANDALONE = ["reference", "refworker.py", "pool.py", "check.py",
              "roofline.py"]


def top_level_imports(path: pathlib.Path) -> set[str]:
    """Top-level names of the absolute imports of a source file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(*parts: str) -> list[pathlib.Path]:
    out = []
    for part in parts:
        p = ROOT / part
        out += sorted(p.rglob("*.py")) if p.is_dir() else [p]
    return out


def test_top_level_names_compare_whole():
    assert PROGRAM.split(".")[0] not in FORBIDDEN
    assert PROGRAM.startswith("vorbispizza_tpu")


@pytest.mark.parametrize("path", sources("."), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sources(*STANDALONE), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_reference_side_imports_no_program(path):
    names = top_level_imports(path)
    assert PROGRAM not in names and "torch" not in names
