"""Nothing under bench/ imports JAX or the JAX package, comparing each
import's top-level name whole (the port ``repro_torch`` begins with the
JAX package's name ``repro``); the reference imports nothing of the
program either."""
import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def full_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    """The reference reads PyTorch, NumPy, the standard library and itself:
    nothing of the program (``repro_torch``) or of the harness."""
    for name in full_imports(path):
        top = name.split(".")[0]
        assert top in {"__future__", "math", "typing", "dataclasses", "re",
                       "torch", "numpy"} or \
            name.startswith("bench.reference"), name


def test_whole_name_compare():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.core".split(".")[0] in FORBIDDEN
