"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: every import's top-level name
(the part before the first dot) is compared whole, so ``tpudet_torch``
is not ``tpudet``."""

import ast
from pathlib import Path

import pytest

from detbench.harness import FORBIDDEN

HERE = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert "tpudet_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "math", "typing",
                                       "dataclasses", "numpy", "torch",
                                       "scipy", "detbench"}


def test_whole_names():
    assert "tpudet_torch" not in FORBIDDEN and "tpudet" in FORBIDDEN
