"""Nothing the benchmark runs imports JAX or the JAX package ``repro``
(top-level names compared whole, so ``repro_torch`` is not ``repro``),
and the plain reference imports nothing of the program."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax_and_no_reference_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


def test_whole_name_comparison(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro_torch.api\nfrom repro_torch import x\n"
                 "import reprox\nfrom repro.core import y\n")
    names = top_level_imports(p)
    assert names == {"repro_torch", "reprox", "repro"}
    assert names & FORBIDDEN == {"repro"}
