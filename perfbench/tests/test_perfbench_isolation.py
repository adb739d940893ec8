"""Nothing of the benchmark imports JAX or the JAX package ``repro``, and
the plain references import nothing of the program either. Module names
are compared by their top-level part, whole: ``repro_torch`` is not
``repro``."""
import ast
from pathlib import Path

import pytest

from perfbench import harness

PB = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in PB.rglob("*.py") if "__pycache__" not in p.parts)
REFERENCE = sorted((PB / "reference").glob("*.py"))
NEVER = {"jax", "jaxlib", "flax", "repro"}


def roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", "")) in
              ("import_module", "__import__", "spec_from_file_location")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.args[0].value.split(".")[0]


def test_files_found():
    names = {p.relative_to(PB).as_posix() for p in FILES}
    assert {"run.py", "harness.py", "reference/qwen2.py", "reference/mamba2.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(PB).as_posix())
def test_no_jax_and_no_jax_package(path):
    assert set(roots(path)) & NEVER == set()


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.relative_to(PB).as_posix())
def test_reference_imports_nothing_of_the_program(path):
    assert set(roots(path)) & (NEVER | {"repro_torch"}) == set()


def test_whole_names_are_compared():
    loaded = ["torch", "repro_torch", "repro_torch.serving", "reproduce", "perfbench.harness"]
    assert harness.forbidden_modules(loaded) == []
    assert harness.forbidden_modules(loaded + ["repro.serving", "jaxlib"]) == ["jaxlib", "repro"]
