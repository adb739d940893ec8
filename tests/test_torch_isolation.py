"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro`` (only the
parity tests import both)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # a relative import stays inside the port
                continue
            yield node.lineno, (node.module or "").split(".")[0]
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", "")) in
            ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_port_files_found():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "chip_smoke.py" in names
    assert "src/repro_torch/kernels/runtime.py" in names
    assert len(names) > 20


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_imports_no_jax_and_no_reference(path):
    bad = [(line, mod) for line, mod in _imported_roots(path) if mod in FORBIDDEN]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_a_reference_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom repro.configs import base\nimport jax.numpy as jnp\n")
    assert [m for _, m in _imported_roots(f) if m in FORBIDDEN] == ["repro", "jax"]


def test_entry_points_default_to_the_card():
    import inspect

    from repro_torch.core.coral import CORAL
    from repro_torch.core.dcov import dcor_all
    from repro_torch.core.episode import (
        run_coral_batch,
        run_drift_requests,
        run_fault_requests,
        run_static_requests,
    )
    from repro_torch.core.evaluate import (
        run_cell,
        run_coral,
        run_drift_regime,
        run_fault_regime,
        run_regime,
    )
    from repro_torch.experiments.matrix import (
        run_drift_cell,
        run_fault_cell,
        run_matrix,
        run_static_cell,
    )
    from repro_torch.launch.serve import build_engine, serve
    from repro_torch.models.convert import params_from_jax

    for fn in (serve, build_engine, params_from_jax, run_matrix, run_static_cell,
               run_drift_cell, run_fault_cell, run_static_requests, run_drift_requests,
               run_fault_requests, run_coral_batch, run_regime, run_coral,
               run_drift_regime, run_fault_regime, run_cell, CORAL, dcor_all):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
