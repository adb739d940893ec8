"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro`` (only the
parity tests import both)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "moe_ep_check.py", ROOT / "tools" / "dryrun_card_check.py"]
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


def test_serving_remainder_is_scanned():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for module in ("serving/controller.py", "device/measure.py", "serving/engine.py",
                   "serving/runtime.py"):
        assert f"src/repro_torch/{module}" in names


def test_multi_device_launch_is_scanned():
    """The multi-device slice's modules, and the tools ``chip_smoke.py``
    runs them through on the card."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for module in ("sharding/specs.py", "launch/mesh.py", "launch/specs.py", "launch/dryrun.py",
                   "launch/hlo_analysis.py", "launch/report.py", "launch/tune.py",
                   "configs/shapes.py"):
        assert f"src/repro_torch/{module}" in names
    assert {"tools/moe_ep_check.py", "tools/dryrun_card_check.py"} <= names


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
        run_fleet_requests,
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
        run_cotenant_cell,
        run_drift_cell,
        run_fault_cell,
        run_matrix,
        run_offload_cell,
        run_static_cell,
    )
    from repro_torch.experiments.fleet import run_fleet
    from repro_torch.launch.serve import build_engine, serve
    from repro_torch.models.convert import params_from_jax
    from repro_torch.serving.controller import ServingController
    from repro_torch.serving.engine import ServingEngine

    for fn in (serve, build_engine, params_from_jax, run_matrix, run_static_cell,
               run_drift_cell, run_fault_cell, run_offload_cell, run_cotenant_cell,
               run_static_requests, run_drift_requests,
               run_fault_requests, run_fleet_requests, run_fleet, run_coral_batch, run_regime, run_coral,
               run_drift_regime, run_fault_regime, run_cell, CORAL, dcor_all,
               ServingController):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    # the engine runs where its weights lie (build_engine puts them on the
    # card) and there replays its decode step from CUDA graphs by default
    for fn in (build_engine, ServingEngine):
        assert inspect.signature(fn).parameters["graphs"].default is None, fn
