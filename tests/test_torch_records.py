"""The port's record tools against the JAX package's: the schemas and
their validators (``repro_torch.experiments.schema``) give the reference's
verdict on the committed ``BENCH_matrix.json`` and ``BENCH_fleet.json``
and on each of a set of mutations, with ``jsonschema`` and with it hidden
(the built-in checker, the one a machine without it runs); the one stated
difference is the ``engine`` enum, which admits the port's ``"batched"``.
``markdown_report`` renders the committed record as the committed
``BENCH_matrix.md``, byte for byte; ``score_floors`` equals the
reference's; the port's own matrix record over a few cells carries the
reference's top-level keys and passes the validator, and so does its
fleet record, wrapped as the reference's fleet bench wraps it.
"""
import copy
import json
import sys
from pathlib import Path

import pytest

from repro.experiments import matrix as ref_matrix
from repro.experiments import scenarios as ref_sc
from repro.experiments import schema as ref_schema
from repro.experiments.report import markdown_report as ref_markdown_report
from repro_torch.experiments import (
    fleet_convergence_figure,
    markdown_report,
    run_cell,
    run_fleet,
    run_matrix,
    run_static_cell,
    score_floors,
    validate_fleet_record,
    validate_matrix_record,
)
from repro_torch.experiments import schema
from repro_torch.experiments import scenarios as sc

ROOT = Path(__file__).resolve().parents[1]
MATRIX = json.loads((ROOT / "BENCH_matrix.json").read_text())
FLEET = json.loads((ROOT / "BENCH_fleet.json").read_text())


@pytest.fixture(params=["jsonschema", "builtin"])
def checker(request, monkeypatch):
    """Validate with the ``jsonschema`` package, then with it hidden."""
    if request.param == "builtin":
        monkeypatch.setitem(sys.modules, "jsonschema", None)
    else:
        pytest.importorskip("jsonschema")
    return request.param


def _verdict(validate, record):
    try:
        validate(record)
    except ValueError:
        return "invalid"
    return "valid"


def _set(path, value):
    def mutate(record):
        node = record
        for key in path[:-1]:
            node = node[key]
        if value is _DELETE:
            del node[path[-1]]
        else:
            node[path[-1]] = value
    return mutate


_DELETE = object()
MATRIX_MUTATIONS = {
    "as committed": lambda r: None,
    "missing top-level key": _set(("quick",), _DELETE),
    "missing cell key": _set(("cells", 0, "coral"), _DELETE),
    "missing summary key": _set(("summary", "n_cells"), _DELETE),
    "bad enum": _set(("engine",), "eager"),
    "bad mode enum": _set(("cells", 0, "mode"), "triple"),
    "bad schema version": _set(("schema_version",), 5),
    "negative number": _set(("cells", 0, "coral", "score"), -0.5),
    "negative wall clock": _set(("wall_clock_s", "static_prep_s"), -1.0),
    "wrong type": _set(("iters",), "10"),
    "bool for integer": _set(("iters",), True),
    "wrong type in array": _set(("seeds", 0), 0.5),
    "empty seeds": _set(("seeds",), []),
    "null where a number": _set(("cells", 0, "tau_target"), None),
}
FLEET_MUTATIONS = {
    "as committed": lambda r: None,
    "missing top-level key": _set(("engine",), _DELETE),
    "missing result key": _set(("results", "warm_gain"), _DELETE),
    "bad enum": _set(("schema_version",), 2),
    "negative number": _set(("results", "warm_cohort"), -1),
    "rate above one": _set(("results", "feasible_rate"), 1.5),
    "wrong type": _set(("results", "families"), "jetson"),
    "wrong type in a family": _set(("results", "per_family", "edge-orin-nano", "n_twins"), 1.5),
}


@pytest.mark.parametrize("mutation", sorted(MATRIX_MUTATIONS))
def test_matrix_schema_gives_the_reference_verdict(checker, mutation):
    rec = copy.deepcopy(MATRIX)
    MATRIX_MUTATIONS[mutation](rec)
    want = "valid" if mutation == "as committed" else "invalid"
    assert _verdict(ref_schema.validate_matrix_record, rec) == want
    assert _verdict(validate_matrix_record, rec) == want


@pytest.mark.parametrize("mutation", sorted(FLEET_MUTATIONS))
def test_fleet_schema_gives_the_reference_verdict(checker, mutation):
    assert "edge-orin-nano" in FLEET["results"]["per_family"]
    rec = copy.deepcopy(FLEET)
    FLEET_MUTATIONS[mutation](rec)
    want = "valid" if mutation == "as committed" else "invalid"
    assert _verdict(ref_schema.validate_fleet_record, rec) == want
    assert _verdict(validate_fleet_record, rec) == want


def test_engine_enum_admits_the_port_and_the_reference(checker):
    """The one change to the reference's schema: ``engine`` admits the
    port's ``"batched"`` beside ``"compiled"`` and ``"scalar"``."""
    for engine in ("compiled", "batched", "scalar"):
        validate_matrix_record(dict(MATRIX, engine=engine))
    assert _verdict(ref_schema.validate_matrix_record, dict(MATRIX, engine="batched")) == "invalid"
    assert schema.MATRIX_SCHEMA["properties"]["engine"]["enum"] == ["compiled", "batched", "scalar"]
    port, ref = copy.deepcopy(schema.MATRIX_SCHEMA), copy.deepcopy(ref_schema.MATRIX_SCHEMA)
    port["properties"]["engine"]["enum"] = ref["properties"]["engine"]["enum"]
    assert port == ref
    assert schema.FLEET_SCHEMA == ref_schema.FLEET_SCHEMA


def test_builtin_checker_reports_every_fault():
    rec = copy.deepcopy(MATRIX)
    del rec["quick"]
    rec["engine"] = "eager"
    rec["iters"] = 0
    errors = []
    schema._check(rec, schema.MATRIX_SCHEMA, "$", errors)
    assert errors == ["$: missing required key 'quick'",
                      "$.engine: 'eager' not in ['compiled', 'batched', 'scalar']",
                      "$.iters: 0 < minimum 1"]


def test_markdown_report_renders_the_committed_record():
    want = (ROOT / "BENCH_matrix.md").read_text()
    assert ref_markdown_report(MATRIX) == want
    assert markdown_report(MATRIX) == want


def test_score_floors_equal_the_reference():
    floors = score_floors(MATRIX)
    assert floors == ref_matrix.score_floors(MATRIX)
    n = sum(len(MATRIX[f]) for f in ("cells", "drift_cells", "offload_cells",
                                     "cotenant_cells", "fault_cells"))
    assert len(floors) == n == 74


def test_run_cell_is_run_static_cell():
    assert run_cell is run_static_cell


@pytest.fixture(scope="module")
def records():
    """The port's record and the reference's over the same few cells: two
    static cells, a drift cell and one cell of each other family."""
    static = sc.enumerate_cells()[:2]
    kw = lambda s: dict(offload_cells=s.MATRIX_OFFLOAD_CELLS[:1],  # noqa: E731
                        cotenant_cells=s.MATRIX_COTENANT_CELLS[:1],
                        fault_cells=s.MATRIX_FAULT_CELLS[:1])
    port = run_matrix(static + [sc.MATRIX_DRIFT_CELLS[0]], seeds=(0,), **kw(sc), device="cpu")
    ref_static = ref_sc.enumerate_cells()[:2]
    ref = ref_matrix.run_matrix(ref_static + [ref_sc.MATRIX_DRIFT_CELLS[0]], seeds=(0,),
                                **kw(ref_sc))
    return port, ref


def test_port_record_has_the_reference_keys(records):
    port, ref = records
    assert sorted(port) == sorted(ref)
    assert sorted(port["wall_clock_s"]) == sorted(ref["wall_clock_s"])
    assert port["quick"] is False and port["engine"] == "batched"
    assert "repro_torch" in port["regenerate"]
    assert all(round(v, 4) == v for v in port["wall_clock_s"].values())
    assert port["summary"] == ref["summary"]
    assert score_floors(port) == ref_matrix.score_floors(ref)


def test_port_record_validates(records, checker):
    port, _ = records
    validate_matrix_record(port)
    assert markdown_report(port).startswith("# Scenario matrix\n\n2 cells · iters=10 · "
                                            "seeds=[0] · quick=False\n")


def test_port_fleet_record_validates(checker):
    rec = run_fleet(n_twins=8, seed=0, iters=12, window=6, device="cpu")
    payload = {  # as benchmarks/fleet_bench.py wraps the reference's
        "schema_version": 1,
        "regenerate": "PYTHONPATH=src python -c 'from repro_torch.experiments.fleet "
                      "import run_fleet; run_fleet(8, iters=12, window=6)'",
        "quick": True,
        "results": rec["results"],
        "engine": rec["engine"],
    }
    validate_fleet_record(payload)


def test_fleet_figure_without_matplotlib(monkeypatch, tmp_path):
    out = tmp_path / "fleet.png"
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert fleet_convergence_figure(FLEET, str(out)) is None
    assert not out.exists()


def test_fleet_figure_with_matplotlib(tmp_path):
    pytest.importorskip("matplotlib")
    out = tmp_path / "fleet.png"
    assert fleet_convergence_figure(FLEET, str(out)) == str(out)
    assert out.stat().st_size > 0


def test_experiments_export_what_the_reference_exports():
    import types

    import repro.experiments
    import repro_torch.experiments

    def exports(package):
        return {name for name, v in vars(package).items()
                if not name.startswith("_") and not isinstance(v, types.ModuleType)}

    missing = exports(repro.experiments) - exports(repro_torch.experiments)
    assert missing == set(), missing
    assert repro_torch.experiments.score_floors is score_floors
