"""The port's batched episode engine and static matrix, on the CPU: held to
the port's own scalar spec (the byte-identity contract inside the port)
and to the JAX package's records.

Tolerances. Chosen configs, flags and counts: exact. τ, p and rewards:
rel 1e-12 (both engines rebuild them in float64 from the same landscape ×
noise products, so they agree exactly; the bound only names the float64
contract). Records against the reference: the same, through
``matrix.diff_records``.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from repro.experiments import matrix as ref_matrix
from repro.experiments import scenarios as ref_sc
from repro_torch.core.baselines import alert_online, preset
from repro_torch.core.episode import (
    alert_online_outcome,
    preset_outcome,
    run_coral_batch,
    run_static_requests,
)
from repro_torch.core.evaluate import CellSpec, run_cell, run_regime
from repro_torch.experiments import matrix
from repro_torch.experiments import scenarios as sc

ROOT = Path(__file__).resolve().parents[1]
SEEDS = (0, 1, 2)
DUAL_CELL = sc.Cell("edge-xavier-nx", "qwen2.5-3b", "decode_steady", "strict_dual")
THROUGHPUT_CELL = sc.Cell("edge-orin-nano", "granite-8b", "decode_steady", "max_throughput")
GRID54 = sc.enumerate_cells(workloads=sc.FULL_MATRIX_WORKLOADS)


@pytest.mark.parametrize("cell", [DUAL_CELL, THROUGHPUT_CELL], ids=["dual", "throughput"])
def test_batched_engine_matches_scalar_spec(cell):
    sim0 = sc.cell_simulator(cell, noise=0.0)
    targets = sc.resolve_targets(cell, sim0)
    land_tau, land_p = sim0.exact_all()
    noise = sc.WORKLOADS[cell.workload].noise
    eps = run_coral_batch(sim0.space, land_tau, land_p, targets, SEEDS, noise=noise,
                          device="cpu")
    for seed, ep in zip(SEEDS, eps):
        out, tr = run_regime(sim0.space, sc.cell_simulator(cell, seed=seed), targets,
                             seed=seed, device="cpu")
        assert [tuple(c) for c in tr.configs] == [tuple(c) for c in ep.configs]
        np.testing.assert_allclose(tr.taus, ep.taus, rtol=1e-12)
        np.testing.assert_allclose(tr.powers, ep.powers, rtol=1e-12)
        np.testing.assert_allclose(tr.rewards, ep.rewards, rtol=1e-12)
        assert tuple(out.config) == tuple(ep.outcome.config)
        assert out.tau == pytest.approx(ep.outcome.tau, rel=1e-12)
        assert out.power == pytest.approx(ep.outcome.power, rel=1e-12)


def test_episode_alone_equals_episode_in_batch():
    """An episode chooses the same configs alone as inside a batch that
    mixes both matrix grids and both modes."""
    reqs = []
    for cell in (DUAL_CELL, THROUGHPUT_CELL):
        prep = matrix._prep_cell(cell)
        reqs += matrix._static_requests(prep, SEEDS)
    batch = run_static_requests(reqs, device="cpu")
    for i in (0, 4):
        alone = run_static_requests([reqs[i]], device="cpu")[0]
        assert alone.configs == batch[i].configs and alone.taus == batch[i].taus


@pytest.mark.parametrize("kind", ["max_power", "default", "min_power"])
def test_preset_outcome_matches_scalar_baseline(kind):
    sim0 = sc.cell_simulator(DUAL_CELL, noise=0.0)
    land_tau, land_p = sim0.exact_all()
    got = preset_outcome(sim0.space, land_tau, land_p, kind, 0.02, 103)
    want = preset(sim0.space, sc.cell_simulator(DUAL_CELL, seed=103), kind)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("cell", [DUAL_CELL, THROUGHPUT_CELL], ids=["dual", "throughput"])
def test_alert_online_outcome_matches_scalar_baseline(cell):
    sim0 = sc.cell_simulator(cell, noise=0.0)
    targets = sc.resolve_targets(cell, sim0)
    land_tau, land_p = sim0.exact_all()
    got = alert_online_outcome(sim0.space, land_tau, land_p, targets, 0.02, 102)
    want = alert_online(sim0.space, sc.cell_simulator(cell, seed=102), targets.tau_target,
                        targets.p_budget, seed=102)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


SIX_CELLS = [
    sc.Cell(d, "qwen2.5-3b", "decode_steady", r)
    for d in sc.MATRIX_DEVICES for r in sc.MATRIX_REGIMES
]


@pytest.mark.parametrize("cell", SIX_CELLS, ids=lambda c: f"{c.device}-{c.regime}")
@pytest.mark.parametrize("engine", matrix.ENGINES)
def test_static_cell_record_equals_the_reference(cell, engine):
    got = matrix.run_static_cell(cell, engine=engine, device="cpu")
    want = ref_matrix.run_static_cell(ref_sc.Cell(*cell.key()), engine="scalar")
    assert matrix.diff_records(got, want) == []


def test_grid_of_54_cells_reproduces_the_committed_record():
    """The whole static grid, one batched call of 162 episodes, against
    BENCH_matrix.json ``cells`` and its summary."""
    ref = json.loads((ROOT / "BENCH_matrix.json").read_text())
    rec = matrix.run_matrix(GRID54, device="cpu")
    assert len(rec["cells"]) == 54 == len(ref["cells"])
    diffs = [d for got, want in zip(rec["cells"], ref["cells"])
             for d in matrix.diff_records(got, want)]
    assert diffs == []
    static_keys = ("n_cells", "mean_coral_score", "min_single_target_score",
                   "dual_power_violations", "dual_tau_miss_cells")
    assert matrix.diff_records({k: rec["summary"][k] for k in static_keys},
                               {k: ref["summary"][k] for k in static_keys}) == []
    assert rec["summary"]["dual_power_violations"] == 0
    assert rec["drift_cells"] == [] and rec["fault_cells"] == []


def test_run_cell_runs_a_static_cell():
    rec = run_cell(CellSpec(DUAL_CELL, seeds=(0,)), device="cpu")
    assert rec.family == "static" and rec.record["regime"] == "strict_dual"
    assert rec.record["coral"]["measurements"] == 10


@pytest.mark.parametrize("regime,item", [("offload_mmpp", 9), ("cotenant_balanced", 10)])
def test_run_matrix_raises_on_cells_not_ported_yet(regime, item):
    cell = sc.Cell("edge-orin-nano", "qwen2.5-3b", "decode_steady", regime)
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        matrix.run_matrix([DUAL_CELL, cell], device="cpu")
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        run_cell(CellSpec(cell), device="cpu")


def test_diff_records_reports_what_differs():
    want = {"a": [1.0, 2.0], "b": True, "c": None}
    assert matrix.diff_records({"a": [1.0, 2.0 * (1 + 1e-13)], "b": True, "c": None}, want) == []
    assert matrix.diff_records({"a": [1.0, 2.1], "b": True, "c": None}, want) == [
        ".a[1]: 2.1 != 2.0 (rel 1e-12)"]
    assert matrix.diff_records({"a": [1.0], "b": 1, "c": None}, want) == [
        ".a: length 1 != 2", ".b: 1 != True"]


def test_unknown_engine_is_refused():
    with pytest.raises(ValueError, match="engine"):
        matrix.run_static_cell(DUAL_CELL, engine="compiled", device="cpu")
