"""The port's drift episodes on the CPU: the drift schedules and the
drifting twin against the JAX package's, the batched engine's drift step
against the JAX package's compiled engine and against the port's own
scalar spec, and the six drift cells against ``BENCH_matrix.json``.

Tolerances. Schedules, landscapes (plain numpy copies): bitwise. Row
traces, exploring flags, resets and picks: exact. τ, p and budget traces:
rel 1e-12 (both engines rebuild them in float64 from the same landscape ×
noise products, so they agree exactly; the bound names the float64
contract). Records against the committed one: the same, through
``matrix.diff_records``.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from repro.core.episode import run_drift_requests as ref_run_drift_requests
from repro.experiments import matrix as ref_matrix
from repro.experiments import scenarios as ref_sc
from repro_torch.core.episode import run_drift_requests
from repro_torch.core.evaluate import CellSpec, run_cell, run_drift_regime
from repro_torch.experiments import matrix
from repro_torch.experiments import scenarios as sc

ROOT = Path(__file__).resolve().parents[1]
RECORD = json.loads((ROOT / "BENCH_matrix.json").read_text())
DRIFT_KEYS = ("n_drift_cells", "min_drift_adaptive_score", "max_drift_static_score",
              "min_drift_separation")
# one cell per drift regime: thermal ramp (Orin NX), co-tenant (Orin NX),
# budget step (Orin Nano)
ONE_PER_REGIME = [sc.MATRIX_DRIFT_CELLS[i] for i in (0, 2, 4)]
VARIANTS = [(cell, adaptive) for cell in ONE_PER_REGIME for adaptive in (True, False)]


def variant_id(v):
    cell, adaptive = v
    return f"{cell.regime}-{'adaptive' if adaptive else 'static'}"


def ref_cell(cell):
    return ref_sc.Cell(*cell.key())


def first_cell(drift):
    return next(c for c in sc.MATRIX_DRIFT_CELLS if sc.REGIMES[c.regime].drift == drift)


@pytest.mark.parametrize("t", [0, 19, 20, 23, 26, 63])
@pytest.mark.parametrize("drift", sorted(sc.DRIFTS))
def test_drift_state_and_landscape_equal_the_reference(drift, t):
    got, want = sc.DRIFTS[drift].state_at(t), ref_sc.DRIFTS[drift].state_at(t)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    cell = first_cell(drift)
    twin = sc.drifting_cell_simulator(cell, noise=0.0)
    ref_twin = ref_sc.drifting_cell_simulator(ref_cell(cell), noise=0.0)
    twin.set_time(t)
    ref_twin.set_time(t)
    for a, b in zip(twin.exact_all(), ref_twin.exact_all()):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _requests(mat, scen):
    reqs = []
    for cell in ONE_PER_REGIME:
        prep = mat._prep_drift_cell(scen.Cell(*cell.key()), scen.DRIFT_INTERVALS)
        for adaptive in (True, False):
            reqs += mat._drift_requests(prep, (0,), adaptive)
    return reqs


@pytest.fixture(scope="module")
def engines():
    """One batch of the six variants (seed 0) through the port's batched
    engine and through the JAX package's compiled engine."""
    got = run_drift_requests(_requests(matrix, sc), intervals=sc.DRIFT_INTERVALS,
                             device="cpu")
    want = ref_run_drift_requests(_requests(ref_matrix, ref_sc),
                                  intervals=ref_sc.DRIFT_INTERVALS)
    return got, want


def assert_same_episode(got, want):
    assert [tuple(c) for c in got.configs] == [tuple(c) for c in want.configs]
    assert list(got.exploring) == list(want.exploring)
    assert got.resets == want.resets
    np.testing.assert_allclose(got.taus, want.taus, rtol=1e-12)
    np.testing.assert_allclose(got.powers, want.powers, rtol=1e-12)
    np.testing.assert_allclose(got.budgets, want.budgets, rtol=1e-12)
    assert got.result_config == want.result_config
    assert got.outcome.tau == pytest.approx(want.outcome.tau, rel=1e-12)
    assert got.outcome.power == pytest.approx(want.outcome.power, rel=1e-12)


@pytest.mark.parametrize("i", range(len(VARIANTS)), ids=[variant_id(v) for v in VARIANTS])
def test_batched_drift_engine_equals_the_jax_engine(engines, i):
    got, want = engines
    assert_same_episode(got[i], want[i])


@pytest.mark.parametrize("i", range(len(VARIANTS)), ids=[variant_id(v) for v in VARIANTS])
def test_scalar_spec_equals_the_batched_engine(engines, i):
    cell, adaptive = VARIANTS[i]
    ep = engines[0][i]
    prep = matrix._prep_drift_cell(cell, sc.DRIFT_INTERVALS)
    opt, tr = run_drift_regime(
        prep["space"], sc.drifting_cell_simulator(cell, seed=0), prep["targets"],
        prep["schedule"], sc.DRIFT_INTERVALS, seed=0, adaptive=adaptive,
        sigma=prep["noise"], device="cpu",
    )
    assert [tuple(c) for c in tr.configs] == [tuple(c) for c in ep.configs]
    assert tr.exploring == ep.exploring and tr.resets == ep.resets
    np.testing.assert_allclose(tr.taus, ep.taus, rtol=1e-12)
    np.testing.assert_allclose(tr.powers, ep.powers, rtol=1e-12)
    np.testing.assert_allclose(tr.budgets, ep.budgets, rtol=1e-12)
    res = opt.result()
    assert (res.config if res is not None else None) == ep.result_config


@pytest.mark.parametrize("engine", matrix.ENGINES)
@pytest.mark.parametrize("i", range(len(sc.MATRIX_DRIFT_CELLS)),
                         ids=[f"{c.device}-{c.model}-{c.regime}" for c in sc.MATRIX_DRIFT_CELLS])
def test_drift_cell_record_equals_the_committed_one(i, engine):
    got = matrix.run_drift_cell(sc.MATRIX_DRIFT_CELLS[i], engine=engine, device="cpu")
    assert matrix.diff_records(got, RECORD["drift_cells"][i]) == []


@pytest.mark.parametrize("engine", matrix.ENGINES)
def test_drift_summary_equals_the_committed_one(engine):
    rec = matrix.run_matrix(list(sc.MATRIX_DRIFT_CELLS), engine=engine, device="cpu")
    assert rec["cells"] == [] and rec["fault_cells"] == []
    got = {k: rec["summary"][k] for k in DRIFT_KEYS}
    assert matrix.diff_records(got, {k: RECORD["summary"][k] for k in DRIFT_KEYS}) == []
    assert matrix.diff_records(rec["drift_cells"], RECORD["drift_cells"]) == []
    sm = rec["summary"]  # the acceptance levels the drift cells are built to clear
    assert sm["min_drift_adaptive_score"] >= matrix.DRIFT_ADAPTIVE_GATE
    assert sm["max_drift_static_score"] <= matrix.DRIFT_STATIC_CEILING
    assert sm["min_drift_separation"] >= matrix.DRIFT_SEPARATION


def test_run_cell_runs_a_drift_cell():
    rec = run_cell(CellSpec(sc.MATRIX_DRIFT_CELLS[4], seeds=(0,)), device="cpu")
    assert rec.family == "drift" and rec.record["drift"]["schedule"] == "budget-step"
    assert rec.record["drift"]["intervals"] == sc.DRIFT_INTERVALS
