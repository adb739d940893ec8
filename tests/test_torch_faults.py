"""The port's fault episodes on the CPU: fault realization and the faulty
twin against the JAX package's, the MAD ingest gate batched against its
scalar form, the batched engine's fault step against the JAX package's
compiled engine and against the port's own scalar spec (an ablation
episode among them whose dCor windows hold NaN), and the six fault cells
against ``BENCH_matrix.json``.

Tolerances. Fault tables and twin traces (plain numpy copies): bitwise,
NaN at the same places. Row traces, accepted / fallback flags and picks:
exact. τ/p telemetry: rel 1e-12 with NaN at the same places (both engines
rebuild it in float64 from the same products). Records against the
committed one: the same, through ``matrix.diff_records``.
"""
import dataclasses
import json
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from repro.core import faults as ref_faults
from repro.core.episode import run_fault_requests as ref_run_fault_requests
from repro.experiments import matrix as ref_matrix
from repro.experiments import scenarios as ref_sc
from repro_torch.core import dcov as core_dcov
from repro_torch.core.episode import run_fault_requests
from repro_torch.core.evaluate import CellSpec, run_cell, run_fault_regime
from repro_torch.core.faults import (
    FaultSchedule,
    PodLinkOutage,
    mad_reject_batch,
    mad_reject_trace,
)
from repro_torch.experiments import matrix
from repro_torch.experiments import scenarios as sc

ROOT = Path(__file__).resolve().parents[1]
RECORD = json.loads((ROOT / "BENCH_matrix.json").read_text())
FAULT_KEYS = ("n_fault_cells", "min_fault_hardened_score", "fault_power_violations",
              "fault_feasible_ablations")
TABLE_FIELDS = ("drop", "spike", "stick", "reset", "pod_out")
# one cell per fault regime: telemetry storm (Xavier NX), sensor blackout
# and flaky actuator (Orin Nano)
ONE_PER_REGIME = [sc.MATRIX_FAULT_CELLS[i] for i in (0, 3, 5)]
VARIANTS = [(cell, hardened) for cell in ONE_PER_REGIME for hardened in (True, False)]
T = sc.FAULT_INTERVALS


def variant_id(v):
    cell, hardened = v
    return f"{cell.regime}-{'hardened' if hardened else 'ablation'}"


def ref_cell(cell):
    return ref_sc.Cell(*cell.key())


def assert_same_tables(a, b):
    for f in TABLE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fault", sorted(sc.FAULTS))
def test_fault_tables_equal_the_reference(fault, seed):
    assert_same_tables(sc.FAULTS[fault].realize(T, seed),
                       ref_sc.FAULTS[fault].realize(T, seed))


@pytest.mark.parametrize("fault", sorted(sc.FAULTS))
def test_fault_tables_are_prefix_stable(fault):
    """Appending an event (a pod-link outage) leaves every other event's
    draws where they were, in both packages alike."""
    sched = sc.FAULTS[fault]
    grown = FaultSchedule(sched.name, sched.events + (PodLinkOutage(start=5, stop=9),))
    ref_grown = ref_faults.FaultSchedule(
        sched.name, ref_sc.FAULTS[fault].events + (ref_faults.PodLinkOutage(5, 9),))
    a, g = sched.realize(T, 3), grown.realize(T, 3)
    for f in ("drop", "spike", "stick", "reset"):
        assert getattr(a, f).tobytes() == getattr(g, f).tobytes(), f
    assert not a.pod_out.any() and g.pod_out[5:9].all() and g.pod_out.sum() == 4
    assert_same_tables(g, ref_grown.realize(T, 3))


@pytest.mark.parametrize("cell", ONE_PER_REGIME, ids=lambda c: c.regime)
def test_faulty_twin_trace_equals_the_reference(cell):
    """Commands from a seeded stream, retry budgets of 0 and 3 in turn:
    the config in force and the (τ, p) telemetry, interval by interval."""
    twin = sc.fault_cell_simulator(cell, seed=1)
    ref_twin = ref_sc.fault_cell_simulator(ref_cell(cell), seed=1)
    rng = np.random.default_rng(4)
    for t in range(T):
        cmd = twin.space.random(rng)
        twin.set_time(t)
        ref_twin.set_time(t)
        applied = twin.actuate(cmd, retries=3 * (t % 2))
        assert applied == ref_twin.actuate(cmd, retries=3 * (t % 2))
        assert twin.readback() == ref_twin.readback()
        got, want = np.asarray(twin.measure(applied)), np.asarray(ref_twin.measure(applied))
        assert got.tobytes() == want.tobytes()


def test_mad_gate_batched_equals_its_scalar_form():
    """Each row of ``mad_reject_batch`` equals ``mad_reject_trace`` on that
    row alone, over windows of every fill level with spiked samples."""
    rng = np.random.default_rng(0)
    b, w = 64, 10
    win = rng.lognormal(3.0, 0.1, size=(b, w, 2)).astype(np.float32)
    n_valid = rng.integers(0, w + 1, size=b)
    x = rng.lognormal(3.0, 0.1, size=(b, 2)) * np.where(rng.random((b, 1)) < 0.3, 1000.0, 1.0)
    x = x.astype(np.float32)
    x[::7, 0] = np.nan
    g, e = torch.tensor(2.5), torch.tensor(np.float32(0.7))
    got = mad_reject_batch(torch.from_numpy(win[:, :, 0]), torch.from_numpy(win[:, :, 1]),
                           torch.from_numpy(n_valid), torch.from_numpy(x[:, 0]),
                           torch.from_numpy(x[:, 1]), g, e, 5)
    want = [mad_reject_trace(torch.from_numpy(win[i, :, 0]), torch.from_numpy(win[i, :, 1]),
                             int(n_valid[i]), torch.tensor(x[i, 0]), torch.tensor(x[i, 1]),
                             g, e, 5) for i in range(b)]
    assert got.tolist() == want and 0 < sum(want) < b


def _requests(mat, scen):
    reqs = []
    for cell in ONE_PER_REGIME:
        prep = mat._prep_fault_cell(scen.Cell(*cell.key()), scen.FAULT_INTERVALS, (0,))
        for hardened in (True, False):
            reqs += mat._fault_requests(prep, (0,), hardened)
    return reqs


@pytest.fixture(scope="module")
def engines():
    """One batch of the six variants (seed 0) through the port's batched
    engine — with every window that reaches the dcov kernel's plain
    version kept — and through the JAX package's compiled engine."""
    windows = []
    gram = core_dcov.dcov_gram_windows

    def kept(cols, n_valid):
        windows.append((cols.clone(), n_valid.clone()))
        return gram(cols, n_valid)

    with mock.patch.object(core_dcov, "dcov_gram_windows", kept):
        got = run_fault_requests(_requests(matrix, sc), iters=T, device="cpu")
    want = ref_run_fault_requests(_requests(ref_matrix, ref_sc), iters=T)
    return got, want, windows


@pytest.mark.parametrize("i", range(len(VARIANTS)), ids=[variant_id(v) for v in VARIANTS])
def test_batched_fault_engine_equals_the_jax_engine(engines, i):
    got, want = engines[0][i], engines[1][i]
    for key in ("commanded", "applied", "accepted", "fallback", "n_obs", "result_config"):
        assert got[key] == want[key], key
    for key in ("rec_idx", "rec_t"):
        assert np.array_equal(got[key], want[key]), key
    for key in ("taus", "powers"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)  # NaN at the same places
    assert dataclasses.astuple(got["outcome"]) == dataclasses.astuple(want["outcome"])


def test_an_ablation_window_holds_nan(engines):
    """Dropped samples the ablation swallows raw reach the dCor window —
    NaN in a valid row of some episode's window — and the decisions above
    still equal the JAX engine's."""
    got, _, windows = engines
    ablation = [i for i, (_, hardened) in enumerate(VARIANTS) if not hardened]
    assert any(np.isnan(got[i]["taus"][: T - 1]).any() for i in ablation)
    nan_in_valid = [
        bool((torch.isnan(cols).any(dim=2)
              & (torch.arange(cols.shape[1])[None, :] < n[:, None]))[ablation].any())
        for cols, n in windows
    ]
    assert len(windows) == T and any(nan_in_valid)
    hardened = [i for i, (_, h) in enumerate(VARIANTS) if h]
    assert not any(torch.isnan(cols[hardened]).any() for cols, _ in windows)


@pytest.mark.parametrize("i", range(len(VARIANTS)), ids=[variant_id(v) for v in VARIANTS])
def test_scalar_spec_equals_the_batched_engine(engines, i):
    cell, hardened = VARIANTS[i]
    got = engines[0][i]
    prep = matrix._prep_fault_cell(cell, T, (0,))
    opt, tr = run_fault_regime(
        prep["space"], sc.fault_cell_simulator(cell, seed=0), prep["targets"], iters=T,
        seed=0, hardened=hardened, device="cpu",
    )
    assert [tuple(c) for c in tr.commanded] == got["commanded"]
    assert [tuple(c) for c in tr.applied] == got["applied"]
    assert tr.accepted == got["accepted"] and tr.fallback == got["fallback"]
    np.testing.assert_allclose(tr.taus, got["taus"], rtol=1e-12)
    np.testing.assert_allclose(tr.powers, got["powers"], rtol=1e-12)
    res = opt.result()
    assert (res.config if res is not None else None) == got["result_config"]


@pytest.mark.parametrize("engine", matrix.ENGINES)
@pytest.mark.parametrize("i", range(len(sc.MATRIX_FAULT_CELLS)),
                         ids=[f"{c.device}-{c.model}-{c.regime}" for c in sc.MATRIX_FAULT_CELLS])
def test_fault_cell_record_equals_the_committed_one(i, engine):
    got = matrix.run_fault_cell(sc.MATRIX_FAULT_CELLS[i], engine=engine, device="cpu")
    assert matrix.diff_records(got, RECORD["fault_cells"][i]) == []


@pytest.mark.parametrize("engine", matrix.ENGINES)
def test_fault_summary_equals_the_committed_one(engine):
    rec = matrix.run_matrix([], fault_cells=sc.MATRIX_FAULT_CELLS, engine=engine,
                            device="cpu")
    assert rec["cells"] == [] and rec["drift_cells"] == []
    got = {k: rec["summary"][k] for k in FAULT_KEYS}
    assert matrix.diff_records(got, {k: RECORD["summary"][k] for k in FAULT_KEYS}) == []
    assert matrix.diff_records(rec["fault_cells"], RECORD["fault_cells"]) == []
    assert rec["summary"]["fault_feasible_ablations"] == 0
    assert rec["summary"]["min_fault_hardened_score"] >= matrix.FAULT_CORAL_GATE
    assert rec["summary"]["fault_power_violations"] == 0


def test_run_cell_runs_a_fault_cell():
    rec = run_cell(CellSpec(sc.MATRIX_FAULT_CELLS[5], seeds=(0,)), device="cpu")
    assert rec.family == "fault" and rec.record["fault"]["schedule"] == "flaky-actuator"
    assert rec.record["fault"]["intervals"] == T
