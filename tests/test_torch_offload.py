"""The port's edge↔pod offload cells on the CPU: the joint offload grid,
the link model and the offload twin against the JAX package's, the
batched engine against the JAX package's compiled engine and against the
port's own scalar spec, and the four offload cells against
``BENCH_matrix.json``.

Tolerances. Spaces, twins, demands and targets (plain numpy copies):
bitwise. Config sequences: exact. τ, p and rewards against the scalar
spec: identical (rel 0: both rebuild them in float64 from the same
landscape × noise products); against the JAX engine: rel 1e-12. Records
against the committed one: rel 1e-12, through ``matrix.diff_records``.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from repro.core import space as ref_space
from repro.core.episode import run_static_requests as ref_run_static_requests
from repro.device import network as ref_network
from repro.experiments import matrix as ref_matrix
from repro.experiments import scenarios as ref_sc
from repro_torch.core import search, space
from repro_torch.core.episode import run_static_requests
from repro_torch.core.evaluate import CellSpec, run_cell, run_regime
from repro_torch.device import network
from repro_torch.device.factory import build_twin
from repro_torch.experiments import matrix
from repro_torch.experiments import scenarios as sc

ROOT = Path(__file__).resolve().parents[1]
RECORD = json.loads((ROOT / "BENCH_matrix.json").read_text())
SEEDS = (0, 1, 2)
CELLS = sc.MATRIX_OFFLOAD_CELLS
OFFLOAD_KEYS = ("n_offload_cells", "min_offload_score", "offload_power_violations",
                "offload_feasible_baselines")


def cell_id(c):
    return f"{c.device}-{c.model}-{c.regime}"


def ref_cell(cell):
    return ref_sc.Cell(*cell.key())


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind", ["edge_xavier_nx", "edge_orin_nano", "edge_orin_nx"])
def test_offload_space_equals_the_reference(kind):
    got, want = space.offload_space(kind), ref_space.offload_space(kind)
    assert got.names == want.names and same_bits(got.grid(), want.grid())
    assert space.OFFLOAD_DIM == ref_space.OFFLOAD_DIM == got.names[3]
    # no cores knob: Alg. 2's cores-role mask is all false on this grid
    assert not np.asarray(search.role_mask(got, space.CORES_DIM_CANDIDATES)).any()


def test_network_registry_equals_the_reference():
    assert sorted(network.NETWORKS) == sorted(ref_network.NETWORKS)
    for name in network.NETWORKS:
        got, want = network.get_network(name), ref_network.get_network(name)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert (got.ship_energy_j, got.uplink_items_s) == (want.ship_energy_j,
                                                          want.uplink_items_s)
    with pytest.raises(KeyError, match="unknown network profile"):
        network.get_network("dial-up")


SCHEDULES = {
    "none": lambda m: m.NO_DEGRADATION,
    "degrade": lambda m: m.NetworkSchedule((m.LinkDegrade(4, until=9),)),
    "degrade+ramp": lambda m: m.NetworkSchedule(
        (m.LinkDegrade(3, bw_scale=0.3), m.RttRamp(5, duration=4, rtt_inflation=2.0))),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_link_schedule_and_degraded_twin_equal_the_reference(name):
    got, want = SCHEDULES[name](network), SCHEDULES[name](ref_network)
    a, b = got.states_stacked(16), want.states_stacked(16)
    assert sorted(a) == sorted(b) and all(same_bits(a[k], b[k]) for k in a)
    assert (got.shift_start, got.shift_end) == (want.shift_start, want.shift_end)
    cell = CELLS[0]
    twin = sc.offload_cell_simulator(cell, noise=0.0)
    ref_twin = ref_sc.offload_cell_simulator(ref_cell(cell), noise=0.0)
    twin.schedule, ref_twin.schedule = got, want
    for t in (0, 4, 7, 12):
        twin.set_time(t)
        ref_twin.set_time(t)
        assert dataclasses.astuple(twin.state) == dataclasses.astuple(ref_twin.state)
        for x, y in zip(twin.exact_all(), ref_twin.exact_all()):
            assert same_bits(x, y)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_offload_twin_equals_the_reference(cell, seed):
    twin = sc.offload_cell_simulator(cell, seed=seed)
    ref_twin = ref_sc.offload_cell_simulator(ref_cell(cell), seed=seed)
    assert isinstance(build_twin(cell, seed=seed), network.OffloadSimulator)
    assert twin.demand == ref_twin.demand and twin.noise == ref_twin.noise
    assert twin.edge_only_max() == ref_twin.edge_only_max()
    for got, want in ((twin.exact_all(), ref_twin.exact_all()),
                      (twin.capacity_all(), ref_twin.capacity_all()),
                      (twin.offload_cap(np.asarray([470.0, 658.0, 940.0])),
                       ref_twin.offload_cap(np.asarray([470.0, 658.0, 940.0])))):
        for a, b in zip(np.atleast_1d(got), np.atleast_1d(want)):
            assert same_bits(a, b)
    rows = twin.space.grid()[seed::7]
    for a, b in zip(twin.measure_all(rows), ref_twin.measure_all(rows)):
        assert same_bits(a, b)
    cfg = tuple(rows[3])
    assert twin.measure(cfg) == ref_twin.measure(cfg)
    assert twin.n_measurements == ref_twin.n_measurements


@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_offload_targets_equal_the_reference(cell):
    got = sc.resolve_offload_targets(cell)
    want = ref_sc.resolve_offload_targets(ref_cell(cell))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.tau_target == RECORD["offload_cells"][CELLS.index(cell)]["tau_target"]


def _quick_requests(mat, scen):
    reqs = []
    for cell in sc.QUICK_OFFLOAD_CELLS:
        reqs += mat._static_requests(mat._prep_offload_cell(scen.Cell(*cell.key())), SEEDS)
    return reqs


@pytest.fixture(scope="module")
def quick_engines():
    """The QUICK offload cells × 3 seeds, one batch each, through the
    port's batched engine and through the JAX package's compiled one."""
    got = run_static_requests(_quick_requests(matrix, sc), iters=matrix.OFFLOAD_ITERS,
                              device="cpu")
    want = ref_run_static_requests(_quick_requests(ref_matrix, ref_sc),
                                   iters=ref_matrix.OFFLOAD_ITERS)
    return got, want


@pytest.mark.parametrize("i", range(2 * len(SEEDS)),
                         ids=[f"{cell_id(c)}-seed{s}" for c in sc.QUICK_OFFLOAD_CELLS
                              for s in SEEDS])
def test_batched_engine_equals_the_jax_engine(quick_engines, i):
    got, want = quick_engines[0][i], quick_engines[1][i]
    assert len(got.configs) == matrix.OFFLOAD_ITERS
    assert [tuple(c) for c in got.configs] == [tuple(c) for c in want.configs]
    np.testing.assert_allclose(got.taus, want.taus, rtol=1e-12)
    np.testing.assert_allclose(got.powers, want.powers, rtol=1e-12)
    np.testing.assert_allclose(got.rewards, want.rewards, rtol=1e-12)
    assert tuple(got.outcome.config) == tuple(want.outcome.config)


@pytest.fixture(scope="module")
def batched_runs():
    """Every offload cell × seed, one batched call (the matrix's)."""
    preps = {c: matrix._prep_offload_cell(c) for c in CELLS}
    runs = matrix._static_runs(preps, SEEDS, matrix.OFFLOAD_ITERS, 10, "batched", "cpu")
    return preps, runs


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_scalar_spec_equals_the_batched_engine(batched_runs, cell, seed):
    preps, runs = batched_runs
    ep_out, ep_tr = runs[cell][SEEDS.index(seed)]
    out, tr = run_regime(preps[cell]["space"], build_twin(cell, seed=seed),
                         preps[cell]["targets"], iters=matrix.OFFLOAD_ITERS, seed=seed,
                         device="cpu")
    assert [tuple(c) for c in tr.configs] == [tuple(c) for c in ep_tr.configs]
    assert (tr.taus, tr.powers, tr.rewards) == (ep_tr.taus, ep_tr.powers, ep_tr.rewards)
    assert dataclasses.astuple(out) == dataclasses.astuple(ep_out)


@pytest.mark.parametrize("engine", matrix.ENGINES)
@pytest.mark.parametrize("i", range(len(CELLS)), ids=[cell_id(c) for c in CELLS])
def test_offload_cell_record_equals_the_committed_one(i, engine):
    got = matrix.run_offload_cell(CELLS[i], engine=engine, device="cpu")
    assert matrix.diff_records(got, RECORD["offload_cells"][i]) == []


@pytest.mark.parametrize("engine", matrix.ENGINES)
def test_offload_summary_equals_the_committed_one(engine):
    rec = matrix.run_matrix([], offload_cells=CELLS, engine=engine, device="cpu")
    assert rec["cells"] == rec["cotenant_cells"] == rec["fault_cells"] == []
    assert matrix.diff_records(rec["offload_cells"], RECORD["offload_cells"]) == []
    got = {k: rec["summary"][k] for k in OFFLOAD_KEYS}
    assert matrix.diff_records(got, {k: RECORD["summary"][k] for k in OFFLOAD_KEYS}) == []
    # what the offload cells are built to show
    assert got["min_offload_score"] >= matrix.OFFLOAD_CORAL_GATE
    assert got["offload_power_violations"] == got["offload_feasible_baselines"] == 0
    assert rec["grid"]["offload_regimes"] == ["offload_diurnal", "offload_mmpp"]


def test_run_cell_runs_an_offload_cell():
    rec = run_cell(CellSpec(CELLS[1], seeds=(0,)), device="cpu")
    assert rec.family == "offload" and rec.record["offload"]["network"] == "lte-uplink"
    assert rec.record["coral"]["measurements"] == matrix.OFFLOAD_ITERS
    assert rec.record["space_size"] == 360


@pytest.mark.parametrize("engine", matrix.ENGINES)
@pytest.mark.parametrize("family", ["offload_cells", "cotenant_cells"])
def test_no_card_raises_rather_than_running_on_the_cpu(family, engine):
    """``device="cuda"`` (the default) on a machine with no card raises;
    it never runs quietly on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this holds the machine without one")
    cell = {"offload_cells": CELLS, "cotenant_cells": sc.MATRIX_COTENANT_CELLS}[family][0]
    with pytest.raises((AssertionError, RuntimeError)):
        matrix.run_matrix([], **{family: [cell]}, engine=engine)
