"""The port's multi-tenant cotenant cells on the CPU: the joint slots ×
shared-DVFS grid and the cotenant twin against the JAX package's, the
batched engine against the JAX package's compiled engine and against the
port's own scalar spec, the four cotenant cells against
``BENCH_matrix.json`` — and the whole committed record, every family,
through the port's ``run_matrix``.

Tolerances. Spaces, twins, floors and targets (plain numpy copies):
bitwise. Config sequences: exact. Headroom, p and rewards against the
scalar spec: identical (rel 0); against the JAX engine: rel 1e-12.
Records against the committed one: rel 1e-12, through
``matrix.diff_records``.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from repro.core import space as ref_space
from repro.core.episode import run_static_requests as ref_run_static_requests
from repro.experiments import matrix as ref_matrix
from repro.experiments import scenarios as ref_sc
from repro_torch.core import search, space
from repro_torch.core.episode import run_static_requests
from repro_torch.core.evaluate import CellSpec, run_cell, run_regime
from repro_torch.device.cotenant import CotenantSimulator
from repro_torch.device.factory import build_twin
from repro_torch.experiments import matrix
from repro_torch.experiments import scenarios as sc

ROOT = Path(__file__).resolve().parents[1]
RECORD = json.loads((ROOT / "BENCH_matrix.json").read_text())
SEEDS = (0, 1, 2)
CELLS = sc.MATRIX_COTENANT_CELLS
COTENANT_KEYS = ("n_cotenant_cells", "min_cotenant_score", "cotenant_power_violations",
                 "cotenant_feasible_baselines")


def cell_id(c):
    return f"{c.device}-{c.model}-{c.regime}"


def ref_cell(cell):
    return ref_sc.Cell(*cell.key())


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n_tenants", [2, 3])
@pytest.mark.parametrize("kind", ["edge_xavier_nx", "edge_orin_nano", "edge_orin_nx"])
def test_cotenant_space_equals_the_reference(kind, n_tenants):
    got = space.cotenant_space(kind, n_tenants=n_tenants)
    want = ref_space.cotenant_space(kind, n_tenants=n_tenants)
    assert got.names == want.names and same_bits(got.grid(), want.grid())
    assert space.tenant_slot_indices(got) == ref_space.tenant_slot_indices(want)
    assert space.tenant_slot_indices(got) == tuple(range(3, 3 + n_tenants))
    # neither a cores nor a concurrency knob: both role masks are all false
    for roles in (space.CORES_DIM_CANDIDATES, (space.CONCURRENCY_DIM,)):
        assert not np.asarray(search.role_mask(got, roles)).any()


def test_tenant_names_split_and_validate():
    assert sc.tenant_names(CELLS[3]) == (("granite-8b", "whisper-medium"),
                                         ("decode_steady", "decode_bursty"))
    for model, workload in (("qwen2.5-3b", "decode_steady"),
                            ("qwen2.5-3b+granite-8b", "decode_steady")):
        with pytest.raises(ValueError, match="cotenant cell"):
            sc.tenant_names(sc.Cell("edge-orin-nano", model, workload, "cotenant_skewed"))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_cotenant_twin_equals_the_reference(cell, seed):
    twin = sc.cotenant_cell_simulator(cell, seed=seed)
    ref_twin = ref_sc.cotenant_cell_simulator(ref_cell(cell), seed=seed)
    assert isinstance(build_twin(cell, seed=seed), CotenantSimulator)
    assert twin.floors == ref_twin.floors and twin.noise == ref_twin.noise
    assert [twin.solo_max(k) for k in range(2)] == [ref_twin.solo_max(k) for k in range(2)]
    for a, b in zip(twin.tenant_stats(), ref_twin.tenant_stats()):
        assert same_bits(a, b)
    assert same_bits(twin.rail_power(), ref_twin.rail_power())
    for a, b in zip(twin.exact_all(), ref_twin.exact_all()):
        assert same_bits(a, b)
    rows = twin.space.grid()[seed::5]
    for a, b in zip(twin.measure_all(rows), ref_twin.measure_all(rows)):
        assert same_bits(a, b)
    cfg = tuple(rows[2])
    assert twin.measure(cfg) == ref_twin.measure(cfg)
    assert twin.n_measurements == ref_twin.n_measurements


@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_cotenant_targets_equal_the_reference(cell):
    got = sc.resolve_cotenant_targets(cell)
    want = ref_sc.resolve_cotenant_targets(ref_cell(cell))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.tau_target == 1.0
    assert got.p_budget == RECORD["cotenant_cells"][CELLS.index(cell)]["p_budget"]


def test_twin_refuses_a_space_without_a_slot_per_tenant():
    cell = CELLS[0]
    with pytest.raises(ValueError, match="slots_t"):
        CotenantSimulator(sc.get_profile(cell.device),
                          [sc.get_config(m) for m in sc.tenant_names(cell)[0]],
                          space=space.cotenant_space("edge_xavier_nx", n_tenants=3))


def _quick_requests(mat, scen):
    reqs = []
    for cell in sc.QUICK_COTENANT_CELLS:
        reqs += mat._static_requests(mat._prep_cotenant_cell(scen.Cell(*cell.key())), SEEDS)
    return reqs


@pytest.fixture(scope="module")
def quick_engines():
    """The QUICK cotenant cells × 3 seeds, one batch each, through the
    port's batched engine and through the JAX package's compiled one."""
    got = run_static_requests(_quick_requests(matrix, sc), iters=matrix.COTENANT_ITERS,
                              device="cpu")
    want = ref_run_static_requests(_quick_requests(ref_matrix, ref_sc),
                                   iters=ref_matrix.COTENANT_ITERS)
    return got, want


@pytest.mark.parametrize("i", range(2 * len(SEEDS)),
                         ids=[f"{cell_id(c)}-seed{s}" for c in sc.QUICK_COTENANT_CELLS
                              for s in SEEDS])
def test_batched_engine_equals_the_jax_engine(quick_engines, i):
    got, want = quick_engines[0][i], quick_engines[1][i]
    assert len(got.configs) == matrix.COTENANT_ITERS
    assert [tuple(c) for c in got.configs] == [tuple(c) for c in want.configs]
    np.testing.assert_allclose(got.taus, want.taus, rtol=1e-12)
    np.testing.assert_allclose(got.powers, want.powers, rtol=1e-12)
    np.testing.assert_allclose(got.rewards, want.rewards, rtol=1e-12)
    assert tuple(got.outcome.config) == tuple(want.outcome.config)


@pytest.fixture(scope="module")
def batched_runs():
    """Every cotenant cell × seed, one batched call (the matrix's)."""
    preps = {c: matrix._prep_cotenant_cell(c) for c in CELLS}
    runs = matrix._static_runs(preps, SEEDS, matrix.COTENANT_ITERS, 10, "batched", "cpu")
    return preps, runs


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_scalar_spec_equals_the_batched_engine(batched_runs, cell, seed):
    preps, runs = batched_runs
    ep_out, ep_tr = runs[cell][SEEDS.index(seed)]
    out, tr = run_regime(preps[cell]["space"], build_twin(cell, seed=seed),
                         preps[cell]["targets"], iters=matrix.COTENANT_ITERS, seed=seed,
                         device="cpu")
    assert [tuple(c) for c in tr.configs] == [tuple(c) for c in ep_tr.configs]
    assert (tr.taus, tr.powers, tr.rewards) == (ep_tr.taus, ep_tr.powers, ep_tr.rewards)
    assert dataclasses.astuple(out) == dataclasses.astuple(ep_out)


@pytest.mark.parametrize("engine", matrix.ENGINES)
@pytest.mark.parametrize("i", range(len(CELLS)), ids=[cell_id(c) for c in CELLS])
def test_cotenant_cell_record_equals_the_committed_one(i, engine):
    got = matrix.run_cotenant_cell(CELLS[i], engine=engine, device="cpu")
    assert matrix.diff_records(got, RECORD["cotenant_cells"][i]) == []


@pytest.mark.parametrize("engine", matrix.ENGINES)
def test_cotenant_summary_equals_the_committed_one(engine):
    rec = matrix.run_matrix([], cotenant_cells=CELLS, engine=engine, device="cpu")
    assert rec["cells"] == rec["offload_cells"] == rec["fault_cells"] == []
    assert matrix.diff_records(rec["cotenant_cells"], RECORD["cotenant_cells"]) == []
    got = {k: rec["summary"][k] for k in COTENANT_KEYS}
    assert matrix.diff_records(got, {k: RECORD["summary"][k] for k in COTENANT_KEYS}) == []
    # what the cotenant cells are built to show
    assert got["min_cotenant_score"] >= matrix.COTENANT_CORAL_GATE
    assert got["cotenant_power_violations"] == got["cotenant_feasible_baselines"] == 0


def test_run_cell_runs_a_cotenant_cell():
    rec = run_cell(CellSpec(CELLS[2], seeds=(0,)), device="cpu")
    assert rec.family == "cotenant" and rec.record["cotenant"]["n_tenants"] == 2
    assert rec.record["coral"]["measurements"] == matrix.COTENANT_ITERS
    assert rec.record["space_size"] == 216


# ---------------------------------------------------------------------------
# The whole committed record
# ---------------------------------------------------------------------------

RECORD_FAMILIES = ("cells", "drift_cells", "offload_cells", "cotenant_cells", "fault_cells")


def test_whole_record_is_reproduced():
    """The committed record's grid — the 54 static cells with the 6 drift
    cells, and the 4 offload, 4 cotenant and 6 fault cells, every family
    one batched call — against every cell, every summary key, the grid
    block and the layout version of ``BENCH_matrix.json``."""
    rec = matrix.run_matrix(
        sc.enumerate_cells(workloads=sc.FULL_MATRIX_WORKLOADS) + list(sc.MATRIX_DRIFT_CELLS),
        offload_cells=sc.MATRIX_OFFLOAD_CELLS, cotenant_cells=CELLS,
        fault_cells=sc.MATRIX_FAULT_CELLS, device="cpu",
    )
    assert sum(len(rec[f]) for f in RECORD_FAMILIES) == 74
    for key in RECORD_FAMILIES + ("summary", "grid", "schema_version", "seeds", "iters"):
        assert matrix.diff_records(rec[key], RECORD[key], path=key) == []
    assert sorted(rec["wall_clock_s"]) == sorted(RECORD["wall_clock_s"])


def test_default_grid_runs_every_family():
    """``run_matrix()`` with no cells: the reference's default static grid,
    and the offload, cotenant and fault families at their MATRIX_* tuples,
    each equal to the committed family."""
    rec = matrix.run_matrix(device="cpu")
    assert len(rec["cells"]) == len(sc.enumerate_cells()) and rec["drift_cells"] == []
    for family in ("offload_cells", "cotenant_cells", "fault_cells"):
        assert matrix.diff_records(rec[family], RECORD[family], path=family) == []
    assert rec["grid"]["cotenant_regimes"] == RECORD["grid"]["cotenant_regimes"]
