"""The port's shape/dtype contract lane (``repro_torch.core.contracts``),
case for case with ``tests/test_contracts.py``: the tables parse,
``check_container`` catches every class of violation on numpy arrays and
on torch tensors alike, the ``REPRO_CONTRACTS=1`` lane validates a real
engine run of every step kind (static, drift, fault, fleet) and the dCor
states and fleet twins, and a corrupted container fails loudly. A static
counterpart of the reference's lint rule RL04 holds the keys
``_init_carry`` writes, read from its source, to the port's tables.
"""
import ast
import inspect
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.core import contracts, episode
from repro_torch.core.contracts import (
    CARRY_CONTRACT,
    ContractError,
    check_container,
    check_twin,
    contracts_enabled,
)
from repro_torch.core.dcov import dcor_state_from_window, dcor_state_init, dcor_state_push
from repro_torch.core.episode import run_coral_batch
from repro_torch.core.evaluate import RegimeTargets
from repro_torch.core.space import jetson_like_space
from repro_torch.device import jetson_like_simulator
from repro_torch.experiments import fleet, matrix
from repro_torch.experiments import scenarios as sc

ROOT = Path(__file__).resolve().parents[1]
CONTRACT = {
    "hist": 'Float32[Array, "T+W D"]',
    "count": 'Int32[Array, ""]',
    "mask": 'Bool[Array, "N"]',
}
DIMS = {"T": 4, "W": 2, "D": 3, "N": 5}
TABLES = (
    contracts.CARRY_CONTRACT,
    contracts.FLEET_CARRY_CONTRACT,
    contracts.DRIFT_CARRY_CONTRACT,
    contracts.FAULT_CARRY_CONTRACT,
    contracts.DCOR_STATE_CONTRACT,
    contracts.FLEET_BATCH_CONTRACT,
    contracts.TWIN_CONTRACT,
)


def _good(lib):
    if lib == "numpy":
        return {
            "hist": np.zeros((6, 3), np.float32),
            "count": np.int32(0),
            "mask": np.zeros(5, bool),
        }
    return {
        "hist": torch.zeros((6, 3), dtype=torch.float32),
        "count": torch.tensor(0, dtype=torch.int32),
        "mask": torch.zeros(5, dtype=torch.bool),
    }


LIBS = ["numpy", "torch"]


def test_every_committed_spec_parses():
    for table in TABLES:
        for spec in table.values():
            dtype, dims_expr = contracts._parse(spec)
            assert dtype in ("float32", "float64", "int32", "int64", "bool")
            contracts._expect_shape(
                dims_expr, {"T": 4, "W": 2, "D": 3, "N": 5, "C": 5, "B": 2,
                            "N0": 7},
            )


def test_malformed_spec_is_refused():
    for spec in ('Float16[Array, "B"]', "Float32[B]"):
        with pytest.raises(ContractError, match="malformed"):
            contracts._parse(spec)


@pytest.mark.parametrize("lib", LIBS)
def test_check_container_accepts_valid(lib):
    check_container("c", _good(lib), CONTRACT, DIMS)


@pytest.mark.parametrize("lib", LIBS)
def test_check_container_rejects_missing_and_extra_fields(lib):
    c = _good(lib)
    del c["mask"]
    with pytest.raises(ContractError, match="missing=\\['mask'\\]"):
        check_container("c", c, CONTRACT, DIMS)
    c = _good(lib)
    c["stray"] = c["hist"]
    with pytest.raises(ContractError, match="extra=\\['stray'\\]"):
        check_container("c", c, CONTRACT, DIMS)


@pytest.mark.parametrize("lib", LIBS)
def test_check_container_rejects_wrong_dtype(lib):
    c = _good(lib)
    c["hist"] = c["hist"].astype(np.float64) if lib == "numpy" else c["hist"].double()
    with pytest.raises(ContractError, match="dtype float64, contract says float32"):
        check_container("c", c, CONTRACT, DIMS)
    c = _good(lib)
    c["count"] = np.int64(0) if lib == "numpy" else torch.tensor(0)
    with pytest.raises(ContractError, match="dtype int64, contract says int32"):
        check_container("c", c, CONTRACT, DIMS)


@pytest.mark.parametrize("lib", LIBS)
def test_check_container_rejects_wrong_shape(lib):
    c = _good(lib)
    c["hist"] = np.zeros((6, 4), np.float32) if lib == "numpy" else torch.zeros(6, 4)
    with pytest.raises(ContractError, match="shape"):  # D is 3
        check_container("c", c, CONTRACT, DIMS)


def test_carry_contract_layering():
    base = set(contracts.carry_contract(fleet=False, drift=False))
    fleet_ = set(contracts.carry_contract(fleet=True, drift=False))
    drift = set(contracts.carry_contract(fleet=False, drift=True))
    fault = set(contracts.carry_contract(fleet=False, drift=False, fault=True))
    assert base == set(CARRY_CONTRACT)
    # the port's fleet carry is the base carry: no dc_* accumulators
    assert fleet_ == base and contracts.FLEET_CARRY_CONTRACT == {}
    assert drift - base == set(contracts.DRIFT_CARRY_CONTRACT)
    assert fault - base == set(contracts.FAULT_CARRY_CONTRACT)


def test_lane_is_off_by_default(monkeypatch):
    monkeypatch.delenv("REPRO_CONTRACTS", raising=False)
    assert not contracts_enabled()
    monkeypatch.setenv("REPRO_CONTRACTS", "1")
    assert contracts_enabled()
    monkeypatch.setenv("REPRO_CONTRACTS", "")
    assert not contracts_enabled()
    monkeypatch.setenv("REPRO_CONTRACTS", "no")
    assert not contracts_enabled()


def _init_carry_keys():
    """The carry fields ``_init_carry`` writes, read from its source the
    way the reference's lint rule RL04 reads its own: dict-literal keys,
    ``c["name"] = ...`` and ``c.update(name=...)``."""
    tree = ast.parse(inspect.getsource(episode._init_carry))
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant) and isinstance(k.value, str)}
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
                and isinstance(node.targets[0].slice, ast.Constant)):
            keys.add(node.targets[0].slice.value)
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update"):
            keys |= {k.arg for k in node.keywords if k.arg is not None}
    return keys


def test_init_carry_writes_exactly_the_contracted_fields():
    tables = set(contracts.carry_contract(fleet=True, drift=True, fault=True))
    assert _init_carry_keys() == tables


def _static_cell():
    sp = jetson_like_space()
    sim = jetson_like_simulator(sp)
    lt, lp = sim.exact_all()
    tg = RegimeTargets(
        mode="dual",
        tau_target=float(np.percentile(lt, 70)),
        p_budget=float(np.percentile(lp, 60)),
    )
    return sp, lt, lp, tg


def _run_kind(kind):
    """One small lane-on engine call of step kind ``kind``."""
    if kind == "static":
        sp, lt, lp, tg = _static_cell()
        (ep,) = run_coral_batch(sp, lt, lp, tg, seeds=(0,), iters=8, window=6, device="cpu")
        assert len(ep.taus) == 8
    elif kind == "drift":
        matrix.run_drift_cell(sc.MATRIX_DRIFT_CELLS[0], seeds=(0,), device="cpu")
    elif kind == "fault":
        matrix.run_fault_cell(sc.MATRIX_FAULT_CELLS[0], seeds=(0,), device="cpu")
    else:
        fleet.run_fleet(n_twins=4, iters=9, window=5, device="cpu")


@pytest.mark.parametrize("kind", ["static", "drift", "fault", "fleet"])
def test_contracts_lane_engine_smoke(monkeypatch, kind):
    """With the lane on, every step kind's carry (and the fleet's host
    batch and twins) is validated once per call: a drifted field would
    raise before the first step."""
    monkeypatch.setenv("REPRO_CONTRACTS", "1")
    monkeypatch.delenv("REPRO_CHECKIFY", raising=False)
    seen = {}

    def counted(name, fn):
        def wrapped(*args, **kw):
            seen[name] = seen.get(name, 0) + 1
            return fn(*args, **kw)
        return wrapped

    with mock.patch.object(contracts, "check_carry",
                           counted("carry", contracts.check_carry)), \
         mock.patch.object(contracts, "check_fleet_batch",
                           counted("batch", contracts.check_fleet_batch)), \
         mock.patch.object(fleet, "check_twin", counted("twin", fleet.check_twin)):
        _run_kind(kind)
    assert seen["carry"] >= 1
    if kind == "fleet":
        assert seen["batch"] == seen["carry"] == 2  # the cold call and the warm call
        assert seen["twin"] == 4


def test_lane_off_checks_nothing(monkeypatch):
    monkeypatch.delenv("REPRO_CONTRACTS", raising=False)
    with mock.patch.object(contracts, "check_container",
                           side_effect=AssertionError("checked with the lane off")):
        _run_kind("static")
        dcor_state_init(window=4, c=5, device="cpu")


def _captured(monkeypatch, name):
    """Run a small fleet with the lane on and return the container that
    ``contracts.<name>`` validated first."""
    monkeypatch.setenv("REPRO_CONTRACTS", "1")
    got = []
    real = getattr(contracts, name)

    def keep(*args, **kw):
        got.append((args, kw))
        return real(*args, **kw)

    with mock.patch.object(contracts, name, keep):
        fleet.run_fleet(n_twins=4, iters=9, window=5, device="cpu")
    return real, got[0]


def test_corrupted_carry_raises(monkeypatch):
    real, ((spec, carry, b), _) = _captured(monkeypatch, "check_carry")
    real(spec, carry, b)
    bad = dict(carry, best_r=carry["best_r"].double())
    with pytest.raises(ContractError, match="carry.best_r: dtype float64"):
        real(spec, bad, b)
    bad = dict(carry, seen_tag=carry["seen_tag"][:, :-1])
    with pytest.raises(ContractError, match="carry.seen_tag: shape"):
        real(spec, bad, b)
    bad = dict(carry, dc_win=carry["hist_sm"])  # the reference's fleet field
    with pytest.raises(ContractError, match="extra=\\['dc_win'\\]"):
        real(spec, bad, b)


def test_corrupted_fleet_batch_raises(monkeypatch):
    real, ((ep,), kw) = _captured(monkeypatch, "check_fleet_batch")
    real(ep, **kw)
    # the port's ids are int64 (the reference's Int32): an int32 id is a drift
    bad = dict(ep, space_id=ep["space_id"].astype(np.int32))
    with pytest.raises(ContractError, match="fleet_batch.space_id: dtype int32"):
        real(bad, **kw)
    bad = dict(ep, noise=ep["noise"][:, :-1])
    with pytest.raises(ContractError, match="fleet_batch.noise: shape"):
        real(bad, **kw)


@pytest.mark.parametrize("batched", [False, True])
def test_dcor_state_checked_under_lane(monkeypatch, batched):
    monkeypatch.setenv("REPRO_CONTRACTS", "1")
    calls = []
    real = contracts.check_dcor_state
    from repro_torch.core import dcov

    def keep(state):
        calls.append(state)
        return real(state)

    rng = np.random.default_rng(0)
    lead = (3,) if batched else ()
    cols = torch.from_numpy(rng.normal(size=lead + (4, 5)).astype(np.float32))
    n = torch.tensor([4, 2, 3]) if batched else 3
    with mock.patch.object(dcov, "check_dcor_state", keep):
        state = dcor_state_init(window=4, c=5, device="cpu")
        assert state["win"].shape == (4, 5)
        state = dcor_state_from_window(cols, n)
        state = dcor_state_push(state, cols[..., 0, :], 1, 2)
    assert len(calls) == 3
    assert tuple(state["dist"].shape) == lead + (4, 4, 5)
    bad = dict(state, cross=state["cross"].double())
    with pytest.raises(ContractError, match="dcor_state.cross: dtype float64"):
        real(bad)
    with pytest.raises(ContractError, match="missing 'win'"):
        real({k: v for k, v in state.items() if k != "win"})


def test_check_twin_rejects_f32_landscape():
    # TWIN_CONTRACT pins the oracle landscape to float64 — a float32
    # twin would silently halve the measurement precision
    n0 = 7
    twin = SimpleNamespace(
        space=SimpleNamespace(size=lambda: n0),
        banned=np.zeros(n0, bool),
        land_tau=np.ones(n0, np.float32),
        land_p=np.ones(n0, np.float64),
    )
    with pytest.raises(ContractError, match="land_tau"):
        check_twin(twin)
    twin.land_tau = twin.land_tau.astype(np.float64)
    check_twin(twin)
