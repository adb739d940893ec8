"""Shape/dtype contracts for the batched engine's fixed-size state containers.

The port of ``repro.core.contracts``. The episode carry, the incremental
dCor state, the fleet's host batch and the fleet twins are the engine's
load-bearing data structures: every field has a pinned dtype and a shape
that is a pure function of the ``EngineSpec`` and the batch. The tables
below write those invariants down once, jaxtyping-style
(``Float32[Array, "B T+W D+4"]``), and two consumers keep them honest:

- runtime: ``REPRO_CONTRACTS=1`` makes ``core/episode.py::_init_carry``,
  ``run_fleet_requests`` (on the host batch, before upload), the dCor
  state constructors in ``core/dcov.py`` and
  ``experiments/fleet.py::build_twin`` validate their containers, once
  per call (the flag is read at call time; off, nothing is checked);
- tests: ``tests/test_torch_contracts.py`` reads the keys ``_init_carry``
  writes from its source and holds them to these tables, as the
  reference's lint rule RL04 does for its own carry.

The tables describe the port's containers, written from its code, and
differ from the reference's where the port's state does:

- the carry is batched: every field leads with B (``hist_sm`` is
  ``"B T+W D+4"``, ``seen_tag`` ``"B N"``, the scalars ``"B"``), where
  the reference's carry is one episode's under ``vmap``;
- the fleet carry adds nothing to the base carry: the port gathers the
  dCor window from the history block like every other step kind and
  carries no ``dc_*`` accumulators (``FLEET_CARRY_CONTRACT`` is empty;
  the reference's holds ``dc_win``, ``dc_dist``, ``dc_rows``,
  ``dc_cross``);
- the fleet host batch holds ``space_id`` and ``table_id`` as Int64
  (they index device tensors directly), where the reference's are Int32;
- the dCor state may carry a leading batch axis B (``check_dcor_state``
  validates ``"W C"`` or ``"B W C"`` by the rank of ``win``).

A torch tensor's dtype prints as ``torch.float32`` and a numpy array's as
``float32``: ``check_container`` takes both, and holds either to the
contracted dtype exactly (a float64 tensor where float32 is contracted
fails).

Dimension symbols: T episode iters, W dCor window, D config dims, N
padded grid rows, C = D+2 dCor columns, B batch (episodes), N0 one
twin's own grid size.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

from repro_torch.envflags import env_flag

# ------------------------------------------------------------------ tables

# base carry — every step kind (core/episode.py::_init_carry)
CARRY_CONTRACT: Dict[str, str] = {
    "hist_sm": 'Float32[Array, "B T+W D+4"]',
    "n_obs": 'Int32[Array, "B"]',
    "epoch_start": 'Int32[Array, "B"]',
    "epoch_id": 'Int32[Array, "B"]',
    "clock": 'Int32[Array, "B"]',
    "seen_tag": 'Int32[Array, "B N"]',
    "best_idx": 'Int32[Array, "B"]',
    "best_tau": 'Float32[Array, "B"]',
    "best_p": 'Float32[Array, "B"]',
    "best_r": 'Float32[Array, "B"]',
    "best_valid": 'Bool[Array, "B"]',
    "sec_idx": 'Int32[Array, "B"]',
    "sec_tau": 'Float32[Array, "B"]',
    "sec_p": 'Float32[Array, "B"]',
    "sec_r": 'Float32[Array, "B"]',
    "sec_valid": 'Bool[Array, "B"]',
    "last_idx": 'Int32[Array, "B"]',
    "last_tau": 'Float32[Array, "B"]',
    "last_p": 'Float32[Array, "B"]',
    "last_valid": 'Bool[Array, "B"]',
    "aside": 'Bool[Array, "B"]',
    "probed_for": 'Int32[Array, "B"]',
    "probe_done": 'Bool[Array, "B"]',
}

# fleet episodes carry nothing more: the dCor window is gathered from
# ``hist_sm`` each step, not kept as incremental sums
FLEET_CARRY_CONTRACT: Dict[str, str] = {}

# drift episodes add the budget schedule slot + CUSUM monitor state
DRIFT_CARRY_CONTRACT: Dict[str, str] = {
    "p_budget": 'Float32[Array, "B"]',
    "mon_sigma": 'Float32[Array, "B"]',
    "held_idx": 'Int32[Array, "B"]',
    "held_tau": 'Float32[Array, "B"]',
    "held_p": 'Float32[Array, "B"]',
    "held_valid": 'Bool[Array, "B"]',
    "mon_ref_tau": 'Float32[Array, "B"]',
    "mon_ref_p": 'Float32[Array, "B"]',
    "mon_calib": 'Int32[Array, "B"]',
    "mon_pos_tau": 'Float32[Array, "B"]',
    "mon_neg_tau": 'Float32[Array, "B"]',
    "mon_pos_p": 'Float32[Array, "B"]',
    "mon_neg_p": 'Float32[Array, "B"]',
    "mon_active": 'Bool[Array, "B"]',
    "retries": 'Int32[Array, "B"]',
    "resets": 'Int32[Array, "B"]',
}

# fault episodes add the actuation readback + telemetry watchdog state
FAULT_CARRY_CONTRACT: Dict[str, str] = {
    "applied_idx": 'Int32[Array, "B"]',
    "dark": 'Int32[Array, "B"]',
}

# incremental dCor state (core/dcov.py::dcor_state_*), one window; a
# batched state leads every field with B
DCOR_STATE_CONTRACT: Dict[str, str] = {
    "win": 'Float32[Array, "W C"]',
    "dist": 'Float32[Array, "W W C"]',
    "rows": 'Float32[Array, "W C"]',
    "cross": 'Float32[Array, "C C"]',
}

# the host-built fleet request batch (episode.py::run_fleet_requests),
# numpy, checked before upload; leading B is the episode axis
FLEET_BATCH_CONTRACT: Dict[str, str] = {
    "space_id": 'Int64[Array, "B"]',
    "table_id": 'Int64[Array, "B"]',
    "tau_target": 'Float32[Array, "B"]',
    "p_budget": 'Float32[Array, "B"]',
    "throughput": 'Bool[Array, "B"]',
    "banned": 'Bool[Array, "B N"]',
    "min_idx": 'Int32[Array, "B"]',
    "max_idx": 'Int32[Array, "B"]',
    "warm": 'Bool[Array, "B"]',
    "warm_n": 'Int32[Array, "B"]',
    "warm_hist": 'Float32[Array, "B W D+4"]',
    "warm_prohibit": 'Bool[Array, "B N"]',
    "warm_best_idx": 'Int32[Array, "B"]',
    "warm_best_tau": 'Float32[Array, "B"]',
    "warm_best_p": 'Float32[Array, "B"]',
    "warm_best_r": 'Float32[Array, "B"]',
    "warm_best_valid": 'Bool[Array, "B"]',
    "warm_sec_idx": 'Int32[Array, "B"]',
    "warm_sec_tau": 'Float32[Array, "B"]',
    "warm_sec_p": 'Float32[Array, "B"]',
    "warm_sec_r": 'Float32[Array, "B"]',
    "warm_sec_valid": 'Bool[Array, "B"]',
    "warm_last_idx": 'Int32[Array, "B"]',
    "warm_last_tau": 'Float32[Array, "B"]',
    "warm_last_p": 'Float32[Array, "B"]',
    "warm_last_valid": 'Bool[Array, "B"]',
    "noise": 'Float32[Array, "B T 2"]',
}

# the unpadded per-twin ground truth (experiments/fleet.py::FleetTwin);
# N0 is the twin's own grid size, float64 on purpose — this is the
# noise-free oracle landscape, rounded to f32 only at the device boundary
TWIN_CONTRACT: Dict[str, str] = {
    "banned": 'Bool[Array, "N0"]',
    "land_tau": 'Float64[Array, "N0"]',
    "land_p": 'Float64[Array, "N0"]',
}

# ------------------------------------------------------- TWIN_RNG_PROTOCOL
#
# The behavioral contract every device twin behind ``device.build_twin``
# honors (DeviceSimulator, DriftingSimulator, OffloadSimulator,
# CotenantSimulator — and anything the factory grows next). The batched
# episode engine replays a twin's noise stream from (seed, noise) alone,
# so the protocol is byte-exact, not approximate:
#
#   state      one ``np.random.default_rng(seed)`` Generator per twin,
#              advanced only by the measurement calls below;
#   measure    exact (τ, p) then two *sequential* scalar draws —
#              ``τ *= 1 + rng.normal(0, noise)`` then the same for p —
#              clamped to ≥ 1e-9;
#   measure_all  exact arrays then ONE config-major block
#              ``z = rng.normal(0, noise, size=(N, 2))`` with
#              ``τ *= 1 + z[:, 0]``, ``p *= 1 + z[:, 1]``, clamped —
#              the stream equals N sequential ``measure`` calls;
#   noise=0.0  must not draw at all (the ground-truth twin oracles use);
#   exact/exact_all  pure float64, no RNG advance, no clamping of the
#              model output beyond the twin's own physics;
#   channels   whatever the twin's (τ, p) *mean* is fair game — offload
#              twins report served throughput, cotenant twins the joint
#              headroom min_k τ_k/floor_k — but the noise protocol above
#              applies to the reported pair unchanged.
#
# tests/test_torch_episode.py and tests/test_torch_cotenant.py pin
# scalar↔batched equivalence through this contract; a twin that draws in a
# different order or shape breaks replay silently, so new twins must
# copy the implementation in ``device/simulator.py``.

_DTYPES = {"Float32": "float32", "Float64": "float64", "Int32": "int32",
           "Int64": "int64", "Bool": "bool"}
_SPEC_RE = re.compile(r'^(\w+)\[Array, "(.*)"\]$')


class ContractError(AssertionError):
    """A container violated its shape/dtype contract."""


def contracts_enabled() -> bool:
    """The REPRO_CONTRACTS=1 runtime lane (single parser: envflags)."""
    return env_flag("REPRO_CONTRACTS")


def _parse(spec: str):
    m = _SPEC_RE.match(spec)
    if m is None or m.group(1) not in _DTYPES:
        raise ContractError(f"malformed contract spec {spec!r}")
    return _DTYPES[m.group(1)], m.group(2)


def _expect_shape(dims_expr: str, dims: Mapping[str, int]):
    if not dims_expr:
        return ()
    env = {"__builtins__": {}}
    return tuple(
        int(eval(tok, env, dict(dims)))  # tokens like "T+W" — repo-authored
        for tok in dims_expr.split()
    )


def _dtype_name(arr) -> str:
    """``float32`` for a numpy array or scalar and for a torch tensor
    alike (a tensor's dtype prints as ``torch.float32``)."""
    return str(arr.dtype).removeprefix("torch.")


def check_container(
    name: str,
    container: Mapping[str, object],
    contract: Mapping[str, str],
    dims: Mapping[str, int],
) -> None:
    """Exact-key, dtype and shape validation of one state container of
    torch tensors or numpy arrays (both expose .dtype/.shape)."""
    got, want = set(container), set(contract)
    if got != want:
        missing, extra = sorted(want - got), sorted(got - want)
        raise ContractError(
            f"{name}: field set mismatch (missing={missing}, extra={extra})"
        )
    for field, spec in contract.items():
        dtype, dims_expr = _parse(spec)
        arr = container[field]
        actual = _dtype_name(arr)
        if actual != dtype:
            raise ContractError(
                f"{name}.{field}: dtype {actual}, contract says {dtype}"
            )
        shape = _expect_shape(dims_expr, dims)
        if tuple(arr.shape) != shape:
            raise ContractError(
                f"{name}.{field}: shape {tuple(arr.shape)}, contract says "
                f"{shape} ({spec})"
            )


def carry_contract(fleet: bool, drift: bool, fault: bool = False) -> Dict[str, str]:
    """The contract table for one step kind: the base carry plus the
    fleet fields (none in the port), the drift monitor fields and/or the
    fault actuation/watchdog fields."""
    table = dict(CARRY_CONTRACT)
    if fleet:
        table.update(FLEET_CARRY_CONTRACT)
    if drift:
        table.update(DRIFT_CARRY_CONTRACT)
    if fault:
        table.update(FAULT_CARRY_CONTRACT)
    return table


def check_carry(spec, carry: Mapping[str, object], b: int) -> None:
    """Validate a carry of ``b`` episodes against its EngineSpec."""
    dims = {"T": spec.iters, "W": spec.window, "D": spec.d, "N": spec.n,
            "C": spec.d + 2, "B": b}
    check_container(
        "carry", carry, carry_contract(spec.fleet, spec.drift, spec.fault),
        dims,
    )


def _batched(spec: str) -> str:
    """``spec`` with a leading B dimension."""
    m = _SPEC_RE.match(spec)
    return f'{m.group(1)}[Array, "B {m.group(2)}"]'


def check_dcor_state(state: Mapping[str, object]) -> None:
    """Validate an incremental dCor state dict; W and C (and B, for a
    batched state) are taken from the ``win`` field."""
    win = state.get("win")
    if win is None:
        raise ContractError("dcor state: missing 'win' field")
    shape = tuple(win.shape)
    if len(shape) == 2:
        table, dims = DCOR_STATE_CONTRACT, {"W": shape[0], "C": shape[1]}
    elif len(shape) == 3:
        table = {k: _batched(v) for k, v in DCOR_STATE_CONTRACT.items()}
        dims = {"B": shape[0], "W": shape[1], "C": shape[2]}
    else:
        raise ContractError(f"dcor_state.win: rank {len(shape)}, contract says 2 or 3")
    check_container("dcor_state", state, table, dims)


def check_twin(twin) -> None:
    """Validate a FleetTwin's ground-truth arrays against its space."""
    check_container(
        "fleet_twin",
        {"banned": twin.banned, "land_tau": twin.land_tau,
         "land_p": twin.land_p},
        TWIN_CONTRACT,
        {"N0": twin.space.size()},
    )


def check_fleet_batch(ep: Mapping[str, object], *, b: int, n: int, w: int,
                      d: int, t: int) -> None:
    """Validate the host-built fleet batch before device upload."""
    check_container(
        "fleet_batch", ep, FLEET_BATCH_CONTRACT,
        {"B": b, "N": n, "W": w, "D": d, "T": t},
    )
