"""Run the scenario matrix: CORAL + all baselines through every cell.

Each cell is scored on three axes (the paper's Table/Fig. §IV summary):

  normalized score — performance of the chosen config, noise-free, as a
      fraction of the cell's exhaustive-search ORACLE under the regime's
      own objective (max_throughput: τ ratio; τ-targeted regimes:
      efficiency τ/p ratio among what the oracle ranks);
  violation rate  — fraction of runs whose chosen config truly breaks a
      constraint (evaluated on the noise-free twin, so a lucky noise
      sample can't hide a real power-budget bust);
  exploration cost — measurements until the first feasible observation
      (ORACLE pays the full grid; CORAL its iteration budget).

All optimizer selections run against the *noisy* device (the 1-second
tegrastats-style samples CORAL actually sees); all scoring runs against
the noise-free twin.

The port of ``repro.experiments.matrix``. Episode engines:
``engine="batched"`` (default) runs every CORAL episode of a family
through the batched engine (``core/episode.py``) as one request batch —
on the card, T steps, one dcov kernel launch each — and
``engine="scalar"`` runs the CORAL loop one episode at a time (one dcov
launch per ``correlations()`` call with n ≥ 3). Both engines produce
identical records, and both reproduce every family of the reference's
committed record, ``BENCH_matrix.json`` (``diff_records``).

Beyond the static grid: dynamic (drift) cells run drift-adaptive CORAL
against its static (one-shot) ablation through the same drifting twin,
scored against the post-shift oracle; edge↔pod offload cells run CORAL
over the joint route-fraction × concurrency × two-sided-DVFS space
against a batched joint oracle while every static preset and the φ=0
ablation are infeasible by calibration (``run_offload_cell``);
multi-tenant cotenant cells run CORAL over per-tenant decode slots ×
shared DVFS against per-tenant τ floors and one shared rail cap while
the per-tenant-greedy combination and every preset miss a floor or bust
the cap (``run_cotenant_cell``); fault cells run hardened CORAL (MAD
ingest gate, watchdog fallback, actuation readback and retry) against
its blind ablation through the same fault-injected twin, scored against
the fault-free oracle. Offload and cotenant episodes are static
episodes: they run the static engine step at their own budgets.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.baselines import Outcome, alert, alert_online, oracle, preset
from repro_torch.core.episode import (
    alert_online_outcome,
    preset_outcome,
    run_drift_requests,
    run_fault_requests,
    run_static_requests,
)
from repro_torch.core.evaluate import (
    RegimeTargets,
    Trace,
    measurements_to_feasible,
    run_drift_regime,
    run_fault_regime,
    run_regime,
)
from repro_torch.core.space import row_index, tenant_slot_indices
from repro_torch.device.factory import build_twin
from repro_torch.device.simulator import FaultySimulator
from repro_torch.experiments.scenarios import (
    COTENANT_REGIMES,
    DRIFT_INTERVALS,
    DRIFT_SHIFT_START,
    FAULT_INTERVALS,
    FAULT_REGIMES,
    MATRIX_COTENANT_CELLS,
    MATRIX_FAULT_CELLS,
    MATRIX_OFFLOAD_CELLS,
    OFFLOAD_REGIMES,
    REGIMES,
    WORKLOADS,
    Cell,
    _fault_base_cell,
    enumerate_cells,
    fault_tables,
    resolve_cotenant_targets,
    resolve_fault_targets,
    resolve_offload_targets,
    resolve_targets,
    tenant_names,
)

# Per-baseline device seeds: every baseline sees its own noise stream,
# deterministically, so matrix records are reproducible bit-for-bit.
_BASELINE_SEEDS = {
    "alert": 101,
    "alert_online": 102,
    "max_power": 103,
    "default": 104,
    "min_power": 105,
}

# Regression-gate margin: the recorded floor sits this far under the
# worst seed, absorbing cross-platform float jitter without letting a
# real regression through.
SCORE_FLOOR_MARGIN = 0.05

ENGINES = ("batched", "scalar")

# The reference record's layout version (``BENCH_matrix.json``
# ``schema_version``): every family, the summary and the ``grid`` block.
SCHEMA_VERSION = 6


def _score(tau: float, power: float, mode: str, oracle_ref: Outcome) -> float:
    """Normalized-vs-oracle performance under the regime's objective
    (``mode``: "throughput" → τ ratio, "dual" → efficiency ratio)."""
    if oracle_ref.config is None:
        return 0.0
    if mode == "throughput":
        return tau / max(oracle_ref.tau, 1e-9)
    eff = tau / max(power, 1e-9)
    return eff / max(oracle_ref.efficiency, 1e-9)


def _violations(
    tau: float, power: float, targets: RegimeTargets
) -> Tuple[bool, bool]:
    """(τ-target miss, power-budget bust) of a chosen config, noise-free."""
    tau_miss = targets.mode != "throughput" and tau < targets.tau_target * (1 - 1e-9)
    power_bust = targets.capped and power > targets.p_budget * (1 + 1e-9)
    return tau_miss, power_bust


def _prep_cell(cell: Cell) -> dict:
    """Shared per-cell precompute: noise-free twin, resolved targets,
    the float64 (τ, p) landscape over the grid, and the oracle."""
    sim0 = build_twin(cell, noise=0.0)
    targets = resolve_targets(cell, sim0)
    land_tau, land_p = sim0.exact_all()
    oracle_ref = oracle(sim0.space, sim0, targets.tau_target, targets.p_budget)
    return {
        "sim0": sim0,
        "space": sim0.space,
        "targets": targets,
        "land_tau": land_tau,
        "land_p": land_p,
        "oracle": oracle_ref,
        "noise": WORKLOADS[cell.workload].noise,
    }


def _static_requests(prep: dict, seeds: Sequence[int]) -> List[dict]:
    return [
        {
            "space": prep["space"],
            "land_tau": prep["land_tau"],
            "land_p": prep["land_p"],
            "targets": prep["targets"],
            "seed": seed,
            "noise": prep["noise"],
        }
        for seed in seeds
    ]


def _scalar_static_runs(
    cell: Cell, prep: dict, seeds: Sequence[int], iters: int, window: int, device
) -> List[Tuple[Outcome, Trace]]:
    """The per-seed CORAL loops of the scalar spec (over whichever twin
    the cell's regime builds)."""
    return [
        run_regime(
            prep["space"], build_twin(cell, seed=seed), prep["targets"],
            iters=iters, window=window, seed=seed, device=device,
        )
        for seed in seeds
    ]


def _cell_record(
    cell: Cell,
    prep: dict,
    runs: List[Tuple[Outcome, Trace]],
    iters: int,
    seeds: Sequence[int],
    engine: str,
    preset_kinds: Tuple[str, ...] = ("max_power", "default"),
) -> dict:
    """Assemble one cell's JSON record from its per-seed episode runs.

    The noisy devices the scalar baselines run against come from
    ``device.build_twin``; ``preset_kinds`` lists the open-loop presets
    to record.
    """
    sim0, targets, oracle_ref = prep["sim0"], prep["targets"], prep["oracle"]
    scores: List[float] = []
    tau_misses: List[bool] = []
    power_busts: List[bool] = []
    m2f: List[Optional[int]] = []
    best: Optional[Tuple[float, float, float, tuple]] = None
    for out, tr in runs:
        if out.config is None:
            # found nothing: a feasibility failure (τ miss), not a power
            # bust — no config ever drew power over the cap.
            scores.append(0.0)
            tau_misses.append(True)
            power_busts.append(False)
            m2f.append(None)
            continue
        tau, power = sim0.exact(out.config)
        miss, bust = _violations(tau, power, targets)
        # A pick that truly breaks the regime's constraints earns no
        # credit — an infeasible low-clock config can beat the feasible
        # optimum on raw τ/p.
        s = 0.0 if (miss or bust) else _score(tau, power, targets.mode, oracle_ref)
        scores.append(s)
        tau_misses.append(miss)
        power_busts.append(bust)
        m2f.append(measurements_to_feasible(tr, targets))
        if not (miss or bust) and (best is None or s > best[0]):
            best = (s, tau, power, tuple(out.config))
    n = len(seeds)
    reached = [v for v in m2f if v is not None]
    coral = {
        "score": sum(scores) / n,
        "score_min": min(scores),
        "score_floor": round(max(0.0, min(scores) - SCORE_FLOOR_MARGIN), 4),
        "violation_rate": sum(a or b for a, b in zip(tau_misses, power_busts)) / n,
        "power_violations": int(sum(power_busts)),
        "found_feasible_rate": len(reached) / n,
        "measurements_to_feasible": (
            sum(reached) / len(reached) if reached else None
        ),
        "measurements": iters,
        "tau": best[1] if best else 0.0,
        "power": best[2] if best else 0.0,
        "config": list(best[3]) if best else None,
    }

    # ---- baselines, one run each --------------------------------------
    def _outcome_record(out: Outcome) -> dict:
        if out.config is None:
            return {
                "score": None,
                "tau": 0.0,
                "power": 0.0,
                "violates_tau": True,
                "violates_power": False,
                "measurements": out.measurements,
            }
        tau, power = sim0.exact(out.config)
        miss, bust = _violations(tau, power, targets)
        return {
            "score": _score(tau, power, targets.mode, oracle_ref),
            "tau": tau,
            "power": power,
            "violates_tau": bool(miss),
            "violates_power": bool(bust),
            "measurements": out.measurements,
        }

    # ALERT's offline profiling is already one batched ``measure_all``
    # sweep, so it runs the same way under both engines; ALERT-Online and
    # the presets are open-loop and, under the batched engine, are table
    # gathers (bitwise-equal Outcomes).
    space = prep["space"]
    if engine == "batched":
        alert_online_out = alert_online_outcome(
            space, prep["land_tau"], prep["land_p"], targets, prep["noise"],
            _BASELINE_SEEDS["alert_online"], iters=iters,
        )
        preset_outs = {
            kind: preset_outcome(
                space, prep["land_tau"], prep["land_p"], kind, prep["noise"],
                _BASELINE_SEEDS[kind],
            )
            for kind in preset_kinds
        }
    else:
        alert_online_out = alert_online(
            space,
            build_twin(cell, seed=_BASELINE_SEEDS["alert_online"]),
            targets.tau_target,
            targets.p_budget,
            iters=iters,
            seed=_BASELINE_SEEDS["alert_online"],
        )
        preset_outs = {
            kind: preset(space, build_twin(cell, seed=_BASELINE_SEEDS[kind]), kind)
            for kind in preset_kinds
        }
    baselines = {
        "alert": _outcome_record(
            alert(
                space,
                build_twin(cell, seed=_BASELINE_SEEDS["alert"]),
                targets.tau_target,
                targets.p_budget,
            )
        ),
        "alert_online": _outcome_record(alert_online_out),
        **{kind: _outcome_record(preset_outs[kind]) for kind in preset_kinds},
    }

    return {
        "device": cell.device,
        "model": cell.model,
        "workload": cell.workload,
        "regime": cell.regime,
        "mode": targets.mode,
        "tau_target": targets.tau_target,
        "p_budget": targets.p_budget if targets.capped else None,
        "space_size": space.size(),
        "oracle": {
            "config": list(prep["oracle"].config) if prep["oracle"].config else None,
            "tau": prep["oracle"].tau,
            "power": prep["oracle"].power,
            "measurements": prep["oracle"].measurements,
        },
        "coral": coral,
        "baselines": baselines,
    }


def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")


def run_static_cell(
    cell: Cell,
    iters: int = 10,
    seeds: Sequence[int] = (0, 1, 2),
    window: int = 10,
    engine: str = "batched",
    device="cuda",
) -> dict:
    """One stationary cell → one JSON-ready record (a ``BENCH_matrix.json``
    ``cells`` entry)."""
    _check_engine(engine)
    prep = _prep_cell(cell)
    runs = _static_runs({cell: prep}, seeds, iters, window, engine, device)
    return _cell_record(cell, prep, runs[cell], iters, seeds, engine)


def _static_runs(
    preps: Dict[Cell, dict], seeds: Sequence[int], iters: int, window: int,
    engine: str, device,
) -> Dict[Cell, List[Tuple[Outcome, Trace]]]:
    """Every cell's per-seed (Outcome, Trace) runs of the static CORAL
    loop — the stationary, offload and cotenant families all run it, each
    over its own grid and budget. Under the batched engine one request
    batch: one engine call of ``iters`` steps for all of them."""
    runs: Dict[Cell, list] = {}
    if engine == "batched":
        reqs, owners = [], []
        for c, prep in preps.items():
            cell_reqs = _static_requests(prep, seeds)
            owners.extend([c] * len(cell_reqs))
            reqs.extend(cell_reqs)
        if reqs:
            eps = run_static_requests(reqs, iters=iters, window=window, device=device)
            for c, ep in zip(owners, eps):
                runs.setdefault(c, []).append((ep.outcome, ep.trace()))
    else:
        for c, prep in preps.items():
            runs[c] = _scalar_static_runs(c, prep, seeds, iters, window, device)
    return runs


# The joint offload grid is ~2.5× the size of a single-device grid and
# its dual-feasible region is deliberately narrow (5–18% of rows), so
# the measurement budget scales with it: 24 measurements keeps every
# calibrated cell ≥ OFFLOAD_CORAL_GATE of the joint oracle with zero
# true power busts (tests/test_torch_offload.py holds the record to it),
# while every static preset and the no-offload ablation stay infeasible
# by construction.
OFFLOAD_ITERS = 24
OFFLOAD_CORAL_GATE = 0.85


def _prep_offload_cell(cell: Cell) -> dict:
    """Offload-cell precompute: the noise-free edge↔pod twin (demand
    pinned at demand_factor × the edge-only max), resolved end-to-end
    targets, the joint-grid (τ_served, p_edge) landscape, and the batched
    joint-space oracle — same keys as ``_prep_cell`` so the episode
    request shape is shared."""
    sim0 = build_twin(cell, noise=0.0)
    targets = resolve_offload_targets(cell, sim0)
    land_tau, land_p = sim0.exact_all()
    oracle_ref = oracle(sim0.space, sim0, targets.tau_target, targets.p_budget)
    return {
        "sim0": sim0,
        "space": sim0.space,
        "targets": targets,
        "land_tau": land_tau,
        "land_p": land_p,
        "oracle": oracle_ref,
        "noise": WORKLOADS[cell.workload].noise,
    }


def _no_offload_record(prep: dict) -> dict:
    """The no-offload ablation: exhaustive search restricted to the
    φ=0 rows of the joint grid. On calibrated offload cells no such row
    meets the SLO (demand exceeds the edge-only max by construction), so
    this records the *best the un-offloaded edge can do* — its max-τ row
    — with the violation flags that show why routing is required."""
    space = prep["space"]
    targets = prep["targets"]
    grid = space.grid()
    phi = grid[:, space.names.index("offload_frac")]
    tau, p = prep["land_tau"], prep["land_p"]
    local = np.nonzero(phi == 0.0)[0]
    feasible = local[
        (tau[local] >= targets.tau_target * (1 - 1e-9))
        & (p[local] <= targets.p_budget * (1 + 1e-9))
    ]
    if feasible.size:
        eff = tau[feasible] / np.maximum(p[feasible], 1e-9)
        pick = int(feasible[int(np.argmax(eff))])
    else:
        pick = int(local[int(np.argmax(tau[local]))])
    miss, bust = _violations(float(tau[pick]), float(p[pick]), targets)
    return {
        "feasible_rows": int(feasible.size),
        "config": [float(v) for v in grid[pick]],
        "tau": float(tau[pick]),
        "power": float(p[pick]),
        "violates_tau": bool(miss),
        "violates_power": bool(bust),
    }


def _offload_cell_record(
    cell: Cell,
    prep: dict,
    runs: List[Tuple[Outcome, Trace]],
    iters: int,
    seeds: Sequence[int],
    engine: str,
) -> dict:
    """One offload cell's record: the static-cell shape (CORAL vs
    baselines vs the batched joint oracle, min_power included) plus the
    network/demand provenance and the no-offload ablation."""
    regime = OFFLOAD_REGIMES[cell.regime]
    rec = _cell_record(
        cell,
        prep,
        runs,
        iters,
        seeds,
        engine,
        preset_kinds=("max_power", "default", "min_power"),
    )
    sim0 = prep["sim0"]
    rec["offload"] = {
        "network": regime.network,
        "trace": regime.trace,
        "demand": sim0.demand,
        "demand_factor": regime.demand_factor,
        "slo_frac": regime.slo_frac,
        "p_slack": regime.p_slack,
        "edge_only_max": round(float(sim0.edge_only_max()), 3),
        "no_offload": _no_offload_record(prep),
    }
    return rec


def run_offload_cell(
    cell: Cell,
    iters: int = OFFLOAD_ITERS,
    seeds: Sequence[int] = (0, 1, 2),
    window: int = 10,
    engine: str = "batched",
    device="cuda",
) -> dict:
    """One edge↔pod offload cell → one JSON-ready record (a
    ``BENCH_matrix.json`` ``offload_cells`` entry)."""
    _check_engine(engine)
    prep = _prep_offload_cell(cell)
    runs = _static_runs({cell: prep}, seeds, iters, window, engine, device)
    return _offload_cell_record(cell, prep, runs[cell], iters, seeds, engine)


# The joint slots × shared-DVFS grid keeps a deliberately narrow dual-
# feasible region (4–7% of rows on the calibrated cells), so the budget
# is the largest of the three families: 40 measurements keeps every cell
# ≥ COTENANT_CORAL_GATE of the batched joint oracle across all seeds
# (the skewed cells first observe a feasible row around measurement
# 14–20, and the refinement tail after that is what closes the gap to
# the oracle). Calibration note: the budget is *not* monotonic in
# iters — a later noisy-feasible but truly-infeasible probe can outrank
# an earlier genuine pick on noisy efficiency — so treat this constant
# as calibrated, not merely "enough".
COTENANT_ITERS = 40
COTENANT_CORAL_GATE = 0.85


def _prep_cotenant_cell(cell: Cell) -> dict:
    """Cotenant-cell precompute: the noise-free multi-tenant twin
    (per-tenant τ floors pinned from the regime's solo-max fractions),
    resolved joint targets (τ channel = joint headroom, target 1.0), the
    (headroom, rail-power) landscape and the batched joint oracle — same
    keys as ``_prep_cell`` so the episode request shape is shared."""
    sim0 = build_twin(cell, noise=0.0)
    targets = resolve_cotenant_targets(cell, sim0)
    land_tau, land_p = sim0.exact_all()
    oracle_ref = oracle(sim0.space, sim0, targets.tau_target, targets.p_budget)
    _, workloads = tenant_names(cell)
    return {
        "sim0": sim0,
        "space": sim0.space,
        "targets": targets,
        "land_tau": land_tau,
        "land_p": land_p,
        "oracle": oracle_ref,
        "noise": max(WORKLOADS[w].noise for w in workloads),
    }


def _greedy_record(prep: dict) -> dict:
    """The per-tenant-greedy ablation: each tenant plans as if it owned
    the rail — the grid restricted to rows where every *other* tenant is
    parked at 1 slot — and picks its cheapest floor-meeting row (its
    max-τ row if none meets the floor). The combined operating point is
    the elementwise max of the picks with each tenant keeping its own
    slot ask, snapped to the grid and evaluated *jointly*. On calibrated
    cotenant cells this combination misses a floor or busts the shared
    cap: per-tenant planning never pays for the contention its own slots
    impose on the neighbor."""
    sim0, targets = prep["sim0"], prep["targets"]
    space = sim0.space
    grid = space.grid()
    taus = sim0.tenant_taus()  # (K, N) noise-free per-tenant τ
    power = prep["land_p"]
    slot_idx = list(tenant_slot_indices(space))
    picks = []
    for k in range(sim0.n_tenants):
        others = [i for j, i in enumerate(slot_idx) if j != k]
        solo = np.nonzero(
            np.all([grid[:, i] == 1.0 for i in others], axis=0)
        )[0]
        feas = solo[taus[k, solo] >= sim0.floors[k] * (1 - 1e-9)]
        pick = (
            int(feas[int(np.argmin(power[feas]))])
            if feas.size
            else int(solo[int(np.argmax(taus[k, solo]))])
        )
        picks.append(np.array(grid[pick], np.float64))
    combined = np.max(picks, axis=0)
    for k, i in enumerate(slot_idx):
        combined[i] = picks[k][i]
    cfg = space.snap(tuple(combined))
    headroom, p = sim0.exact(cfg)
    miss, bust = _violations(headroom, p, targets)
    return {
        "config": [float(v) for v in cfg],
        "headroom": headroom,
        "power": p,
        "violates_tau": bool(miss),
        "violates_power": bool(bust),
    }


def _cotenant_cell_record(
    cell: Cell,
    prep: dict,
    runs: List[Tuple[Outcome, Trace]],
    iters: int,
    seeds: Sequence[int],
    engine: str,
) -> dict:
    """One cotenant cell's record: the static-cell shape on the
    (headroom, rail-power) channel — min_power preset included — plus the
    per-tenant provenance (floors, solo maxima) and the per-tenant-greedy
    ablation."""
    regime = COTENANT_REGIMES[cell.regime]
    rec = _cell_record(
        cell,
        prep,
        runs,
        iters,
        seeds,
        engine,
        preset_kinds=("max_power", "default", "min_power"),
    )
    sim0 = prep["sim0"]
    models, workloads = tenant_names(cell)
    rec["cotenant"] = {
        "n_tenants": sim0.n_tenants,
        "p_slack": regime.p_slack,
        "tenants": [
            {
                "model": m,
                "workload": w,
                "tau_frac": regime.tau_fracs[k],
                "floor": sim0.floors[k],
                "solo_max": round(sim0.solo_max(k), 3),
            }
            for k, (m, w) in enumerate(zip(models, workloads))
        ],
        "greedy": _greedy_record(prep),
    }
    return rec


def run_cotenant_cell(
    cell: Cell,
    iters: int = COTENANT_ITERS,
    seeds: Sequence[int] = (0, 1, 2),
    window: int = 10,
    engine: str = "batched",
    device="cuda",
) -> dict:
    """One multi-tenant co-inference cell → one JSON-ready record (a
    ``BENCH_matrix.json`` ``cotenant_cells`` entry)."""
    _check_engine(engine)
    prep = _prep_cotenant_cell(cell)
    runs = _static_runs({cell: prep}, seeds, iters, window, engine, device)
    return _cotenant_cell_record(cell, prep, runs[cell], iters, seeds, engine)


# Fault cells run the FAULT_INTERVALS timeline (explore → fault window →
# recover) and are scored against the *fault-free* oracle: the question
# is what the chosen config actually delivers once the glitch is gone,
# so both scoring and the oracle use the base cell's noise-free twin.
# Acceptance levels (tests/test_torch_faults.py holds the record to them):
# hardened CORAL must hold ≥ FAULT_CORAL_GATE of the fault-free oracle
# with zero true power busts on every cell, while the non-hardened
# ablation — same twin, same fault realization — must end infeasible or
# violating on every (cell, seed).
FAULT_ITERS = FAULT_INTERVALS
FAULT_CORAL_GATE = 0.85


def _prep_fault_cell(cell: Cell, iters: int, seeds: Sequence[int]) -> dict:
    """Fault-cell precompute: the *base* cell's noise-free twin (faults
    corrupt the measurement/actuation path, so ground truth is the clean
    landscape), the base regime's targets, the fault-free oracle, and
    one realized fault-table set per seed — shared by the hardened run,
    the ablation, and both engines, so every comparison sees the same
    glitches."""
    base = _fault_base_cell(cell)
    sim0 = build_twin(base, noise=0.0)
    targets = resolve_fault_targets(cell)
    land_tau, land_p = sim0.exact_all()
    oracle_ref = oracle(sim0.space, sim0, targets.tau_target, targets.p_budget)
    return {
        "sim0": sim0,
        "space": sim0.space,
        "targets": targets,
        "land_tau": land_tau,
        "land_p": land_p,
        "oracle": oracle_ref,
        "noise": WORKLOADS[cell.workload].noise,
        "tables": {s: fault_tables(cell, s, intervals=iters) for s in seeds},
    }


def _fault_requests(
    prep: dict, seeds: Sequence[int], hardened: bool
) -> List[dict]:
    return [
        {
            "space": prep["space"],
            "land_tau": prep["land_tau"],
            "land_p": prep["land_p"],
            "targets": prep["targets"],
            "seed": seed,
            "noise": prep["noise"],
            "tables": prep["tables"][seed],
            "hardened": hardened,
        }
        for seed in seeds
    ]


def _scalar_fault_runs(
    cell: Cell,
    prep: dict,
    seeds: Sequence[int],
    hardened: bool,
    iters: int,
    window: int,
    device,
) -> List[dict]:
    """Per-seed CORAL fault loops of the scalar spec, normalized to the
    engine's run shape."""
    runs = []
    for seed in seeds:
        twin = FaultySimulator(
            build_twin(_fault_base_cell(cell), seed=seed), prep["tables"][seed]
        )
        opt, tr = run_fault_regime(
            prep["space"], twin, prep["targets"], iters=iters, window=window,
            seed=seed, hardened=hardened, device=device,
        )
        res = opt.result()
        runs.append(
            {
                "outcome": (
                    Outcome(res.config, res.tau, res.power, iters)
                    if res is not None
                    else Outcome(None, 0.0, 0.0, iters)
                ),
                "accepted": list(tr.accepted),
                "fallback": list(tr.fallback),
            }
        )
    return runs


def _fault_variant_record(
    prep: dict, runs: List[dict], seeds: Sequence[int]
) -> dict:
    """Score one variant (hardened or ablation) from per-seed run shapes.
    Everything is evaluated on the fault-free twin: the fault episode
    decided *which* config got picked; what that config truly delivers
    is a property of the clean landscape."""
    sim0, targets, oracle_ref = prep["sim0"], prep["targets"], prep["oracle"]
    scores: List[float] = []
    misses: List[bool] = []
    busts: List[bool] = []
    failed: List[bool] = []  # ended infeasible (no pick or violating pick)
    fallbacks: List[int] = []
    rejected: List[int] = []
    best: Optional[Tuple[float, float, float, tuple]] = None
    for run in runs:
        out = run["outcome"]
        if out.config is None:
            scores.append(0.0)
            misses.append(True)
            busts.append(False)
            failed.append(True)
        else:
            tau, power = sim0.exact(out.config)
            miss, bust = _violations(tau, power, targets)
            s = 0.0 if (miss or bust) else _score(
                tau, power, targets.mode, oracle_ref
            )
            scores.append(s)
            misses.append(miss)
            busts.append(bust)
            failed.append(bool(miss or bust))
            if not (miss or bust) and (best is None or s > best[0]):
                best = (s, tau, power, tuple(out.config))
        fallbacks.append(int(sum(run["fallback"])))
        rejected.append(len(run["accepted"]) - int(sum(run["accepted"])))
    n = len(seeds)
    return {
        "score": sum(scores) / n,
        "score_min": min(scores),
        "score_floor": round(max(0.0, min(scores) - SCORE_FLOOR_MARGIN), 4),
        "violation_rate": sum(a or b for a, b in zip(misses, busts)) / n,
        "power_violations": int(sum(busts)),
        # per-seed "ended infeasible or violating" count — the ablation
        # gate requires failed_runs == n_runs on every fault cell
        "n_runs": n,
        "failed_runs": int(sum(failed)),
        "fallback_intervals": sum(fallbacks) / n,
        "rejected_samples": sum(rejected) / n,
        "tau": best[1] if best else 0.0,
        "power": best[2] if best else 0.0,
        "config": list(best[3]) if best else None,
    }


def _fault_cell_record(
    cell: Cell,
    prep: dict,
    hardened_runs: List[dict],
    ablation_runs: List[dict],
    iters: int,
    seeds: Sequence[int],
) -> dict:
    regime = FAULT_REGIMES[cell.regime]
    targets = prep["targets"]
    return {
        "device": cell.device,
        "model": cell.model,
        "workload": cell.workload,
        "regime": cell.regime,
        "mode": targets.mode,
        "tau_target": targets.tau_target,
        "p_budget": targets.p_budget if targets.capped else None,
        "space_size": prep["space"].size(),
        "fault": {
            "schedule": regime.fault,
            "base_regime": regime.base,
            "intervals": iters,
        },
        "oracle": {
            "config": (
                list(prep["oracle"].config) if prep["oracle"].config else None
            ),
            "tau": prep["oracle"].tau,
            "power": prep["oracle"].power,
            "measurements": prep["oracle"].measurements,
        },
        "hardened": _fault_variant_record(prep, hardened_runs, seeds),
        "ablation": _fault_variant_record(prep, ablation_runs, seeds),
    }


def run_fault_cell(
    cell: Cell,
    iters: int = FAULT_ITERS,
    seeds: Sequence[int] = (0, 1, 2),
    window: int = 10,
    engine: str = "batched",
    device="cuda",
) -> dict:
    """One fault-injection cell → one JSON-ready record (a
    ``BENCH_matrix.json`` ``fault_cells`` entry).

    Runs hardened CORAL (robust ingest gate + watchdog fallback +
    actuation readback/retry) and the non-hardened ablation through the
    same fault-injected twin — byte-identical fault realizations — and
    scores both against the fault-free oracle. Under the batched engine
    both variants are one engine call."""
    _check_engine(engine)
    prep = _prep_fault_cell(cell, iters, seeds)
    runs = _fault_runs({cell: prep}, seeds, iters, window, engine, device)
    return _fault_cell_record(
        cell, prep, runs[(cell, True)], runs[(cell, False)], iters, seeds
    )


def _fault_runs(
    preps: Dict[Cell, dict], seeds: Sequence[int], iters: int, window: int,
    engine: str, device,
) -> Dict[Tuple[Cell, bool], list]:
    """Every (cell, hardened) variant's per-seed runs: under the batched
    engine one request batch — one engine call for all of them."""
    runs: Dict[Tuple[Cell, bool], list] = {}
    if engine == "batched":
        reqs, owners = [], []
        for c, prep in preps.items():
            for hardened in (True, False):
                cell_reqs = _fault_requests(prep, seeds, hardened)
                owners.extend([(c, hardened)] * len(cell_reqs))
                reqs.extend(cell_reqs)
        outs = run_fault_requests(reqs, iters=iters, window=window, device=device)
        for owner, out in zip(owners, outs):
            runs.setdefault(owner, []).append(out)
    else:
        for c, prep in preps.items():
            for hardened in (True, False):
                runs[(c, hardened)] = _scalar_fault_runs(
                    c, prep, seeds, hardened, iters, window, device
                )
    return runs


# ---------------------------------------------------------------------------
# Dynamic (drift) cells
# ---------------------------------------------------------------------------

# Drift-cell acceptance levels (tests/test_torch_drift.py holds the record
# to them): drift-adaptive CORAL must average ≥ this fraction of the
# post-shift oracle, the static ablation must average ≤ the ceiling, and
# the gap between them must show that re-exploration — not luck — closed
# it.
DRIFT_ADAPTIVE_GATE = 0.85
DRIFT_STATIC_CEILING = 0.5
DRIFT_SEPARATION = 0.3


def _prep_drift_cell(cell: Cell, intervals: int) -> dict:
    """Per-cell drift precompute: the stacked per-interval landscapes
    (one sweep per *unique* drift state), per-interval budget scales,
    and the post-shift oracle — everything scoring and the batched
    episode engine share."""
    regime = REGIMES[cell.regime]
    twin = build_twin(cell, noise=0.0)
    sim0, schedule = twin.base, twin.schedule
    targets = resolve_targets(cell, sim0)
    land_tau, land_p = twin.landscapes(intervals)
    budget_scale = schedule.states_stacked(intervals)["budget_scale"]
    twin.set_time(intervals - 1)
    p_budget_post = targets.p_budget * twin.state.budget_scale
    post_oracle = oracle(sim0.space, twin, targets.tau_target, p_budget_post)
    return {
        "sim0": sim0,
        "space": sim0.space,
        "targets": targets,
        "schedule": schedule,
        "regime": regime,
        "land_tau": land_tau,
        "land_p": land_p,
        "budget_scale": budget_scale,
        "p_budget_post": p_budget_post,
        "post_oracle": post_oracle,
        "noise": WORKLOADS[cell.workload].noise,
    }


def _drift_requests(
    prep: dict, seeds: Sequence[int], adaptive: bool
) -> List[dict]:
    return [
        {
            "space": prep["space"],
            "land_tau": prep["land_tau"],
            "land_p": prep["land_p"],
            "budget_scale": prep["budget_scale"],
            "targets": prep["targets"],
            "seed": seed,
            "noise": prep["noise"],
            "adaptive": adaptive,
        }
        for seed in seeds
    ]


def _scalar_drift_runs(
    cell: Cell,
    prep: dict,
    seeds: Sequence[int],
    adaptive: bool,
    intervals: int,
    explore_budget: int,
    window: int,
    device,
) -> List[dict]:
    """Per-seed CORAL drift loops of the scalar spec, normalized to the
    engine's run shape."""
    runs = []
    space = prep["space"]
    for seed in seeds:
        opt, tr = run_drift_regime(
            space,
            build_twin(cell, seed=seed),
            prep["targets"],
            prep["schedule"],
            intervals,
            explore_budget=explore_budget,
            window=window,
            seed=seed,
            adaptive=adaptive,
            sigma=prep["noise"],
            device=device,
        )
        res = opt.result()
        runs.append(
            {
                "idxs": np.asarray(
                    [row_index(space, cfg) for cfg in tr.configs]
                ),
                "exploring": list(tr.exploring),
                "resets": tr.resets,
                "result_idx": (
                    row_index(space, res.config) if res is not None else None
                ),
            }
        )
    return runs


def _batched_drift_runs(eps: List, space) -> List[dict]:
    return [
        {
            "idxs": np.asarray([row_index(space, cfg) for cfg in ep.configs]),
            "exploring": ep.exploring,
            "resets": ep.resets,
            "result_idx": (
                row_index(space, ep.result_config)
                if ep.result_config is not None
                else None
            ),
        }
        for ep in eps
    ]


def _drift_variant_record(
    prep: dict,
    runs: List[dict],
    seeds: Sequence[int],
    intervals: int,
    shift_start: int,
) -> dict:
    """Score one variant (adaptive or static) from per-seed run shapes —
    batched twin sweeps over the precomputed per-interval landscapes
    instead of ``set_time`` round-trips per interval per seed."""
    targets = prep["targets"]
    post_oracle = prep["post_oracle"]
    p_budget_post = prep["p_budget_post"]
    lt_post, lp_post = prep["land_tau"][-1], prep["land_p"][-1]

    def final_state_scores(idxs: np.ndarray) -> np.ndarray:
        """Normalized-vs-post-oracle scores at the fully-shifted state
        for a vector of config rows (violating → 0)."""
        if post_oracle.config is None:
            return np.zeros(idxs.shape[0])
        tau, p = lt_post[idxs], lp_post[idxs]
        ok = (tau >= targets.tau_target * (1 - 1e-9)) & (
            p <= p_budget_post * (1 + 1e-9)
        )
        if targets.mode == "throughput":
            score = tau / max(post_oracle.tau, 1e-9)
        else:
            score = (tau / np.maximum(p, 1e-9)) / max(
                post_oracle.efficiency, 1e-9
            )
        return np.where(ok, score, 0.0)

    finals: List[float] = []
    recoveries: List[Optional[int]] = []
    transients: List[float] = []
    resets: List[int] = []
    post = np.arange(shift_start, intervals)
    for run in runs:
        idxs = run["idxs"]
        ridx = run["result_idx"]
        finals.append(
            float(final_state_scores(np.asarray([ridx]))[0])
            if ridx is not None
            else 0.0
        )
        resets.append(run["resets"])
        # recovery: first post-shift interval from which every *held*
        # interval onward scores ≥ the adaptive gate (exploration probes
        # between holds don't break the streak — they are the search,
        # not the operating point). The streak check is a suffix-min
        # over hold scores — O(holds), not the O(holds²) rescan.
        holds = np.asarray(
            [t for t in post if not run["exploring"][t]], np.int64
        )
        rec = None
        if holds.size:
            scores = final_state_scores(idxs[holds])
            suffix_min = np.minimum.accumulate(scores[::-1])[::-1]
            clears = np.nonzero(suffix_min >= DRIFT_ADAPTIVE_GATE)[0]
            if clears.size:
                rec = int(holds[clears[0]]) - shift_start
        recoveries.append(rec)
        # transient violations, against the constraints in force at t —
        # one gather over the stacked landscapes
        tau_t = prep["land_tau"][post, idxs[post]]
        p_t = prep["land_p"][post, idxs[post]]
        cap_t = targets.p_budget * prep["budget_scale"][post]
        viol = (tau_t < targets.tau_target * (1 - 1e-9)) | (
            p_t > cap_t * (1 + 1e-9)
        )
        transients.append(float(viol.sum()) / (intervals - shift_start))
    n = len(seeds)
    recovered = [r for r in recoveries if r is not None]
    mean_final = sum(finals) / n
    return {
        "final_score": mean_final,
        "final_score_min": min(finals),
        "final_score_max": max(finals),
        "score_floor": round(max(0.0, mean_final - SCORE_FLOOR_MARGIN), 4),
        "recovered_rate": len(recovered) / n,
        "recovery_intervals": (
            sum(recovered) / len(recovered) if recovered else None
        ),
        "transient_violation_rate": sum(transients) / n,
        "resets": sum(resets) / n,
    }


def _drift_cell_record(
    cell: Cell,
    prep: dict,
    adaptive: dict,
    static: dict,
    intervals: int,
    shift_start: int,
) -> dict:
    targets = prep["targets"]
    post_oracle = prep["post_oracle"]
    return {
        "device": cell.device,
        "model": cell.model,
        "workload": cell.workload,
        "regime": cell.regime,
        "mode": targets.mode,
        "tau_target": targets.tau_target,
        "p_budget": targets.p_budget if targets.capped else None,
        "p_budget_post": prep["p_budget_post"] if targets.capped else None,
        "space_size": prep["space"].size(),
        "drift": {
            "schedule": prep["regime"].drift,
            "shift_start": shift_start,
            "shift_end": prep["schedule"].shift_end,
            "intervals": intervals,
        },
        "post_oracle": {
            "config": list(post_oracle.config) if post_oracle.config else None,
            "tau": post_oracle.tau,
            "power": post_oracle.power,
        },
        "adaptive": adaptive,
        "static": static,
    }


def run_drift_cell(
    cell: Cell,
    seeds: Sequence[int] = (0, 1, 2),
    window: int = 10,
    explore_budget: int = 10,
    intervals: int = DRIFT_INTERVALS,
    shift_start: int = DRIFT_SHIFT_START,
    engine: str = "batched",
    device="cuda",
) -> dict:
    """One dynamic (non-stationary) cell → one JSON-ready record (a
    ``BENCH_matrix.json`` ``drift_cells`` entry).

    Runs drift-adaptive CORAL and the static (no-re-exploration) ablation
    through the same drifting twin and scores both against the
    *post-shift* oracle: the exhaustive search on the fully-shifted
    noise-free landscape under the post-shift budget. Metrics:

      final_score      — the optimizer's end-of-run choice, normalized
                         vs. the post-shift oracle (violating → 0);
      recovery_intervals — intervals from the shift until the loop holds
                         a ≥0.85-scoring config for the rest of the run
                         (None if it never settles that high);
      transient_violation_rate — fraction of post-shift intervals whose
                         *applied* config truly violated the constraints
                         in force at that interval (exploration probes
                         included: re-exploration's price is visible);
      resets           — exploration epochs spent after the shift.

    Under the batched engine both variants are one engine call.
    """
    _check_engine(engine)
    prep = _prep_drift_cell(cell, intervals)
    runs = _drift_runs(
        {cell: prep}, seeds, intervals, explore_budget, window, engine, device
    )
    variants = {
        adaptive: _drift_variant_record(
            prep, runs[(cell, adaptive)], seeds, intervals, shift_start
        )
        for adaptive in (True, False)
    }
    return _drift_cell_record(
        cell, prep, variants[True], variants[False], intervals, shift_start
    )


def _drift_runs(
    preps: Dict[Cell, dict], seeds: Sequence[int], intervals: int,
    explore_budget: int, window: int, engine: str, device,
) -> Dict[Tuple[Cell, bool], list]:
    """Every (cell, adaptive) variant's per-seed runs: under the batched
    engine one request batch — one engine call for all of them."""
    runs: Dict[Tuple[Cell, bool], list] = {}
    if engine == "batched":
        reqs, owners = [], []
        for c, prep in preps.items():
            for adaptive in (True, False):
                cell_reqs = _drift_requests(prep, seeds, adaptive)
                owners.extend([(c, adaptive)] * len(cell_reqs))
                reqs.extend(cell_reqs)
        eps = run_drift_requests(
            reqs, intervals=intervals, explore_budget=explore_budget, window=window,
            device=device,
        )
        by_owner: Dict[Tuple[Cell, bool], list] = {}
        for owner, ep in zip(owners, eps):
            by_owner.setdefault(owner, []).append(ep)
        for owner, cell_eps in by_owner.items():
            runs[owner] = _batched_drift_runs(cell_eps, preps[owner[0]]["space"])
    else:
        for c, prep in preps.items():
            for adaptive in (True, False):
                runs[(c, adaptive)] = _scalar_drift_runs(
                    c, prep, seeds, adaptive, intervals, explore_budget, window, device
                )
    return runs


def run_matrix(
    cells: Optional[Sequence[Cell]] = None,
    iters: int = 10,
    seeds: Sequence[int] = (0, 1, 2),
    engine: str = "batched",
    window: int = 10,
    offload_cells: Optional[Sequence[Cell]] = None,
    cotenant_cells: Optional[Sequence[Cell]] = None,
    fault_cells: Optional[Sequence[Cell]] = None,
    device="cuda",
) -> dict:
    """Run every cell and assemble the record, as ``BENCH_matrix.json``'s:
    ``cells`` (the static entries), ``drift_cells``, ``offload_cells``,
    ``cotenant_cells``, ``fault_cells``, their ``summary``, the ``grid``
    they span, and ``wall_clock_s``, the host-clock split of the run's
    phases (``{static,offload,cotenant,fault,drift}_{prep,episodes,
    score}_s``, as the reference names them).

    Cells whose regime names a drift schedule run the non-stationary loop
    (``run_drift_cell``: adaptive vs static ablation) and land in
    ``drift_cells``; stationary cells keep the CORAL-vs-baselines shape in
    ``cells``. ``offload_cells``, ``cotenant_cells`` and ``fault_cells``
    (each defaults to its ``MATRIX_*`` tuple when ``cells`` is None, to
    none when a list is given) run CORAL over the joint edge↔pod grid at
    ``OFFLOAD_ITERS``, over the joint slots × shared-DVFS grid at
    ``COTENANT_ITERS``, and hardened CORAL against its ablation at
    ``FAULT_ITERS``. ``cells=None`` is the reference's default grid
    (``enumerate_cells()``). Under the batched engine each family is one
    request batch: one engine call of its T steps on ``device``.
    """
    _check_engine(engine)
    if offload_cells is None:
        offload_cells = MATRIX_OFFLOAD_CELLS if cells is None else ()
    if cotenant_cells is None:
        cotenant_cells = MATRIX_COTENANT_CELLS if cells is None else ()
    if fault_cells is None:
        fault_cells = MATRIX_FAULT_CELLS if cells is None else ()
    if cells is None:
        cells = enumerate_cells()
    static_cells = [c for c in cells if not REGIMES[c.regime].dynamic]
    dynamic_cells = [c for c in cells if REGIMES[c.regime].dynamic]
    wall: Dict[str, float] = {}

    # ---- static cells --------------------------------------------------
    t0 = time.perf_counter()
    preps = {c: _prep_cell(c) for c in static_cells}
    wall["static_prep_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    runs_by_cell = _static_runs(preps, seeds, iters, window, engine, device)
    wall["static_episodes_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    records = [
        _cell_record(c, preps[c], runs_by_cell[c], iters, seeds, engine)
        for c in static_cells
    ]
    wall["static_score_s"] = time.perf_counter() - t0

    # ---- offload and cotenant cells: static episodes on joint grids ----
    joint: Dict[str, List[dict]] = {}
    for family, fam_cells, prep_fn, record_fn, fam_iters in (
        ("offload", offload_cells, _prep_offload_cell, _offload_cell_record,
         OFFLOAD_ITERS),
        ("cotenant", cotenant_cells, _prep_cotenant_cell, _cotenant_cell_record,
         COTENANT_ITERS),
    ):
        t0 = time.perf_counter()
        jpreps = {c: prep_fn(c) for c in fam_cells}
        wall[f"{family}_prep_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        jruns = _static_runs(jpreps, seeds, fam_iters, window, engine, device)
        wall[f"{family}_episodes_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        joint[family] = [
            record_fn(c, jpreps[c], jruns[c], fam_iters, seeds, engine)
            for c in fam_cells
        ]
        wall[f"{family}_score_s"] = time.perf_counter() - t0

    # ---- fault cells ---------------------------------------------------
    t0 = time.perf_counter()
    fpreps = {c: _prep_fault_cell(c, FAULT_ITERS, seeds) for c in fault_cells}
    wall["fault_prep_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    fault_runs = _fault_runs(fpreps, seeds, FAULT_ITERS, window, engine, device)
    wall["fault_episodes_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    fault_records = [
        _fault_cell_record(
            c, fpreps[c], fault_runs[(c, True)], fault_runs[(c, False)],
            FAULT_ITERS, seeds,
        )
        for c in fault_cells
    ]
    wall["fault_score_s"] = time.perf_counter() - t0

    # ---- drift cells ---------------------------------------------------
    t0 = time.perf_counter()
    dpreps = {c: _prep_drift_cell(c, DRIFT_INTERVALS) for c in dynamic_cells}
    wall["drift_prep_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    drift_runs = _drift_runs(dpreps, seeds, DRIFT_INTERVALS, 10, window, engine, device)
    wall["drift_episodes_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    drift_records = []
    for c in dynamic_cells:
        variants = {
            adaptive: _drift_variant_record(
                dpreps[c], drift_runs[(c, adaptive)], seeds, DRIFT_INTERVALS,
                DRIFT_SHIFT_START,
            )
            for adaptive in (True, False)
        }
        drift_records.append(
            _drift_cell_record(
                c, dpreps[c], variants[True], variants[False], DRIFT_INTERVALS,
                DRIFT_SHIFT_START,
            )
        )
    wall["drift_score_s"] = time.perf_counter() - t0

    all_cells = (
        list(cells) + list(offload_cells) + list(cotenant_cells) + list(fault_cells)
    )
    return {
        "schema_version": SCHEMA_VERSION,
        "engine": engine,
        "iters": iters,
        "seeds": list(seeds),
        "wall_clock_s": wall,
        "grid": {
            "devices": sorted({c.device for c in all_cells}),
            "models": sorted({c.model for c in all_cells}),
            "workloads": sorted({c.workload for c in all_cells}),
            "regimes": sorted({c.regime for c in cells}),
            "offload_regimes": sorted({c.regime for c in offload_cells}),
            "cotenant_regimes": sorted({c.regime for c in cotenant_cells}),
            "fault_regimes": sorted({c.regime for c in fault_cells}),
        },
        "cells": records,
        "drift_cells": drift_records,
        "offload_cells": joint["offload"],
        "cotenant_cells": joint["cotenant"],
        "fault_cells": fault_records,
        "summary": _summarize(
            records, drift_records, joint["offload"], joint["cotenant"],
            fault_records,
        ),
    }


def _summarize(
    records: List[dict],
    drift_records: List[dict] = (),
    offload_records: List[dict] = (),
    cotenant_records: List[dict] = (),
    fault_records: List[dict] = (),
) -> dict:
    """The reference's summary: static, drift, offload, cotenant and fault
    keys."""
    single = [
        r["coral"]["score"] for r in records if REGIMES[r["regime"]].single_target
    ]
    dual = [r for r in records if REGIMES[r["regime"]].dual_constraint]
    all_scores = [r["coral"]["score"] for r in records]
    return {
        "n_cells": len(records),
        "mean_coral_score": sum(all_scores) / max(len(all_scores), 1),
        "min_single_target_score": min(single) if single else None,
        "dual_power_violations": int(
            sum(r["coral"]["power_violations"] for r in dual)
        ),
        # τ-floor boundary misses (power stayed within budget)
        "dual_tau_miss_cells": int(
            sum(
                r["coral"]["violation_rate"] > 0
                and r["coral"]["power_violations"] == 0
                for r in dual
            )
        ),
        "n_drift_cells": len(drift_records),
        "min_drift_adaptive_score": (
            min(r["adaptive"]["final_score"] for r in drift_records)
            if drift_records else None
        ),
        "max_drift_static_score": (
            max(r["static"]["final_score"] for r in drift_records)
            if drift_records else None
        ),
        "min_drift_separation": (
            min(r["adaptive"]["final_score"] - r["static"]["final_score"]
                for r in drift_records)
            if drift_records else None
        ),
        "n_offload_cells": len(offload_records),
        "min_offload_score": (
            min(r["coral"]["score"] for r in offload_records)
            if offload_records else None
        ),
        "offload_power_violations": int(
            sum(r["coral"]["power_violations"] for r in offload_records)
        ),
        # (preset | no-offload ablation) entries that were truly feasible:
        # only the joint route-fraction × DVFS search should serve the
        # offered demand within budget
        "offload_feasible_baselines": _feasible_baselines(
            offload_records, "offload", "no_offload"
        ),
        "n_cotenant_cells": len(cotenant_records),
        "min_cotenant_score": (
            min(r["coral"]["score"] for r in cotenant_records)
            if cotenant_records else None
        ),
        "cotenant_power_violations": int(
            sum(r["coral"]["power_violations"] for r in cotenant_records)
        ),
        # (preset | per-tenant-greedy) entries that were truly feasible:
        # only the joint slots × shared-DVFS negotiation should meet every
        # tenant's floor within the shared rail budget
        "cotenant_feasible_baselines": _feasible_baselines(
            cotenant_records, "cotenant", "greedy"
        ),
        "n_fault_cells": len(fault_records),
        "min_fault_hardened_score": (
            min(r["hardened"]["score"] for r in fault_records)
            if fault_records else None
        ),
        "fault_power_violations": int(
            sum(r["hardened"]["power_violations"] for r in fault_records)
        ),
        # non-hardened ablation (cell, seed) runs that ended feasible:
        # under the injected faults only the hardened path should
        "fault_feasible_ablations": int(
            sum(r["ablation"]["n_runs"] - r["ablation"]["failed_runs"]
                for r in fault_records)
        ),
    }


def _feasible_baselines(records: List[dict], family: str, ablation: str) -> int:
    """How many of the presets and the family's ablation ended truly
    feasible (neither flag set), over every record."""
    return int(
        sum(
            not (b["violates_tau"] or b["violates_power"])
            for r in records
            for b in (
                r["baselines"]["max_power"],
                r["baselines"]["default"],
                r["baselines"]["min_power"],
                r[family][ablation],
            )
        )
    )


def diff_records(got, want, rel: float = 1e-12, path: str = "") -> List[str]:
    """Where record ``got`` differs from ``want``: configs, flags, counts
    and every other non-float exactly, floats within ``rel`` (relative).
    Tuples compare as lists (JSON has no tuples). Returns one line per
    difference, empty when they agree."""
    if isinstance(want, dict) and isinstance(got, dict):
        out = [f"{path}: keys {sorted(got)} != {sorted(want)}"] if set(got) != set(want) else []
        for key in sorted(set(got) & set(want)):
            out += diff_records(got[key], want[key], rel, f"{path}.{key}")
        return out
    if isinstance(want, (list, tuple)) and isinstance(got, (list, tuple)):
        if len(got) != len(want):
            return [f"{path}: length {len(got)} != {len(want)}"]
        out = []
        for i, (g, w) in enumerate(zip(got, want)):
            out += diff_records(g, w, rel, f"{path}[{i}]")
        return out
    is_float = isinstance(want, float) or isinstance(got, float)
    both_num = not isinstance(want, bool) and not isinstance(got, bool) and all(
        isinstance(v, (int, float)) for v in (got, want)
    )
    if is_float and both_num:
        if math.isclose(got, want, rel_tol=rel, abs_tol=0.0):
            return []
        return [f"{path}: {got!r} != {want!r} (rel {rel})"]
    return [] if got == want and type(got) is type(want) else [f"{path}: {got!r} != {want!r}"]
