"""The common evaluation loop (paper Fig. 2): optimizer proposes a config,
the device applies it and runs inference, measured (τ, p) feed back.

The port of ``repro.core.evaluate`` for the static, drift and fault
cells. ``run_coral`` (and ``run_regime`` over it), ``run_drift_regime``
and ``run_fault_regime`` are the scalar executable specification: one
``CORAL`` against a measurable twin, one round per control interval. The
batched engine (``core/episode.py``) is held to them config for config.
``run_cell(CellSpec)`` runs one cell of any family: static, drift,
offload, cotenant or fault (the offload and cotenant cells run the static
loop over their joint grids).

The simulator a loop measures is named ``twin`` here, since ``device`` is
the torch device the windowed dCor runs on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from repro_torch.core.baselines import Outcome
from repro_torch.core.coral import CORAL
from repro_torch.core.drift import DriftConfig
from repro_torch.core.faults import RobustConfig
from repro_torch.core.space import ConfigSpace


@dataclasses.dataclass
class Trace:
    configs: List[tuple]
    taus: List[float]
    powers: List[float]
    rewards: List[float]


@dataclasses.dataclass(frozen=True)
class RegimeTargets:
    """Resolved constraint shape for one evaluation run.

    ``mode`` selects CORAL's objective ("dual": Alg. 1 reward, τ target +
    power budget; "throughput": single-target max-τ). ``p_budget`` is
    ``inf`` for uncapped regimes.
    """

    mode: str
    tau_target: float
    p_budget: float = float("inf")

    @property
    def capped(self) -> bool:
        return math.isfinite(self.p_budget)

    def feasible(self, tau: float, power: float) -> bool:
        return tau >= self.tau_target and power <= self.p_budget


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One runnable scenario cell, fully specified as data.

    ``cell`` is a ``repro_torch.experiments.scenarios.Cell`` (its regime
    name selects the family); ``iters=None`` takes the family's measurement
    budget (10 static, ``OFFLOAD_ITERS`` offload, ``COTENANT_ITERS``
    cotenant, ``FAULT_ITERS`` fault; drift cells pace by intervals
    instead). ``engine`` is "batched" (the episode engine) or
    "scalar" (the CORAL loop, one episode at a time).
    """

    cell: object
    iters: Optional[int] = None
    seeds: Sequence[int] = (0, 1, 2)
    window: int = 10
    engine: str = "batched"


@dataclasses.dataclass(frozen=True)
class CellRecord:
    """A family-tagged, JSON-ready cell record (``family`` is one of
    "static" | "drift" | "offload" | "cotenant" | "fault"; ``record`` is
    the matching ``BENCH_matrix`` array entry)."""

    family: str
    record: dict


def run_cell(spec: CellSpec, device="cuda") -> CellRecord:
    """Run one cell. Cotenant and offload regimes run CORAL over their
    joint grids at their calibrated budgets, fault regimes hardened CORAL
    against its blind ablation, drift regimes the adaptive-vs-static
    ablation, stationary regimes the CORAL-vs-baselines loop; an unknown
    regime raises KeyError. Imports are lazy — the regime tables and
    record assemblers live in ``repro_torch.experiments``, which imports
    this module."""
    from repro_torch.experiments import matrix, scenarios

    cell = spec.cell
    kw = dict(seeds=tuple(spec.seeds), window=spec.window, engine=spec.engine,
              device=device)
    if cell.regime in scenarios.COTENANT_REGIMES:
        iters = matrix.COTENANT_ITERS if spec.iters is None else spec.iters
        return CellRecord("cotenant", matrix.run_cotenant_cell(cell, iters=iters, **kw))
    if cell.regime in scenarios.OFFLOAD_REGIMES:
        iters = matrix.OFFLOAD_ITERS if spec.iters is None else spec.iters
        return CellRecord("offload", matrix.run_offload_cell(cell, iters=iters, **kw))
    if cell.regime in scenarios.FAULT_REGIMES:
        iters = matrix.FAULT_ITERS if spec.iters is None else spec.iters
        return CellRecord("fault", matrix.run_fault_cell(cell, iters=iters, **kw))
    if scenarios.REGIMES[cell.regime].dynamic:
        return CellRecord("drift", matrix.run_drift_cell(cell, **kw))
    iters = 10 if spec.iters is None else spec.iters
    return CellRecord("static", matrix.run_static_cell(cell, iters=iters, **kw))


def run_regime(
    space: ConfigSpace,
    twin,
    targets: RegimeTargets,
    iters: int = 10,
    window: int = 10,
    seed: int = 0,
    device="cuda",
) -> tuple[Outcome, Trace]:
    """``run_coral`` under a named constraint regime."""
    return run_coral(
        space,
        twin,
        tau_target=targets.tau_target,
        p_budget=targets.p_budget,
        iters=iters,
        window=window,
        seed=seed,
        mode=targets.mode,
        device=device,
    )


def measurements_to_feasible(tr: Trace, targets: RegimeTargets) -> Optional[int]:
    """Exploration cost: 1-based index of the first measurement that met
    the regime's constraints (None if the run never did). Throughput-mode
    targets carry ``tau_target=0``, so only the power cap gates
    feasibility there."""
    for i, (tau, p) in enumerate(zip(tr.taus, tr.powers)):
        if targets.feasible(tau, p):
            return i + 1
    return None


def run_coral(
    space: ConfigSpace,
    twin,
    tau_target: float,
    p_budget: float = float("inf"),
    p_min: float = 0.0,
    iters: int = 10,
    window: int = 10,
    seed: int = 0,
    mode: str = "dual",  # dual | throughput (single-target §IV-B)
    device="cuda",
) -> tuple[Outcome, Trace]:
    """One CORAL run against a measurable twin: ``iters`` propose →
    measure → observe rounds of the Alg. 1–2 loop, returning the chosen
    ``Outcome`` and the full per-iteration ``Trace``. The scalar
    reference the batched episode engine is held to."""
    opt = CORAL(
        space,
        tau_target,
        p_budget,
        p_min=p_min,
        window=window,
        seed=seed,
        mode=mode,
        device=device,
    )
    tr = Trace([], [], [], [])
    for _ in range(iters):
        cfg = opt.propose()
        tau, p = twin.measure(cfg)
        r = opt.observe(cfg, tau, p)
        tr.configs.append(cfg)
        tr.taus.append(tau)
        tr.powers.append(p)
        tr.rewards.append(r)
    res = opt.result()
    if res is None:
        return Outcome(None, 0.0, 0.0, iters), tr
    return Outcome(res.config, res.tau, res.power, iters), tr


@dataclasses.dataclass
class DriftTrace:
    """Per-interval record of a drift run: what was applied, what was
    measured, and whether the optimizer was exploring or holding."""

    configs: List[tuple]
    taus: List[float]
    powers: List[float]
    exploring: List[bool]
    budgets: List[float]  # effective p_budget at each interval
    resets: int = 0


def run_drift_regime(
    space: ConfigSpace,
    twin,  # a DriftingSimulator (or anything with set_time + measure)
    targets: RegimeTargets,
    schedule,  # repro_torch.device.hw.DriftSchedule
    intervals: int,
    explore_budget: int = 10,
    window: int = 10,
    seed: int = 0,
    adaptive: bool = True,
    sigma: float = 0.05,
    device="cuda",
) -> tuple[CORAL, DriftTrace]:
    """Closed loop over a non-stationary device twin.

    Each control interval advances the device's drift clock, applies the
    optimizer's next config (a proposal while exploring, the held config
    while monitoring) and feeds the measurement back. ``adaptive=False``
    is the static ablation: one exploration epoch, then hold forever with
    the change-point monitor off — the one-shot tuning that PolyThrottle
    shows breaking under changing operating conditions.

    Budget steps are *commanded*, not detected: the loop reads the
    schedule's ``budget_scale`` each interval and notifies the adaptive
    optimizer via ``set_p_budget``; the static ablation is oblivious (it
    keeps running against the stale budget, and is scored against the
    real one).
    """
    drift = DriftConfig(
        explore_budget=explore_budget,
        sigma=sigma,
        monitor=adaptive,
        halflife=float(window),
    )
    opt = CORAL(
        space,
        targets.tau_target,
        targets.p_budget,
        window=window,
        seed=seed,
        mode=targets.mode,
        drift=drift,
        device=device,
    )
    tr = DriftTrace([], [], [], [], [])
    for t in range(intervals):
        twin.set_time(t)
        budget_t = targets.p_budget * schedule.state_at(t).budget_scale
        if adaptive and budget_t != opt.p_budget:
            opt.set_p_budget(budget_t)
        cfg = opt.next_config()
        # read the flag *after* next_config: an infeasible-epoch retry
        # flips the optimizer back into exploration and returns a probe,
        # which must not be logged (and scored) as a held operating point
        tr.exploring.append(opt.exploring)
        tau, p = twin.measure(cfg)
        opt.record(cfg, tau, p)
        tr.configs.append(tuple(cfg))
        tr.taus.append(tau)
        tr.powers.append(p)
        tr.budgets.append(budget_t)
    tr.resets = opt.state.resets
    return opt, tr


@dataclasses.dataclass
class FaultTrace:
    """Per-interval record of a fault run: what was commanded, what was
    actually in force, what came back over telemetry, and what the
    hardened ingest did with it."""

    commanded: List[tuple]
    applied: List[tuple]
    taus: List[float]
    powers: List[float]
    accepted: List[bool]  # sample survived the hardened ingest gate
    fallback: List[bool]  # watchdog held the safe config this interval


def run_fault_regime(
    space: ConfigSpace,
    twin,  # a FaultySimulator (set_time + actuate + measure)
    targets: RegimeTargets,
    iters: int = 40,
    window: int = 10,
    seed: int = 0,
    hardened: bool = True,
    robust=None,
    device="cuda",
) -> tuple[CORAL, FaultTrace]:
    """Closed loop over a fault-injected device twin — the scalar
    executable specification of ``episode.run_fault_requests``.

    Each control interval: the optimizer commands a config; the
    actuation path applies it (or silently sticks / firmware-resets —
    the hardened controller retries up to ``robust.act_retries`` times,
    the ablation writes blind); the twin measures the config *actually
    in force*, possibly spiking or dropping the sample in transit.
    Hardened CORAL attributes the measurement to the readback config and
    runs it through the robust ingest gate; the non-hardened ablation
    attributes it to the *commanded* config and swallows it raw —
    exactly the two failure couplings the fault cells score.
    """
    rb = robust if robust is not None else RobustConfig()
    # hardened constraint back-off: chase the margin-shrunk budget so
    # boundary noise cannot flip an over-budget config to feasible
    # (scoring upstream always uses the full budget)
    p_budget = targets.p_budget * (1.0 - rb.p_margin) if hardened else targets.p_budget
    opt = CORAL(
        space,
        targets.tau_target,
        p_budget,
        window=window,
        seed=seed,
        mode=targets.mode,
        robust=rb if hardened else None,
        device=device,
    )
    tr = FaultTrace([], [], [], [], [], [])
    for t in range(iters):
        twin.set_time(t)
        # read the watchdog *before* next_config: that is the state the
        # batched step's guard sees for this interval
        guarded = hardened and opt._dark >= rb.watchdog
        cmd = opt.next_config()
        applied = twin.actuate(cmd, retries=rb.act_retries if hardened else 0)
        tau, p = twin.measure(applied)
        attr = applied if hardened else cmd
        n_before = len(opt.state.history)
        opt.record(attr, tau, p)
        tr.commanded.append(tuple(cmd))
        tr.applied.append(tuple(applied))
        tr.taus.append(tau)
        tr.powers.append(p)
        tr.accepted.append(len(opt.state.history) > n_before)
        tr.fallback.append(guarded)
    return opt, tr
