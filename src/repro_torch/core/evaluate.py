"""The common evaluation loop (paper Fig. 2): optimizer proposes a config,
the device applies it and runs inference, measured (τ, p) feed back.

The port of ``repro.core.evaluate`` for the static cells. ``run_coral``
(and ``run_regime`` over it) is the scalar executable specification: one
``CORAL`` against a measurable twin, one propose → measure → observe
round per iteration. The batched engine (``core/episode.py``) is held to
it config for config. ``run_cell(CellSpec)`` runs one static cell; the
reference's drift, fault, offload and cotenant loops are not ported yet
(ROADMAP queue 1 items 7–10), and their cells raise.

The simulator a loop measures is named ``twin`` here, since ``device`` is
the torch device the windowed dCor runs on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from repro_torch.core.baselines import Outcome
from repro_torch.core.coral import CORAL
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

    ``cell`` is a ``repro_torch.experiments.scenarios.Cell``; ``iters=None``
    takes the static measurement budget (10). ``engine`` is "batched" (the
    episode engine) or "scalar" (the CORAL loop, one episode at a time).
    """

    cell: object
    iters: Optional[int] = None
    seeds: Sequence[int] = (0, 1, 2)
    window: int = 10
    engine: str = "batched"


@dataclasses.dataclass(frozen=True)
class CellRecord:
    """A family-tagged, JSON-ready cell record (``family`` is "static";
    ``record`` is the matching ``BENCH_matrix`` ``cells`` entry)."""

    family: str
    record: dict


def run_cell(spec: CellSpec, device="cuda") -> CellRecord:
    """Run one cell. Static cells run the stationary CORAL-vs-baselines
    loop; a cell of a family not ported yet raises NotImplementedError
    naming its ROADMAP item. Imports are lazy — the regime tables and
    record assemblers live in ``repro_torch.experiments``, which imports
    this module."""
    from repro_torch.experiments import matrix

    iters = 10 if spec.iters is None else spec.iters
    return CellRecord(
        "static",
        matrix.run_static_cell(
            spec.cell, iters=iters, seeds=tuple(spec.seeds), window=spec.window,
            engine=spec.engine, device=device,
        ),
    )


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
