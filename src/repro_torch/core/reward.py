"""Reward calculation — paper Algorithm 1, plus the single-target mode.

Dual-constraint (the paper's Alg. 1, verbatim):
  Feasible  (τ ≥ τ_target and p ≤ p_budget):  r = τ/p      (efficiency, Eq. 7)
  Infeasible:  appended to the prohibited set, r = -(p/τ)   (penalty,   Eq. 8)

Single-target throughput (§IV-B): the objective is max τ, optionally under
a power cap. Feasible → r = τ (not τ/p — the search must prefer the
fastest config, not the most efficient one); power violation → the same
prohibited + penalty path as Alg. 1. There is no τ_target in this mode,
so no observation is prohibited for being "too slow".
"""
from __future__ import annotations

from typing import Set, Tuple

Config = Tuple[float, ...]


def reward(
    tau: float,
    p: float,
    x: Config,
    prohibited: Set[Config],
    tau_target: float,
    p_budget: float,
    mode: str = "dual",
) -> float:
    """Paper Eq. 3 reward of one measured (τ, p) at config ``x``:
    -(p/τ) efficiency when feasible, constraint-violation penalties
    otherwise, -inf for prohibited configs. ``mode="throughput"``
    switches to the single-target reward (τ under the power cap)."""
    if mode == "throughput":  # single-target §IV-B: maximize τ under p cap
        if p > p_budget:
            prohibited.add(tuple(x))
            return -(p / max(tau, 1e-9))
        return tau
    if tau < tau_target or p > p_budget:  # Alg. 1 line 3
        prohibited.add(tuple(x))  # line 4
        return -(p / max(tau, 1e-9))  # line 5
    return tau / max(p, 1e-9)  # line 7
