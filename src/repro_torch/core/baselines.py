"""Baselines from the paper's §IV-A.

  ORACLE        — exhaustive profiling of the full space (noise-free); the
                  per-scenario upper bound.
  ALERT         — offline profiling + Kalman-filtered online selection.
                  Faithful to the paper's adaptation: ALERT *prioritizes
                  throughput* (it was designed for latency/energy, not a
                  hard power cap), which is why it exceeds power budgets in
                  dual-constraint scenarios.
  ALERT-Online  — ALERT with offline profiling replaced by 10 random
                  online trials (same iteration budget as CORAL).
  max-power / default — manufacturer-preset analogues.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.space import Config, ConfigSpace


@dataclasses.dataclass
class ScalarKalman:
    """Scalar Kalman filter for ALERT's global slowdown factor ξ
    (Wan et al., ATC'20): observed = ξ · profiled + noise. Lives here —
    inlined from the former core/kalman.py — because ``alert()`` is its
    only consumer (``alert_online`` replaces it with direct trials)."""

    x: float = 1.0  # state estimate (slowdown factor)
    p: float = 1.0  # estimate covariance
    q: float = 1e-3  # process noise
    r: float = 1e-2  # measurement noise

    def update(self, measured_ratio: float) -> float:
        # predict
        self.p += self.q
        # update
        k = self.p / (self.p + self.r)
        self.x += k * (measured_ratio - self.x)
        self.p *= 1.0 - k
        return self.x


@dataclasses.dataclass
class Outcome:
    config: Optional[Config]
    tau: float
    power: float
    measurements: int  # how many device evaluations were spent

    @property
    def efficiency(self) -> float:
        return self.tau / max(self.power, 1e-9)

    def feasible(self, tau_target: float, p_budget: float) -> bool:
        return (
            self.config is not None
            and self.tau >= tau_target
            and self.power <= p_budget
        )


def _sweep(
    space: ConfigSpace, device, exact: bool
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(grid (N,D), tau (N,), p (N,)) for the full space — one vectorized
    evaluation when the device supports batched sweeps, else a Python loop
    (any object with only scalar ``exact``/``measure``)."""
    grid = space.grid()
    if exact and hasattr(device, "exact_all"):
        tau, p = device.exact_all(grid)
    elif not exact and hasattr(device, "measure_all"):
        tau, p = device.measure_all(grid)
    else:
        pairs = [
            (device.exact(tuple(row)) if exact else device.measure(tuple(row)))
            for row in grid
        ]
        tau = np.array([t for t, _ in pairs])
        p = np.array([q for _, q in pairs])
    return grid, np.asarray(tau, np.float64), np.asarray(p, np.float64)


def oracle(
    space: ConfigSpace, device, tau_target: float, p_budget: float = float("inf")
) -> Outcome:
    """Exhaustive search; best feasible config by efficiency (single-target:
    pass p_budget=inf and tau_target=0 → max throughput). Runs as one
    array-based sweep over ``space.grid()``."""
    grid, tau, p = _sweep(space, device, exact=True)
    n = grid.shape[0]
    feas = (tau >= tau_target) & (p <= p_budget)
    if not feas.any():
        return Outcome(None, 0.0, 0.0, n)
    score = tau if tau_target <= 0 else tau / np.maximum(p, 1e-9)
    best = int(np.argmax(np.where(feas, score, -np.inf)))
    return Outcome(
        tuple(float(v) for v in grid[best]), float(tau[best]), float(p[best]), n
    )


def oracle_max_throughput(space: ConfigSpace, device) -> Outcome:
    """Exhaustive-search oracle for the single-target regime: the
    highest-τ config under the device's power budget (``oracle`` with
    the τ target disabled)."""
    return oracle(space, device, tau_target=0.0)


def oracle_scalar(
    space: ConfigSpace, device, tau_target: float, p_budget: float = float("inf")
) -> Outcome:
    """The original one-config-at-a-time sweep. Kept as the equivalence
    oracle for the vectorized ``oracle`` (and its benchmark baseline)."""
    table = {}
    for cfg in space.all_configs():
        table[cfg] = device.exact(cfg)
    feas = {
        c: tp
        for c, tp in table.items()
        if tp[0] >= tau_target and tp[1] <= p_budget
    }
    n = len(table)
    if not feas:
        return Outcome(None, 0.0, 0.0, n)
    if tau_target <= 0:  # single-target: maximize throughput
        best = max(feas, key=lambda c: feas[c][0])
    else:
        best = max(feas, key=lambda c: feas[c][0] / max(feas[c][1], 1e-9))
    return Outcome(best, *feas[best], n)


def alert(
    space: ConfigSpace,
    device,
    tau_target: float,
    p_budget: float = float("inf"),
    online_iters: int = 10,
) -> Outcome:
    """Offline-profiled ALERT with Kalman-filtered online re-selection.

    Selection rule (throughput-prioritized, per the paper's description):
    among configs predicted to meet the throughput target, pick max
    predicted throughput; else pick global max predicted throughput. The
    power budget is a soft preference only — reproducing the paper's
    observation that ALERT exceeds strict power caps.
    """
    grid, tau_prof, p_prof = _sweep(space, device, exact=False)  # offline, noisy
    kf = ScalarKalman()
    chosen = None
    tau = p = 0.0
    n = grid.shape[0]
    for _ in range(online_iters):
        pred = tau_prof * kf.x
        meets = pred >= tau_target
        pool = meets if meets.any() else np.ones_like(meets)
        # throughput first; power only as a tie-breaking preference:
        # lexsort's primary key is pred descending, secondary power
        # ascending, stable — the first row is the scalar max()'s pick.
        idx = int(np.lexsort((p_prof, -np.where(pool, pred, -np.inf)))[0])
        chosen = tuple(float(v) for v in grid[idx])
        tau, p = device.measure(chosen)
        n += 1
        kf.update(tau / max(tau_prof[idx], 1e-9))
    return Outcome(chosen, tau, p, n)


def alert_online(
    space: ConfigSpace,
    device,
    tau_target: float,
    p_budget: float = float("inf"),
    iters: int = 10,
    seed: int = 0,
) -> Outcome:
    """ALERT-Online: 10 random trials, best feasible by efficiency.

    ALERT's Kalman filter tracks the global slowdown factor ξ between
    *offline-profiled* and observed performance (observed = ξ·profiled).
    With profiling replaced by one noisy online measurement per random
    config there is no profiled baseline for ξ to correct: the only
    available ratio, τ_i/τ_0, conflates config-to-config throughput
    differences with runtime drift, so smoothing it cannot improve the
    ranking. The filter is therefore deliberately absent here — selection
    is exactly the best measured feasible trial (see
    tests/test_serving_fixes.py for the regression).
    """
    rng = np.random.default_rng(seed)
    trials: List[Tuple[Config, float, float]] = []
    for _ in range(iters):
        cfg = space.random(rng)
        tau, p = device.measure(cfg)
        trials.append((cfg, tau, p))
    feas = [t for t in trials if t[1] >= tau_target and t[2] <= p_budget]
    if feas:
        best = max(feas, key=lambda t: t[1] / max(t[2], 1e-9))
        return Outcome(best[0], best[1], best[2], iters)
    if tau_target <= 0:
        best = max(trials, key=lambda t: t[1])
        return Outcome(best[0], best[1], best[2], iters)
    return Outcome(None, 0.0, 0.0, iters)  # failed to find a valid config


def preset(space: ConfigSpace, device, kind: str) -> Outcome:
    """One-measurement static baseline: apply the named preset
    (``max_power`` / ``default`` / ``min_power`` — see
    ``ConfigSpace.preset``) and record what the device does there."""
    cfg = space.preset(kind)
    tau, p = device.measure(cfg)
    return Outcome(cfg, tau, p, 1)
