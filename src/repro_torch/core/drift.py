"""Change-point detection for drift-adaptive CORAL.

CORAL as published converges once and then trusts its statistics forever;
on a non-stationary device (thermal throttling, co-tenant interference)
the held configuration silently degrades. The machinery here closes that
gap:

  ``CusumDetector``  — a two-sided CUSUM on standardized residuals: the
      classic sequential change-point statistic. With slack ``k`` and
      threshold ``h`` (both in σ units) the in-control false-alarm rate
      is astronomically small for the (k, h) defaults while a shift of a
      few σ fires within a handful of samples.
  ``DriftMonitor``   — two CUSUMs over the fractional (τ, p) residuals of
      repeated measurements of the *held* configuration vs. its reference
      value. The reference is calibrated from the first few hold samples
      (averaging down measurement noise), then frozen — an EWMA reference
      would chase the drift and mask it.
  ``DriftConfig``    — the knobs CORAL takes to become drift-aware: the
      per-epoch exploration budget, monitor calibration/sensitivity, and
      the observation-age horizon for the correlation window.

The monitor never sees exploration measurements (different configs are
expected to differ); it only consumes re-measurements of the held config,
so a trigger means "this exact configuration no longer performs as it
did" — the cleanest possible drift signal.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Drift-awareness knobs for CORAL.

    ``explore_budget`` — measurements per exploration epoch; after that
        many observations CORAL holds its best feasible config and
        monitors it (bounded re-exploration: each change-point spends the
        same budget again, it never free-runs).
    ``sigma`` — expected fractional noise of a single (τ, p) sample (the
        device's measurement σ; the workload trace noise in the matrix).
    ``k_sigma``/``h_sigma`` — CUSUM slack and decision threshold in σ
        units. Defaults give a negligible in-control false-alarm rate on
        Gaussian noise while a sustained ≥3σ shift fires within
        ~h/(shift−k) samples.
    ``calibration`` — hold samples averaged into the monitor reference
        before the CUSUMs arm. The slack must absorb the reference's
        residual error (~σ/√calibration), which is why ``k_sigma`` sits
        above 1: a miscalibrated reference adds a persistent bias to
        every standardized residual.
    ``monitor`` — set False for the *static* ablation: explore once, hold
        forever, never re-explore (the one-shot tuning PolyThrottle shows
        breaking under drift).
    ``halflife`` — observation-age horizon (in control intervals) for the
        correlation window: observations older than ~3 halflives are
        dropped from the dCor buffer even without a detected change, so a
        slow creep cannot poison the correlation statistics. None keeps
        the plain sliding window.
    ``max_retries`` — extra exploration epochs allowed when an epoch ends
        without a feasible config (holding a constraint-violating config
        and monitoring it would watch a stably-bad signal). Bounds the
        total exploration spend at (1 + retries per trigger) budgets.
    """

    explore_budget: int = 10
    sigma: float = 0.05
    k_sigma: float = 1.25
    h_sigma: float = 9.0
    calibration: int = 8
    monitor: bool = True
    halflife: Optional[float] = None
    max_retries: int = 2


class CusumDetector:
    """Two-sided CUSUM over standardized residuals z ~ N(0, 1)."""

    def __init__(self, k: float = 1.25, h: float = 9.0):
        self.k = k
        self.h = h
        self.pos = 0.0
        self.neg = 0.0

    def update(self, z: float) -> bool:
        # A non-finite residual must not touch the statistics: a NaN
        # during reference calibration poisons the monitor forever, and
        # even post-calibration `max(0.0, pos + nan - k)` silently wipes
        # the accumulated statistic (argument-order quirk of Python's
        # max). Skip the sample; the detector state is unchanged.
        if not math.isfinite(z):
            return self.tripped
        self.pos = max(0.0, self.pos + z - self.k)
        self.neg = max(0.0, self.neg - z - self.k)
        return self.tripped

    @property
    def tripped(self) -> bool:
        return self.pos > self.h or self.neg > self.h

    def reset(self) -> None:
        self.pos = 0.0
        self.neg = 0.0


class DriftMonitor:
    """CUSUMs on the fractional (τ, p) residuals of the held config.

    The first ``calibration`` samples refine the reference (mean of the
    calibration window seeded with the held config's exploration-time
    measurement); afterwards each sample feeds z = (x/ref − 1)/σ into a
    two-sided CUSUM per metric. ``update`` returns True once either
    metric's statistic crosses the threshold.
    """

    def __init__(
        self,
        ref_tau: float,
        ref_power: float,
        sigma: float = 0.05,
        k_sigma: float = 1.25,
        h_sigma: float = 9.0,
        calibration: int = 8,
    ):
        self.ref_tau = max(ref_tau, 1e-9)
        self.ref_power = max(ref_power, 1e-9)
        self.sigma = max(sigma, 1e-6)
        self.calibration = calibration
        self._calib_n = 1  # the reference itself counts as one sample
        self.tau_cusum = CusumDetector(k_sigma, h_sigma)
        self.power_cusum = CusumDetector(k_sigma, h_sigma)
        self.samples = 0

    def update(self, tau: float, power: float) -> bool:
        # Missing/garbage telemetry (NaN or inf τ/p) is skipped before it
        # can poison the calibration running mean or the CUSUMs — one NaN
        # folded into ``ref_tau`` would disable detection permanently.
        if not (math.isfinite(tau) and math.isfinite(power)):
            return self.tripped
        self.samples += 1
        if self._calib_n < self.calibration:
            # running mean: average measurement noise out of the reference
            n = self._calib_n
            self.ref_tau = (self.ref_tau * n + tau) / (n + 1)
            self.ref_power = (self.ref_power * n + power) / (n + 1)
            self._calib_n += 1
            return False
        z_tau = (tau / self.ref_tau - 1.0) / self.sigma
        z_p = (power / self.ref_power - 1.0) / self.sigma
        t1 = self.tau_cusum.update(z_tau)
        t2 = self.power_cusum.update(z_p)
        return t1 or t2

    @property
    def tripped(self) -> bool:
        return self.tau_cusum.tripped or self.power_cusum.tripped
