"""Declarative fault injection and the hardened-ingest knobs, the port of
``repro.core.faults``.

Real edge deployments are not fault-free: telemetry samples go missing or
come back as garbage, a DVFS or concurrency knob silently sticks at its
previous value, a firmware watchdog resets the governor to its default
row, and the edge→pod link drops shipped requests. ``FaultSchedule``
composes those failure modes as data, and ``realize`` turns a schedule
into per-interval numpy fault tables on a prefix-stable RNG stream, so
the scalar spec (``evaluate.run_fault_regime``) and the batched engine
(``episode.run_fault_requests``) consume byte-identical realizations.
The events, the tables and the realization are plain numpy copies of the
reference's, draw for draw.

Fault semantics (mirrored in ``device.simulator.FaultySimulator`` and
``episode._fault_step``):

- ``SensorDropout``    — the interval's (τ, p) sample is missing; the
  twin reports NaN for both channels (the noise stream still advances).
- ``TelemetrySpike``   — heavy-tailed multiplicative outliers: the
  sample is scaled by ``exp(±u·ln(magnitude))`` with u ~ U[1, 2].
- ``ActuationFailure`` — the knob silently sticks: the realization draws
  the number of failed actuation attempts for the interval; an attempt
  budget of R (hardened readback + retry) actuates iff the draw is ≤ R,
  a single blind write (the ablation) iff it is 0.
- ``FirmwareReset``    — the config snaps to the firmware default row
  (the ``max_power`` preset) regardless of what was commanded.
- ``PodLinkOutage``    — the edge→pod offload path drops shipped
  requests during the window; consumed by the serving runtime
  (``ServingRuntime.set_pod_outage``), not the device twin.

``RobustConfig`` bundles the ingest knobs both engines share, and
``mad_reject_batch`` is the one MAD outlier gate both call: the batched
fault step on (B, W) windows, the scalar spec through
``mad_reject_trace`` on one window (B = 1), so the accept/reject decision
cannot fork between them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

# realization stream tag — keeps fault draws disjoint from the twin's
# measurement-noise stream and the fleet's perturbation stream
_FAULT_STREAM = 777_013


@dataclasses.dataclass(frozen=True)
class SensorDropout:
    """Missing (τ, p) samples: each interval in [start, stop) is dropped
    with probability ``rate``."""

    start: int = 0
    stop: int = 1_000_000
    rate: float = 0.1


@dataclasses.dataclass(frozen=True)
class TelemetrySpike:
    """Heavy-tailed multiplicative outliers on the reported sample:
    intervals in [start, stop) spike with probability ``rate``; the
    factor is ``exp(s·u·ln(magnitude))`` with u ~ U[1, 2] and s = ±1
    (``direction``: "up" | "down" | "both"). ``axis`` selects the τ
    channel, the p channel, or a correlated glitch on both."""

    start: int = 0
    stop: int = 1_000_000
    rate: float = 0.1
    magnitude: float = 1000.0
    axis: str = "tau"  # tau | power | both
    direction: str = "both"  # up | down | both


@dataclasses.dataclass(frozen=True)
class ActuationFailure:
    """Silently-sticking knobs: intervals in [start, stop) fail with
    probability ``rate``; a firing interval draws the number of failed
    actuation attempts from Geometric(1/mean_tries) (support ≥ 1)."""

    start: int = 0
    stop: int = 1_000_000
    rate: float = 0.2
    mean_tries: float = 2.0


@dataclasses.dataclass(frozen=True)
class FirmwareReset:
    """The config snaps to the firmware default row (``max_power``
    preset) at exactly the listed intervals."""

    at: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class PodLinkOutage:
    """The edge→pod link is down for intervals in [start, stop): shipped
    requests error/time out and must be re-admitted locally."""

    start: int = 0
    stop: int = 0


FaultEvent = Union[
    SensorDropout, TelemetrySpike, ActuationFailure, FirmwareReset, PodLinkOutage
]


@dataclasses.dataclass(frozen=True)
class FaultTables:
    """One realized fault episode over T control intervals — plain numpy
    data shared verbatim by the scalar loop and the batched engine:
    ``drop (T,) bool``, ``spike (T, 2) float64`` multiplicative factors
    (1.0 = clean), ``stick (T,) int32`` failed actuation attempts,
    ``reset (T,) bool``, ``pod_out (T,) bool``."""

    drop: np.ndarray
    spike: np.ndarray
    stick: np.ndarray
    reset: np.ndarray
    pod_out: np.ndarray

    @staticmethod
    def clean(intervals: int) -> "FaultTables":
        """The fault-free realization (every table inert)."""
        return FaultTables(
            drop=np.zeros(intervals, bool),
            spike=np.ones((intervals, 2), np.float64),
            stick=np.zeros(intervals, np.int32),
            reset=np.zeros(intervals, bool),
            pod_out=np.zeros(intervals, bool),
        )


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A named, declarative composition of fault events — pure data, so
    fault regimes enumerate in the scenario matrix exactly like drift
    regimes do (``repro_torch.experiments.scenarios.FAULTS``)."""

    name: str
    events: Tuple[FaultEvent, ...] = ()

    def realize(self, intervals: int, seed: int) -> FaultTables:
        """Realize the schedule over ``intervals`` control intervals.

        Each event draws from its own prefix-stable stream
        ``default_rng([seed, _FAULT_STREAM, event_index])`` (the
        ``sample_perturbations`` pattern), so adding an event never
        shifts the realization of the others and the same (schedule,
        seed, T) always produces byte-identical tables.
        """
        t = np.arange(intervals)
        out = FaultTables.clean(intervals)
        drop, spike = out.drop, out.spike
        stick, reset, pod_out = out.stick, out.reset, out.pod_out
        for i, ev in enumerate(self.events):
            rng = np.random.default_rng([seed, _FAULT_STREAM, i])
            if isinstance(ev, SensorDropout):
                window = (t >= ev.start) & (t < ev.stop)
                drop |= window & (rng.random(intervals) < ev.rate)
            elif isinstance(ev, TelemetrySpike):
                window = (t >= ev.start) & (t < ev.stop)
                fire = window & (rng.random(intervals) < ev.rate)
                if ev.direction == "up":
                    sign = np.ones(intervals)
                elif ev.direction == "down":
                    sign = -np.ones(intervals)
                else:
                    sign = np.where(rng.random(intervals) < 0.5, 1.0, -1.0)
                u = 1.0 + rng.random(intervals)
                factor = np.exp(sign * u * np.log(ev.magnitude))
                factor = np.where(fire, factor, 1.0)
                if ev.axis in ("tau", "both"):
                    spike[:, 0] *= factor
                if ev.axis in ("power", "both"):
                    spike[:, 1] *= factor
            elif isinstance(ev, ActuationFailure):
                window = (t >= ev.start) & (t < ev.stop)
                fire = window & (rng.random(intervals) < ev.rate)
                tries = rng.geometric(1.0 / max(ev.mean_tries, 1.0), intervals)
                stick[:] = np.maximum(
                    stick, np.where(fire, tries, 0).astype(np.int32)
                )
            elif isinstance(ev, FirmwareReset):
                for at in ev.at:
                    if 0 <= at < intervals:
                        reset[at] = True
            elif isinstance(ev, PodLinkOutage):
                pod_out |= (t >= ev.start) & (t < ev.stop)
            else:
                raise TypeError(f"unknown fault event {ev!r}")
        return out


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Hardened-ingest knobs shared by CORAL and the serving controller.

    ``gate_g``/``gate_eps`` — the MAD outlier gate: a sample is rejected
        when its log-deviation from the window's (lower-)median exceeds
        ``gate_g · (1.4826·MAD + gate_eps)``. The eps floor (in log
        units, ≈ a 2× multiplicative band at the default) keeps a
        near-degenerate window — e.g. a watchdog fallback re-measuring
        one config — from rejecting every legitimately different sample.
    ``min_accept`` — window fill level below which the outlier gate
        stays open (missing samples are still skipped).
    ``watchdog`` — consecutive rejected/missing samples before the
        controller degrades to the safe config (last known-feasible
        anchor, ultimately the min-power row).
    ``act_retries`` — actuation verification budget: readback + retry up
        to this many times before accepting that the knob is stuck.
    ``backoff_s`` — base of the exponential backoff between actuation
        retries in the live serving controller.
    ``p_margin`` — constraint back-off: the hardened optimizer chases
        ``p_budget · (1 − p_margin)`` so that ordinary measurement noise
        near the budget boundary cannot flip a truly-over-budget config
        to feasible. Scoring always uses the full budget.
    """

    gate_g: float = 2.5
    gate_eps: float = 0.7
    min_accept: int = 5
    watchdog: int = 3
    act_retries: int = 3
    backoff_s: float = 0.05
    p_margin: float = 0.05


def mad_reject_batch(win_tau, win_p, n_valid, tau, p, gate_g, gate_eps, min_accept):
    """The MAD outlier gate on B (τ, p) samples: a (B,) bool, True to reject.

    ``win_tau``/``win_p`` are B windows' float32 τ/p columns (B, W), rows
    at index ≥ ``n_valid[b]`` ignored; ``n_valid`` is (B,) int; ``tau``,
    ``p`` are (B,) float32; ``gate_g``, ``gate_eps`` float32 0-d tensors;
    ``min_accept`` an int. Deviations are measured in log space (spikes
    are multiplicative) from the lower median, against a scale of
    ``1.4826·MAD + gate_eps``. Below ``min_accept`` accepted samples the
    gate stays open. NaN samples fall through (all comparisons false).
    Every op is elementwise or a per-row sort and gather, so a row's
    answer does not depend on B, and nothing here syncs with the host.
    """
    w = win_tau.shape[1]
    mask = torch.arange(w, device=win_tau.device)[None, :] < n_valid[:, None]
    mid = torch.clamp_min(torch.div(n_valid - 1, 2, rounding_mode="floor"), 0)
    mid = mid.to(torch.int64)[:, None]
    inf = float("inf")

    def deviates(vals, x):
        logs = torch.where(mask, torch.log(torch.clamp_min(vals, 1e-9)), inf)
        med = torch.sort(logs, dim=1).values.gather(1, mid)[:, 0]
        dev_ = torch.where(mask, (logs - med[:, None]).abs(), inf)
        mad = torch.sort(dev_, dim=1).values.gather(1, mid)[:, 0]
        scale = torch.full_like(mad, 1.4826) * mad + gate_eps
        x_log = torch.log(torch.clamp_min(x, 1e-9))
        return (x_log - med).abs() > gate_g * scale

    return (n_valid >= min_accept) & (deviates(win_tau, tau) | deviates(win_p, p))


def mad_reject_trace(win_tau, win_p, n_valid, tau, p, gate_g, gate_eps, min_accept):
    """The MAD outlier gate on one (τ, p) sample, as a bool: True to reject.

    ``win_tau``/``win_p`` are the current dCor window's float32 τ/p
    columns (length W, rows ≥ ``n_valid`` ignored); ``tau``, ``p``,
    ``gate_g``, ``gate_eps`` are float32 scalars (0-d tensors), ``n_valid``
    and ``min_accept`` ints. ``mad_reject_batch`` at B = 1: the scalar
    spec's gate is the batched engine's, op for op.
    """
    n = torch.tensor([int(n_valid)], device=win_tau.device)
    out = mad_reject_batch(win_tau[None], win_p[None], n, tau.reshape(1), p.reshape(1),
                           gate_g, gate_eps, min_accept)
    return bool(out[0])
