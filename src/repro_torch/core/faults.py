"""Hardened-ingest knobs and the MAD outlier gate, the part of
``repro.core.faults`` that CORAL needs.

``RobustConfig`` is a plain copy. ``mad_reject_trace`` is the gate in
torch: the reference traces one jnp function for both of its engines, and
the port's CORAL calls this one on float32 tensors with the same op
sequence. The fault injection itself (``FaultSchedule``, its events and
``FaultTables``) waits for the fault episodes (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import dataclasses

import torch


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


def mad_reject_trace(win_tau, win_p, n_valid, tau, p, gate_g, gate_eps, min_accept):
    """The MAD outlier gate on one (τ, p) sample: True to reject.

    ``win_tau``/``win_p`` are the current dCor window's float32 τ/p
    columns (length W, rows ≥ ``n_valid`` ignored); ``tau``, ``p``,
    ``gate_g``, ``gate_eps`` are float32 scalars (0-d tensors), ``n_valid``
    and ``min_accept`` ints. Deviations are measured in log space (spikes
    are multiplicative) from the lower median, against a scale of
    ``1.4826·MAD + gate_eps``. Below ``min_accept`` accepted samples the
    gate stays open. NaN samples fall through (all comparisons false).
    """
    f32 = torch.float32

    def deviates(vals, x):
        mask = torch.arange(vals.shape[0], device=vals.device) < n_valid
        inf = torch.tensor(float("inf"), dtype=f32, device=vals.device)
        logs = torch.where(mask, torch.log(torch.clamp_min(vals, 1e-9)), inf)
        mid = max((int(n_valid) - 1) // 2, 0)
        med = torch.sort(logs).values[mid]
        dev = torch.where(mask, (logs - med).abs(), inf)
        mad = torch.sort(dev).values[mid]
        scale = torch.tensor(1.4826, dtype=f32, device=vals.device) * mad + gate_eps
        x_log = torch.log(torch.clamp_min(x, 1e-9))
        return bool((x_log - med).abs() > gate_g * scale)

    return int(n_valid) >= min_accept and (deviates(win_tau, tau) or deviates(win_p, p))
