"""Configuration search — paper Algorithm 2.

For each dimension i:
    γ_i = max(α_i, β_i)                       (line 3)
    Δ_i = ½ |x_i − y_i| · γ_i                 (line 4, Eq. 10)
    (l, h) = (y_i, x_i) if aside else (x_i, y_i)   (line 5)
    if τ_last > τ_target and p_last ≥ p_min:  v_i = l − Δ_i   (power-saving)
    else:                                      v_i = h + Δ_i   (throughput)
    z_i = MINMAX(ROUND(v_i), ranges_i)        (line 11 — snap to grid)

Power-optimization heuristic (lines 14–17): when the best config already
meets the throughput target but its power is still above the floor, pin
CPU cores to MIN and concurrency to MAX (CPU is a dominant power consumer;
concurrency compensates for the reduced host throughput).

The paper leaves ``aside`` informally specified ("aside flag"). We set it
when the *last* probe failed to improve on the best reward — flipping the
(l, h) anchors makes the next step explore from the second-best side
instead of re-extrapolating past the best. This interpretation is recorded
in DESIGN.md and exercised by tests.

Discrete-grid adaptation (documented deviation): the paper's MHz ranges are
effectively continuous (100 MHz steps), so Δ_i > 0 whenever x_i ≠ y_i. On a
coarse grid the best/second-best anchors can collapse to x_i == y_i in most
dimensions, making Δ_i = 0 and freezing the search. We therefore floor the
raw step at one grid notch *before* scaling by γ_i:

    Δ_i = max(½|x_i − y_i|, notch_i) · γ_i

so after ROUND, dimensions with strong correlation (γ_i ≳ 0.5) always move
at least one level while weakly-correlated dimensions still "change
minimally" (round back to their current value) — preserving the paper's
stated semantics on a discrete grid.

Canonical float32 arithmetic (episode-engine equivalence): the step is
evaluated by ``alg2_levels`` — one function with a numpy branch for the
scalar loop and a torch branch for the batched engine
(repro_torch.core.episode) — in float32 throughout, because the
correlation weights arrive as float32 from ``dcor_all``.
Running the scalar loop through the same op sequence at the same
precision is what makes batched episodes reproduce scalar selections
bit-for-bit: grid values are exactly representable in float32, so the
only rounding happens in the γ-scaled step itself, identically on both
paths (argmin ties snap to the lower level on both).
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np

from repro_torch.core.space import (
    CONCURRENCY_DIM,
    CORES_DIM_CANDIDATES,
    ConfigSpace,
    Config,
)


@functools.lru_cache(maxsize=None)
def dim_notches(space: ConfigSpace, step_floor: bool = True) -> np.ndarray:
    """(D,) float32 minimum grid gap per dimension (0 without the floor)."""
    if not step_floor:
        return np.zeros(len(space.dims), np.float32)
    return np.asarray(
        [
            min(
                (abs(b - a) for a, b in zip(d.values, d.values[1:])),
                default=0.0,
            )
            for d in space.dims
        ],
        np.float32,
    )


@functools.lru_cache(maxsize=None)
def padded_ladders(space: ConfigSpace) -> np.ndarray:
    """(D, Lmax) float32 per-dim value ladders, padded with +inf so the
    snap argmin never selects a padding level."""
    lmax = max(len(d.values) for d in space.dims)
    out = np.full((len(space.dims), lmax), np.inf, np.float32)
    for i, d in enumerate(space.dims):
        out[i, : len(d.values)] = np.asarray(d.values, np.float32)
    return out


def alg2_levels(
    xp,
    x,  # (D,) float32 best setting values
    y,  # (D,) float32 second-best setting values
    gamma,  # (D,) float32 correlation weights (line 3, already mode-resolved)
    notches,  # (D,) float32 step floor per dim (0 disables)
    ladders,  # (D, Lmax) float32 value ladders, +inf padded
    n_levels,  # (D,) int32 live levels per dim
    aside,  # bool scalar — flip (l, h) anchors (line 5)
    down,  # bool scalar — power-saving direction (line 6)
    probe,  # bool scalar — lines 14-17 requested by the caller's policy
    tau_best,
    p_best,
    tau_target,
    p_min,
    cores_mask,  # (D,) bool — the CPU-cores dimension (lines 14-17)
    conc_mask,  # (D,) bool — the concurrency dimension (lines 14-17)
):
    """Alg. 2 lines 3-17 on level indices, for numpy or torch (pass ``xp``).

    Returns int32 level indices of MINMAX(ROUND(v)). ``xp=numpy`` is the
    scalar loop's branch: (D,) arrays and scalar flags, exactly the
    reference's op sequence. ``xp=torch`` is the batched engine's branch:
    (B, D) tensors, (B, D, Lmax) ladders, and (B,) flags and
    scalars; it runs the identical float32 op sequence, and its
    argmin takes the first index on ties as numpy's does, so the two
    branches give bitwise-equal levels (tests/test_torch_coral.py).
    """
    if xp is np:
        delta = xp.maximum(xp.float32(0.5) * xp.abs(x - y), notches) * gamma
        lo = xp.where(aside, y, x)
        hi = xp.where(aside, x, y)
        v = xp.where(down, lo - delta, hi + delta)  # lines 7/9
        levels = xp.argmin(xp.abs(ladders - v[:, None]), axis=1).astype(xp.int32)
        probe_eff = probe & (p_best > p_min) & (tau_best > tau_target)
        levels = xp.where(probe_eff & cores_mask, 0, levels)
        levels = xp.where(probe_eff & conc_mask, n_levels - 1, levels)
        return levels
    delta = xp.maximum(0.5 * (x - y).abs(), notches) * gamma  # 0.5 is exact in float32
    lo = xp.where(aside[:, None], y, x)
    hi = xp.where(aside[:, None], x, y)
    v = xp.where(down[:, None], lo - delta, hi + delta)  # lines 7/9
    levels = xp.argmin((ladders - v[:, :, None]).abs(), dim=2).to(xp.int32)
    probe_eff = probe & (p_best > p_min) & (tau_best > tau_target)
    levels = xp.where(probe_eff[:, None] & cores_mask, 0, levels)
    levels = xp.where(probe_eff[:, None] & conc_mask, n_levels - 1, levels)
    return levels.to(xp.int32)


def next_config(
    space: ConfigSpace,
    x: Config,  # best setting
    y: Config,  # second-best setting
    alpha: Sequence[float],  # dCor(τ, s_i)
    beta: Sequence[float],  # dCor(p, s_i)
    tau_last: float,
    p_last: float,
    tau_target: float,
    p_min: float,
    aside: bool,
    tau_best: float,
    p_best: float,
    power_probe: bool = True,
    step_floor: bool = True,
    gamma_mode: str = "max",  # max (paper Alg.2 line 3) | directional
) -> Config:
    """Paper Alg. 2 proposal: move each knob from the best setting ``x``
    toward/away from the second-best ``y`` by a step scaled with the
    per-dimension dCor weights (α for τ, β for p), descending when the
    last measurement cleared the target and climbing otherwise. Thin
    host wrapper over the array-based ``alg2_levels`` the engine jits."""
    down = tau_last > tau_target and p_last >= p_min  # line 6
    alpha32 = np.asarray(alpha, np.float32)
    beta32 = np.asarray(beta, np.float32)
    if gamma_mode == "directional":
        # beyond-paper: weight the step by the correlation that matches
        # the direction's objective — β (power) when descending to save
        # power, α (throughput) when climbing toward the target
        gamma = beta32 if down else alpha32
    else:
        gamma = np.maximum(alpha32, beta32)  # line 3
    levels = alg2_levels(
        np,
        np.asarray(x, np.float32),
        np.asarray(y, np.float32),
        gamma,
        dim_notches(space, step_floor),
        padded_ladders(space),
        np.asarray([len(d.values) for d in space.dims], np.int32),
        np.bool_(aside),
        np.bool_(down),
        np.bool_(power_probe),
        np.float32(tau_best),
        np.float32(p_best),
        np.float32(tau_target),
        np.float32(p_min),
        role_mask(space, CORES_DIM_CANDIDATES),
        role_mask(space, (CONCURRENCY_DIM,)),
    )
    return tuple(d.values[int(j)] for d, j in zip(space.dims, levels))


@functools.lru_cache(maxsize=None)
def role_mask(space: ConfigSpace, names: Sequence[str]) -> np.ndarray:
    """(D,) bool mask of the dimensions whose name is in ``names``."""
    return np.asarray([d.name in names for d in space.dims])
