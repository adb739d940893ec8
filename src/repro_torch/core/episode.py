"""Batched episode engine: a batch of CORAL episodes as one torch step
over B episodes, looped over T on the device.

The port of ``repro.core.episode``'s static, drift, fault and fleet
paths. The reference lifts a ``lax.scan`` over one episode with ``vmap`` and
compiles it; here the batch axis is written out, every carry field leads
with B, and the step runs eagerly T times with no host sync (the host
reads the results once, after the last step). Four step kinds share the
pieces below: static (``run_static_requests``: propose → measure →
observe), drift (``run_drift_requests``: commanded budget, held config,
CUSUM monitor and bounded re-exploration; adaptive and static ablation
are (B,) data of one call), fault (``run_fault_requests``: watchdog
guard, faulty actuation, the MAD ingest gate; hardened and its blind
ablation are (B,) data of one call) and fleet (``run_fleet_requests``:
the static step over heterogeneous twins, with firmware-banned rows born
prohibited and warm-started episodes seeded from a converged neighbour's
window, prohibited set and anchors; cold and warm twins are (B,) data of
one call). Their parts translate one for one:

  - history: one ``(B, T+W, D+4)`` append-only observation block — config
    values, τ, p, then the clock stamp and grid-row index as exact-
    integer float32 columns. Recording an observation is one indexed
    write over ``arange(B)`` (the reference's ``.at[].set``); the window
    is a (B, W) row gather at ``lo = max(epoch_start, n_obs − W)`` (the
    reference's ``lax.dynamic_slice``; a drift episode also drops rows
    older than three halflives on the clock column), so unwritten rows are
    the scalar path's zero padding and the window goes to the same dCor as
    the scalar spec's (``core.dcov.dcor_all_cols``, one dcov kernel launch
    per step for the whole batch on the card).
  - seen tag: one ``(B, N)`` int32 over ``space.grid()`` rows — a row is
    prohibited forever at ``INT_MAX`` (Alg. 1) or visited-this-epoch at
    the current ``epoch_id``; ``tag >= epoch_id`` is the whole revisit
    test. The canonical escape (CORAL._escape_prohibited) is one argmin
    over a row gathered from the device-resident ``(S, N, N)`` int32 key
    table of ``L1-level-distance · N + row``; argmin takes the first
    index on ties, as the reference's does.
  - anchors: best / second / last as (row-index, τ, p, reward) scalars
    with validity flags, replacing ``Observation`` objects; every update
    is a leaf gate (``where(cond, new, old)``), and an observation is
    gated by ``taken`` (the fault step's ingest gate, the drift step's
    exploring-or-seed flag).
  - the device twin is folded in as data: ``(U, T, N)`` float32
    measurement tables — the float64 landscape (per interval, for drift)
    times the seed's exact numpy noise stream, with a fault episode's
    spikes and NaN baked in, built on the host and moved to the device
    once — so a measurement is one gather; episodes address their table
    by ``table_id``, and the variants of one (cell, seed) share it. A
    fleet call keeps the reference's factored form instead: (U, N)
    float32 landscapes times each episode's (T, 2) float32 noise,
    multiplied at the chosen row inside the step. Its dCor does not
    follow the reference's incremental sums (``core.dcov.dcor_state_*``):
    the window is gathered from the history block like every other step
    kind's, which gives the reference's record (see ``core/dcov.py``).

Decisions run in float32 on the device (``_reward``, Alg. 2 through
``search.alg2_levels``'s torch branch, the escape argmin, the CUSUM
monitor, the MAD gate); the records are float64, rebuilt on the host from
the landscape × noise products (``_trace_f64``, ``fault_trace_f64``,
``_f64_reward``, ``_f64_result``, ``fault_pick``), so the τ/p traces
equal the scalar loop's measurements bit for bit. The engine holds the
scalar spec's selections exactly (tests/test_torch_episode.py,
tests/test_torch_drift.py, tests/test_torch_faults.py). The fleet path
has no scalar twin, as in the reference: its row traces, prohibited
masks, windows and anchors are held to the JAX engine's, and its record
to ``BENCH_fleet.json`` (tests/test_torch_fleet.py).

Two lanes, read at call time, check a call as the reference's do:
``REPRO_CONTRACTS=1`` holds the carry (``_init_carry``) and the fleet's
host batch to ``core/contracts.py``'s tables, and ``REPRO_CHECKIFY=1``
watches the carry's float fields and each step's measured τ and p for a
NaN on the device and raises ``core.sanitize.SanitizeError`` after the
last step (``core/sanitize.py``). Neither changes what a call computes.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import contracts, sanitize, search
from repro_torch.core.baselines import Outcome
from repro_torch.core.dcov import dcor_all_cols
from repro_torch.core.faults import RobustConfig, mad_reject_batch
from repro_torch.core.space import (
    CONCURRENCY_DIM,
    CORES_DIM_CANDIDATES,
    ConfigSpace,
    index_coords,
    level_strides,
    row_index,
    space_grid,
    space_rows,
)

_INT_MAX = np.int32(np.iinfo(np.int32).max)


# ---------------------------------------------------------------------------
# Engine specification — what shapes a batch.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Structural episode parameters. ``spaces`` is the ordered tuple of
    distinct grids in the batch — their padded constants are staged on the
    device once and selected per episode by ``space_id``."""

    spaces: Tuple[ConfigSpace, ...]
    iters: int  # episode length T (intervals for drift episodes)
    window: int  # dCor sliding window W
    drift: bool = False  # epoch-structured drift episode
    # fleet episodes: static episodes with the factored measurement model
    # — (U, N) landscapes × each episode's (T, 2) noise, multiplied at the
    # chosen row inside the step instead of a dense (T, N) table — with
    # firmware-banned rows and warm-start state as episode data
    fleet: bool = False
    explore_budget: int = 10
    halflife: Optional[float] = None  # dCor age horizon (drift: window)
    calibration: int = 8
    k_sigma: float = 1.25
    h_sigma: float = 9.0
    max_retries: int = 2
    p_min: float = 0.0
    # fault episodes: static episodes whose measurement tables carry
    # spikes/NaN and whose actuation path can stick or firmware-reset;
    # the robustness constants mirror core.faults.RobustConfig (one
    # hardened-vs-ablation pair shares a call — ``hardened`` itself is
    # episode data)
    fault: bool = False
    gate_g: float = 2.5
    gate_eps: float = 0.7
    min_accept: int = 5
    watchdog: int = 3
    act_retries: int = 3

    @property
    def n(self) -> int:
        return max(s.size() for s in self.spaces)

    @property
    def d(self) -> int:
        return len(self.spaces[0].dims)

    @property
    def lmax(self) -> int:
        return max(len(d.values) for s in self.spaces for d in s.dims)


@functools.lru_cache(maxsize=None)
def _space_consts(space: ConfigSpace) -> Dict[str, np.ndarray]:
    """Per-space constant arrays, padded per batch by ``_packed_consts``."""
    return {
        "grid32": space_grid(space).astype(np.float32),
        "strides": level_strides(space),
        "ladders": search.padded_ladders(space),
        "n_levels": np.asarray([len(d.values) for d in space.dims], np.int32),
        "notches": search.dim_notches(space, True),
        "cores_mask": np.asarray(search.role_mask(space, CORES_DIM_CANDIDATES)),
        "conc_mask": np.asarray(search.role_mask(space, (CONCURRENCY_DIM,))),
        "mid_idx": np.int32(row_index(space, space.midpoint())),
        "max_idx": np.int32(row_index(space, space.preset("max_power"))),
        "min_idx": np.int32(row_index(space, space.preset("min_power"))),
    }


@functools.lru_cache(maxsize=None)
def _packed_consts(spec: EngineSpec) -> Dict[str, np.ndarray]:
    """The batch's space constants stacked over ``spaces`` and padded to
    (n rows, lmax levels). Padding grid rows are zeros and born
    prohibited (``pad_mask``); padding ladder levels are +inf so the
    snap argmin never selects them."""
    n, lmax, d = spec.n, spec.lmax, spec.d
    s = len(spec.spaces)
    out = {
        "grid32": np.zeros((s, n, d), np.float32),
        "ladders": np.full((s, d, lmax), np.inf, np.float32),
        "pad_mask": np.ones((s, n), bool),
    }
    for name in ("strides", "n_levels", "notches", "cores_mask", "conc_mask"):
        out[name] = np.stack([_space_consts(sp)[name] for sp in spec.spaces])
    for name in ("mid_idx", "max_idx", "min_idx"):
        out[name] = np.asarray(
            [_space_consts(sp)[name] for sp in spec.spaces], np.int32
        )
    for i, sp in enumerate(spec.spaces):
        k = _space_consts(sp)
        n0 = k["grid32"].shape[0]
        out["grid32"][i, :n0] = k["grid32"]
        out["ladders"][i, :, : k["ladders"].shape[1]] = k["ladders"]
        out["pad_mask"][i, :n0] = False
    return out


@functools.lru_cache(maxsize=None)
def _escape_key_table(space: ConfigSpace, n: int) -> np.ndarray:
    """(n, n) int32 canonical escape keys: row c is ``L1-level-distance
    to c · n + row index`` for every grid row — the exact ordering
    CORAL._escape_prohibited minimizes (the padded multiplier n ≥ N
    preserves the (distance, row) lexicographic order). Precomputing the
    table turns the per-step escape into one row gather + argmin."""
    coords = index_coords(space).astype(np.int32)
    n0 = coords.shape[0]
    dist = np.zeros((n0, n0), np.int32)
    for dim in range(coords.shape[1]):
        lev = coords[:, dim]
        dist += np.abs(lev[:, None] - lev[None, :])
    out = np.full((n, n), _INT_MAX, np.int32)
    out[:n0, :n0] = dist * np.int32(n) + np.arange(n0, dtype=np.int32)[None, :]
    return out


@functools.lru_cache(maxsize=None)
def _device_consts(spec: EngineSpec, device: str) -> Dict[str, torch.Tensor]:
    """The packed constants and the escape-key table on ``device``, staged
    once per (spec, device), so a call moves only its measurement tables."""
    dc = {
        name: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for name, v in _packed_consts(spec).items()
    }
    dc["key_tab"] = torch.from_numpy(
        np.stack([_escape_key_table(sp, spec.n) for sp in spec.spaces])
    ).to(device)
    return dc


# ---------------------------------------------------------------------------
# Carry construction and (flat, gated) epoch reset
# ---------------------------------------------------------------------------


def _init_carry(spec: EngineSpec, ep: Dict, pad_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Fixed-size carry of B episodes, every field leading with B:
    ``hist_sm`` (B, T+W, D+4) float32, ``seen_tag`` (B, N) int32, and
    (B,) float32 / int32 / bool anchor and bookkeeping scalars; a drift
    episode adds its commanded budget, held config, CUSUM monitor and
    retry/reset counters, a fault episode the config in force and the
    watchdog's dark counter. A fleet episode that is warm-started (its
    (B,) ``warm`` flag) starts from a converged neighbour's context:
    its window rows at history rows [0, warm_n) with ``n_obs = warm_n``,
    the inherited prohibited rows at INT_MAX, and the best / second /
    last anchors; cold episodes share the call."""
    t, w, d = spec.iters, spec.window, spec.d
    b, dev = pad_mask.shape[0], pad_mask.device
    f32, i32 = torch.float32, torch.int32

    def full(v, dtype):
        return torch.full((b,), v, dtype=dtype, device=dev)

    c = {
        # one (T+W, D+4) observation block per episode: config values, τ,
        # p, then the clock stamp and the grid-row index as exact-integer
        # float32 columns; the leading D+2 columns are the dCor window
        "hist_sm": torch.zeros((b, t + w, d + 4), dtype=f32, device=dev),
        "n_obs": full(0, i32),
        "epoch_start": full(0, i32),
        "epoch_id": full(0, i32),
        "clock": full(0, i32),
        # a row is prohibited forever at INT_MAX (padding rows are born
        # there) or visited this epoch at epoch_id: tag >= epoch_id is the
        # whole revisit test, and re-exploration resets it by bumping
        # epoch_id
        "seen_tag": torch.where(pad_mask, int(_INT_MAX), -1).to(i32),
        "best_idx": full(-1, i32),
        "best_tau": full(0.0, f32),
        "best_p": full(0.0, f32),
        "best_r": full(-float("inf"), f32),
        "best_valid": full(False, torch.bool),
        "sec_idx": full(-1, i32),
        "sec_tau": full(0.0, f32),
        "sec_p": full(0.0, f32),
        "sec_r": full(-float("inf"), f32),
        "sec_valid": full(False, torch.bool),
        "last_idx": full(-1, i32),
        "last_tau": full(0.0, f32),
        "last_p": full(0.0, f32),
        "last_valid": full(False, torch.bool),
        "aside": full(False, torch.bool),
        "probed_for": full(-1, i32),
        "probe_done": full(False, torch.bool),
    }
    if spec.fleet:
        warm = ep["warm"]
        c["hist_sm"][:, :w] = torch.where(warm[:, None, None], ep["warm_hist"], 0.0)
        c["n_obs"] = torch.where(warm, ep["warm_n"], 0).to(i32)
        c["seen_tag"] = torch.where(
            warm[:, None] & ep["warm_prohibit"], int(_INT_MAX), c["seen_tag"]
        )
        for name in ("best", "sec"):
            for fld in ("idx", "tau", "p", "r"):
                key = f"{name}_{fld}"
                c[key] = torch.where(warm, ep[f"warm_{key}"], c[key])
            c[f"{name}_valid"] = warm & ep[f"warm_{name}_valid"]
        for fld in ("idx", "tau", "p"):
            c[f"last_{fld}"] = torch.where(warm, ep[f"warm_last_{fld}"], c[f"last_{fld}"])
        c["last_valid"] = warm & ep["warm_last_valid"]
    if spec.drift:
        c.update(
            p_budget=ep["p_budget0"].clone(),
            mon_sigma=torch.clamp_min(ep["sigma"], 1e-6),
            held_idx=full(-1, i32),
            held_tau=full(0.0, f32),
            held_p=full(0.0, f32),
            held_valid=full(False, torch.bool),
            mon_ref_tau=full(1.0, f32),
            mon_ref_p=full(1.0, f32),
            mon_calib=full(0, i32),
            mon_pos_tau=full(0.0, f32),
            mon_neg_tau=full(0.0, f32),
            mon_pos_p=full(0.0, f32),
            mon_neg_p=full(0.0, f32),
            mon_active=full(False, torch.bool),
            retries=full(0, i32),
            resets=full(0, i32),
        )
    if spec.fault:
        # a rebooted device is on its firmware default row; the watchdog
        # counter starts calm
        c.update(applied_idx=ep["boot_idx"].clone(), dark=full(0, i32))
    if contracts.contracts_enabled():
        contracts.check_carry(spec, c, b)
    return c


def _re_explore(c: Dict, cond) -> Dict:
    """CORAL.re_explore gated by ``cond`` (B,): fresh epoch for anchors,
    window, probe and revisit state, prohibited memory kept. Revisit
    tracking resets by bumping ``epoch_id``."""
    c = dict(c)
    c["epoch_start"] = torch.where(cond, c["n_obs"], c["epoch_start"])
    c["epoch_id"] = c["epoch_id"] + cond.to(torch.int32)
    for name in ("best", "sec", "last"):
        c[f"{name}_valid"] = c[f"{name}_valid"] & ~cond
    c["best_r"] = torch.where(cond, -float("inf"), c["best_r"])
    c["sec_r"] = torch.where(cond, -float("inf"), c["sec_r"])
    c["aside"] = c["aside"] & ~cond
    c["probed_for"] = torch.where(cond, -1, c["probed_for"])
    c["probe_done"] = c["probe_done"] & ~cond
    if "held_valid" in c:
        c["held_valid"] = c["held_valid"] & ~cond
        c["mon_active"] = c["mon_active"] & ~cond
        c["resets"] = c["resets"] + cond.to(torch.int32)
    return c


# ---------------------------------------------------------------------------
# CORAL step pieces (mirrors of repro_torch.core.coral, batched)
# ---------------------------------------------------------------------------


def _feasible(thr, tau, p, tau_target, p_budget):
    """Feasibility under the current constraints (in throughput mode
    ``tau_target`` carries the +inf sentinel and is never consulted —
    matching CORAL._feasible)."""
    return torch.where(thr, p <= p_budget, (tau >= tau_target) & (p <= p_budget))


def _reward(thr, tau, p, tau_target, p_budget):
    """Alg. 1 in float32, spelled as ``core.reward`` spells it:
    (reward, infeasible). For the NaN missing-sample sentinel (the fault
    ablation swallows it raw) the reward is NaN and nothing is
    prohibited, as in the scalar ``reward``."""
    infeas = torch.where(thr, p > p_budget, (tau < tau_target) | (p > p_budget))
    penalty = -(p / torch.clamp_min(tau, 1e-9))
    gain = torch.where(thr, tau, tau / torch.clamp_min(p, 1e-9))
    return torch.where(infeas, penalty, gain), infeas


def _result(c: Dict, thr, tau_target, p_budget):
    """CORAL.result() for B episodes: the best feasible observation of the
    epoch (dual: by τ/p, throughput: by τ), falling back to the epoch's
    best by reward. Returns (row, τ, p, valid), each (B,)."""
    taus, powers = c["hist_sm"][:, :, -4], c["hist_sm"][:, :, -3]  # (B, T+W)
    rows = torch.arange(taus.shape[1], device=taus.device)[None, :]
    valid = (rows >= c["epoch_start"][:, None]) & (rows < c["n_obs"][:, None])
    feas = valid & _feasible(
        thr[:, None], taus, powers, tau_target[:, None], p_budget[:, None]
    )
    val = torch.where(thr[:, None], taus, taus / torch.clamp_min(powers, 1e-9))
    any_feas = feas.any(dim=1)
    pick = torch.argmax(torch.where(feas, val, -float("inf")), dim=1)
    ar = torch.arange(taus.shape[0], device=taus.device)
    idx = torch.where(any_feas, c["hist_sm"][ar, pick, -1].to(torch.int32), c["best_idx"])
    tau = torch.where(any_feas, taus[ar, pick], c["best_tau"])
    p = torch.where(any_feas, powers[ar, pick], c["best_p"])
    return idx, tau, p, any_feas | c["best_valid"]


def _window(spec: EngineSpec, k: Dict, c: Dict):
    """The (B, W, D+2) dCor window and its valid row counts (B,): the
    rows from ``lo = max(epoch_start, n_obs − W)`` (the reference's
    ``lax.dynamic_slice``), unwritten rows the scalar path's zero padding.
    With a halflife, rows older than three halflives on the float32 clock
    column drop out of the window's front first."""
    w, d = spec.window, spec.d
    ar, offs = k["ar"][:, None], k["offs"][None, :]
    lo = torch.maximum(c["epoch_start"], c["n_obs"] - w)
    if spec.halflife is not None:
        horizon = 3.0 * spec.halflife  # compared in float32, as the reference's
        t_win = c["hist_sm"][ar, lo[:, None] + offs, d + 2]  # (B, W)
        in_win = offs < (c["n_obs"] - lo)[:, None]
        fresh = (c["clock"].to(torch.float32)[:, None] - t_win) <= horizon
        lo = c["n_obs"] - (in_win & fresh).sum(dim=1).to(torch.int32)
    win = c["hist_sm"][ar, lo[:, None] + offs, : d + 2]
    return win, c["n_obs"] - lo


def _propose(spec: EngineSpec, k: Dict, c: Dict, thr, tau_target, p_budget):
    """CORAL.propose() for B episodes: returns (row indices (B,), probe
    bookkeeping updates)."""
    win, n_valid = _window(spec, k, c)
    corr = dcor_all_cols(win, torch.clamp_min(n_valid, 1), spec.d)  # (B, D, 2)
    uniform = (n_valid < 3)[:, None]
    alpha = torch.where(uniform, 1.0, corr[:, :, 0])
    beta = torch.where(uniform, 1.0, corr[:, :, 1])
    return _propose_tail(spec, k, c, thr, tau_target, p_budget, alpha, beta)


def _propose_tail(spec: EngineSpec, k: Dict, c: Dict, thr, tau_target, p_budget,
                  alpha, beta):
    """Steps 3+ of CORAL.propose — everything downstream of the window
    correlations."""
    ar = k["ar"]
    epoch_n = c["n_obs"] - c["epoch_start"]
    p_min = spec.p_min

    # ---- power-probe policy (CORAL.propose, budget_aware default) -----
    new_best = c["best_idx"] != c["probed_for"]
    probe_thr = torch.isfinite(p_budget) & new_best & (c["best_p"] > p_budget)
    budget_aware = new_best & (c["best_tau"] > tau_target) & (c["best_p"] > p_budget)
    oneshot = ~c["probe_done"] & (c["best_p"] > p_min) & (c["best_tau"] > tau_target)
    probe_dual = torch.where(torch.isfinite(p_budget), budget_aware, oneshot)
    probe = torch.where(thr, probe_thr, probe_dual)

    # ---- Step 3: Alg. 2 via the shared float32 step -------------------
    eff_target = torch.where(thr & (c["last_p"] > p_budget), -float("inf"), tau_target)
    down = (c["last_tau"] > eff_target) & (c["last_p"] >= p_min)
    grid = k["grid32"]  # (B, N, D)
    levels = search.alg2_levels(
        torch,
        grid[ar, c["best_idx"].clamp_min(0)],
        grid[ar, c["sec_idx"].clamp_min(0)],
        torch.maximum(alpha, beta),
        k["notches"],
        k["ladders"],
        k["n_levels"],
        c["aside"],
        down,
        probe,
        c["best_tau"],
        c["best_p"],
        eff_target,
        p_min,
        k["cores_mask"],
        k["conc_mask"],
    )
    cand2 = (levels * k["strides"]).sum(dim=1).to(torch.int32)

    # ---- iteration-0 / iteration-1 branches ---------------------------
    cand1_thr = torch.where(
        c["last_valid"] & (c["last_p"] > p_budget), k["min_idx"], k["max_idx"]
    )
    cand1_dual = torch.where(
        c["last_valid"] & (c["last_tau"] < tau_target), k["max_idx"], k["min_idx"]
    )
    cand1 = torch.where(thr, cand1_thr, cand1_dual)
    searching = (epoch_n >= 2) & c["sec_valid"]
    cand = torch.where(
        epoch_n == 0, k["mid_idx"], torch.where(searching, cand2, cand1)
    )

    # ---- canonical prohibited/visited escape --------------------------
    seen = c["seen_tag"] >= c["epoch_id"][:, None]  # (B, N)
    key = torch.where(seen, int(_INT_MAX), k["key_tab"][k["sid"], cand])  # (B, N) int32
    escape = torch.argmin(key, dim=1).to(torch.int32)
    cand = torch.where(seen[ar, cand], escape, cand)

    fired = searching & probe
    probe_updates = {
        "probe_done": c["probe_done"] | fired,
        "probed_for": torch.where(fired, c["best_idx"], c["probed_for"]),
    }
    return cand, probe_updates


def _observe(k: Dict, c: Dict, cand, tau, p, thr, tau_target, p_budget, taken):
    """CORAL.observe() for B episodes gated by ``taken`` (B,), in the
    scalar method's statement order (``aside`` reads the *old* best
    before the anchors shift). The (B, N) seen tags and the history
    block are written in place."""
    c = dict(c)
    ar = k["ar"]
    r, infeas = _reward(thr, tau, p, tau_target, p_budget)
    # one indexed write covers both Alg. 1's prohibit (pin at INT_MAX
    # forever) and the per-epoch revisit tag (raise to epoch_id)
    tag = c["seen_tag"][ar, cand]
    c["seen_tag"][ar, cand] = torch.where(
        infeas & taken,
        int(_INT_MAX),
        torch.where(taken, torch.maximum(tag, c["epoch_id"]), tag),
    )
    c["aside"] = torch.where(taken, c["best_valid"] & (r <= c["best_r"]), c["aside"])
    improves = taken & (~c["best_valid"] | (r > c["best_r"]))
    to_second = taken & ~improves & (~c["sec_valid"] | (r > c["sec_r"]))
    old_best = (c["best_idx"], c["best_tau"], c["best_p"], c["best_r"])
    obs = (cand, tau, p, r)
    for name, bval, oval in zip(("sec_idx", "sec_tau", "sec_p", "sec_r"), old_best, obs):
        c[name] = torch.where(improves, bval, torch.where(to_second, oval, c[name]))
    c["sec_valid"] = torch.where(improves, c["best_valid"], c["sec_valid"] | to_second)
    for name, oval in zip(("best_idx", "best_tau", "best_p", "best_r"), obs):
        c[name] = torch.where(improves, oval, c[name])
    c["best_valid"] = c["best_valid"] | taken
    for name, oval in zip(("last_idx", "last_tau", "last_p"), obs):
        c[name] = torch.where(taken, oval, c[name])
    c["last_valid"] = c["last_valid"] | taken
    n = c["n_obs"]
    obs_row = torch.cat(
        [
            k["grid32"][ar, cand],
            torch.stack([tau, p, c["clock"].to(torch.float32), cand.to(torch.float32)], 1),
        ],
        dim=1,
    )
    c["hist_sm"][ar, n] = torch.where(taken[:, None], obs_row, c["hist_sm"][ar, n])
    c["n_obs"] = n + taken.to(torch.int32)
    return c


def _monitor_update(spec: EngineSpec, c: Dict, tau, p, gate):
    """DriftMonitor.update for B episodes gated by ``gate`` (B,):
    running-mean calibration, then two-sided CUSUMs on the fractional
    (τ, p) residuals, in float32. Returns (carry, tripped)."""
    c = dict(c)
    calibrating = c["mon_calib"] < spec.calibration
    upd = gate & calibrating
    n = c["mon_calib"].to(torch.float32)
    c["mon_ref_tau"] = torch.where(upd, (c["mon_ref_tau"] * n + tau) / (n + 1), c["mon_ref_tau"])
    c["mon_ref_p"] = torch.where(upd, (c["mon_ref_p"] * n + p) / (n + 1), c["mon_ref_p"])
    c["mon_calib"] = c["mon_calib"] + upd.to(torch.int32)
    armed = gate & ~calibrating
    z_tau = (tau / c["mon_ref_tau"] - 1.0) / c["mon_sigma"]
    z_p = (p / c["mon_ref_p"] - 1.0) / c["mon_sigma"]
    for name, z in (("tau", z_tau), ("p", z_p)):
        pos = torch.clamp_min(c[f"mon_pos_{name}"] + z - spec.k_sigma, 0.0)
        neg = torch.clamp_min(c[f"mon_neg_{name}"] - z - spec.k_sigma, 0.0)
        c[f"mon_pos_{name}"] = torch.where(armed, pos, c[f"mon_pos_{name}"])
        c[f"mon_neg_{name}"] = torch.where(armed, neg, c[f"mon_neg_{name}"])
    h = spec.h_sigma
    tripped = (
        (c["mon_pos_tau"] > h) | (c["mon_neg_tau"] > h)
        | (c["mon_pos_p"] > h) | (c["mon_neg_p"] > h)
    )
    return c, armed & tripped


# ---------------------------------------------------------------------------
# Step functions: each returns step(carry, t) -> (carry, per-step outputs)
# ---------------------------------------------------------------------------


def _static_step(spec: EngineSpec, k: Dict, ep: Dict, tables: Dict):
    """run_coral's loop body for B episodes: propose → measure → observe.
    Measuring is a point gather into each episode's (T, N) table."""
    thr, tau_target, p_budget = ep["throughput"], ep["tau_target"], ep["p_budget"]
    tid = ep["table_id"]
    always = torch.ones_like(thr)

    def step(c, t: int):
        cand, probe_updates = _propose(spec, k, c, thr, tau_target, p_budget)
        c = {**c, **probe_updates}
        tau, p = tables["tau"][tid, t, cand], tables["p"][tid, t, cand]
        c = _observe(k, c, cand, tau, p, thr, tau_target, p_budget, always)
        c["clock"] = c["clock"] + 1
        return c, {"idx": cand, "tau": tau, "p": p}

    return step


def _fleet_step(spec: EngineSpec, k: Dict, ep: Dict, tables: Dict):
    """The static step with the factored measurement model: each
    episode's float32 (N,) landscape rows (addressed by ``table_id``)
    times its own (T, 2) float32 noise stream, multiplied at the chosen
    row — the product a dense (T, N) table would hold."""
    thr, tau_target, p_budget = ep["throughput"], ep["tau_target"], ep["p_budget"]
    tid = ep["table_id"]
    always = torch.ones_like(thr)

    def step(c, t: int):
        cand, probe_updates = _propose(spec, k, c, thr, tau_target, p_budget)
        c = {**c, **probe_updates}
        z = ep["noise"][:, t]  # (B, 2) float32: no operand below promotes
        tau = torch.clamp_min(tables["tau"][tid, cand] * (1.0 + z[:, 0]), 1e-9)
        p = torch.clamp_min(tables["p"][tid, cand] * (1.0 + z[:, 1]), 1e-9)
        c = _observe(k, c, cand, tau, p, thr, tau_target, p_budget, always)
        c["clock"] = c["clock"] + 1
        return c, {"idx": cand, "tau": tau, "p": p}

    return step


def _fault_step(spec: EngineSpec, k: Dict, ep: Dict, tables: Dict):
    """run_fault_regime's loop body for B episodes: watchdog-guarded
    next_config → faulty actuation → measure the config actually in force
    → hardened ingest gate → observe. ``ep["hardened"]`` is (B,) data, so
    hardened runs and their ablations share one call; the fault
    realization lives in the measurement tables (spikes and NaN baked
    in) and the per-interval ``stick``/``reset`` actuation streams."""
    thr, tau_target, p_budget = ep["throughput"], ep["tau_target"], ep["p_budget"]
    tid = ep["table_id"]
    hardened = ep["hardened"]
    retry_budget = hardened.to(torch.int32) * spec.act_retries
    dev, d = thr.device, spec.d
    gate_g = torch.tensor(spec.gate_g, dtype=torch.float32, device=dev)
    gate_eps = torch.tensor(spec.gate_eps, dtype=torch.float32, device=dev)

    def step(c, t: int):
        # ---- next_config: watchdog guard over the normal proposal -----
        cand, probe_updates = _propose(spec, k, c, thr, tau_target, p_budget)
        guard = hardened & (c["dark"] >= spec.watchdog)
        feas_best = c["best_valid"] & _feasible(
            thr, c["best_tau"], c["best_p"], tau_target, p_budget
        )
        safe = torch.where(feas_best, c["best_idx"], k["min_idx"])
        cmd = torch.where(guard, safe, cand)
        c = dict(c)
        # probe bookkeeping belongs to the taken propose branch only (the
        # scalar watchdog path returns before propose runs)
        c["probe_done"] = torch.where(guard, c["probe_done"], probe_updates["probe_done"])
        c["probed_for"] = torch.where(guard, c["probed_for"], probe_updates["probed_for"])

        # ---- actuation: silently-sticking knobs + firmware resets -----
        ok = ep["stick"][:, t] <= retry_budget
        applied = torch.where(ok, cmd, c["applied_idx"])
        applied = torch.where(ep["reset"][:, t], k["max_idx"], applied)
        c["applied_idx"] = applied

        # ---- measure the config actually in force ---------------------
        tau, p = tables["tau"][tid, t, applied], tables["p"][tid, t, applied]
        # hardened attributes via readback; the ablation trusts the
        # command — exactly the misattribution the fault cells score
        attr = torch.where(hardened, applied, cmd)

        # ---- hardened ingest gate (CORAL._robust_reject's math) -------
        win, n_valid = _window(spec, k, c)
        missing = ~(torch.isfinite(tau) & torch.isfinite(p))
        outlier = mad_reject_batch(
            win[:, :, d], win[:, :, d + 1], n_valid, tau, p, gate_g, gate_eps,
            spec.min_accept,
        )
        taken = ~hardened | ~(missing | outlier)
        c = _observe(k, c, attr, tau, p, thr, tau_target, p_budget, taken)
        c["dark"] = torch.where(hardened & ~taken, c["dark"] + 1, 0)
        c["clock"] = c["clock"] + 1
        return c, {"idx": cmd, "applied": applied, "taken": taken, "guard": guard,
                   "tau": tau, "p": p}

    return step


def _drift_step(spec: EngineSpec, k: Dict, ep: Dict, tables: Dict):
    """run_drift_regime's loop body for B episodes: commanded budget →
    next_config → measure → record, with bounded re-exploration on CUSUM
    triggers. ``ep["adaptive"]`` is (B,) data: the static ablation
    (monitor off, budget commands ignored) shares the call."""
    thr, tau_target = ep["throughput"], ep["tau_target"]
    adaptive = ep["adaptive"]
    tid = ep["table_id"]

    def step(c, t: int):
        budget_t = ep["budgets"][:, t]
        clock0 = c["clock"]

        # ---- commanded budget change (CORAL.set_p_budget) + retry -----
        # Both pre-measure resets are mutually exclusive (a budget trigger
        # flips the loop back into exploration, which disarms the retry
        # check), so one gated re_explore serves both.
        changed = adaptive & (budget_t != c["p_budget"])
        exploring0 = (c["n_obs"] - c["epoch_start"]) < spec.explore_budget
        draw = torch.where(c["mon_active"], c["mon_ref_p"], c["held_p"])
        trigger_b = changed & ~exploring0 & c["held_valid"] & (draw > budget_t)
        c = dict(c)
        c["p_budget"] = torch.where(adaptive, budget_t, c["p_budget"])
        p_budget = c["p_budget"]

        # infeasible-hold retry: an epoch that ends without a pick
        # feasible under the *current* constraints spends another
        # (bounded) exploration epoch instead of monitoring it
        r_idx, r_tau, r_p, r_valid = _result(c, thr, tau_target, p_budget)
        h_tau = torch.where(r_valid, r_tau, c["last_tau"])
        h_p = torch.where(r_valid, r_p, c["last_p"])
        h_exists = r_valid | c["last_valid"]
        infeasible = ~h_exists | ~_feasible(thr, h_tau, h_p, tau_target, p_budget)
        retry = (
            adaptive & ~trigger_b & ~exploring0 & ~c["held_valid"] & infeasible
            & (c["retries"] < spec.max_retries)
        )
        c = _re_explore(c, trigger_b | retry)
        c["retries"] = torch.where(trigger_b, 0, c["retries"] + retry.to(torch.int32))
        exploring = (c["n_obs"] - c["epoch_start"]) < spec.explore_budget

        cand_explore, probe_updates = _propose(spec, k, c, thr, tau_target, p_budget)

        # hold_config: the first non-exploring interval resolves the held
        # config (epoch best feasible, else last) and arms the monitor.
        # The retry path above flipped ``exploring`` back on, so the stale
        # pre-reset result can never arm a hold.
        h_idx = torch.where(r_valid, r_idx, c["last_idx"])
        arm = ~exploring & ~c["held_valid"]
        c["held_idx"] = torch.where(arm, h_idx, c["held_idx"])
        c["held_tau"] = torch.where(arm, h_tau, c["held_tau"])
        c["held_p"] = torch.where(arm, h_p, c["held_p"])
        c["held_valid"] = c["held_valid"] | arm
        arm_mon = arm & adaptive
        c["mon_ref_tau"] = torch.where(arm_mon, torch.clamp_min(h_tau, 1e-9), c["mon_ref_tau"])
        c["mon_ref_p"] = torch.where(arm_mon, torch.clamp_min(h_p, 1e-9), c["mon_ref_p"])
        c["mon_calib"] = torch.where(arm_mon, 1, c["mon_calib"])
        for name in ("pos_tau", "neg_tau", "pos_p", "neg_p"):
            c[f"mon_{name}"] = torch.where(arm_mon, 0.0, c[f"mon_{name}"])
        c["mon_active"] = c["mon_active"] | arm_mon

        # probe bookkeeping belongs to the *taken* propose branch only
        c["probe_done"] = torch.where(exploring, probe_updates["probe_done"], c["probe_done"])
        c["probed_for"] = torch.where(exploring, probe_updates["probed_for"], c["probed_for"])
        cand = torch.where(exploring, cand_explore, c["held_idx"])

        # ---- measure --------------------------------------------------
        tau, p = tables["tau"][tid, t, cand], tables["p"][tid, t, cand]

        # ---- record (CORAL.record) ------------------------------------
        # calm hold: the monitor consumes the re-measurement
        hold = ~exploring
        c, tripped = _monitor_update(spec, c, tau, p, hold & c["mon_active"])
        trig = hold & c["mon_active"] & tripped
        c = _re_explore(c, trig)
        c["retries"] = torch.where(trig, 0, c["retries"])
        # a trigger seeds the fresh epoch with the held config's just-
        # taken measurement only if it is infeasible; both the seed and
        # the exploration observation stamp the interval's clock
        seed_obs = trig & ~_feasible(thr, tau, p, tau_target, p_budget)
        c = _observe(k, c, cand, tau, p, thr, tau_target, p_budget, exploring | seed_obs)
        c["clock"] = clock0 + 1
        return c, {"idx": cand, "exploring": exploring, "tau": tau, "p": p}

    return step


# ---------------------------------------------------------------------------
# The batched runner: T steps over B episodes, eagerly, no host sync
# ---------------------------------------------------------------------------

_FINAL_KEYS = ("n_obs", "epoch_start", "best_idx", "best_valid")
# a fleet episode's anchors, read back as the seed of a warm-started wave
_ANCHOR_KEYS = tuple(
    f"{name}_{fld}" for name in ("best", "sec", "last")
    for fld in ("idx", "tau", "p", "r", "valid") if (name, fld) != ("last", "r")
)


def _run(spec: EngineSpec, ep: Dict, tables: Dict, device) -> Dict[str, np.ndarray]:
    """The batched engine: T steps of the spec's step kind (static, drift,
    fault or fleet) over B episodes on ``device``. Every step's decisions
    stay on the device; the host reads the stacked (B, T) per-step
    integer and bool outputs, the final counters and the history's row
    and clock columns once, after the last step (a fleet call: the final
    prohibited masks, the last W window rows and the anchors instead of
    the history). A step's float outputs, its measured τ and p, feed the
    NaN lane only (the records rebuild them in float64 on the host): under
    ``REPRO_CHECKIFY=1`` they and the carry's float fields are watched
    every step, and the call raises after its last step if one held a
    NaN."""
    consts = _device_consts(spec, str(device))
    sid = ep["space_id"]
    k = {name: v[sid] for name, v in consts.items() if name != "key_tab"}
    k["key_tab"] = consts["key_tab"]
    k["sid"] = sid
    k["ar"] = torch.arange(sid.shape[0], device=sid.device)
    k["offs"] = torch.arange(spec.window, device=sid.device)
    pad = k["pad_mask"]
    if spec.fleet:
        # firmware-locked DVFS rows are born prohibited, like grid padding;
        # the iteration-0/1 presets may be warm-start overrides (a
        # neighbour's observed extremes)
        pad = pad | ep["banned"]
        k["min_idx"], k["max_idx"] = ep["min_idx"], ep["max_idx"]
    c = _init_carry(spec, ep, pad)
    make = (
        _drift_step if spec.drift else _fault_step if spec.fault
        else _fleet_step if spec.fleet else _static_step
    )
    step = make(spec, k, ep, tables)
    watch = sanitize.NanWatch() if sanitize.checkify_enabled() else None
    outs: Dict[str, list] = {}
    for t in range(spec.iters):
        c, out = step(c, t)
        if watch is not None:
            watch.observe(t, {**c, **out})
        for name, v in out.items():
            if not v.is_floating_point():
                outs.setdefault(name, []).append(v)
    if watch is not None:
        watch.check()
    res = {name: torch.stack(v, dim=1) for name, v in outs.items()}
    res.update({name: c[name] for name in _FINAL_KEYS})
    if spec.drift:
        res["resets"] = c["resets"]
    if spec.fleet:
        start = torch.clamp_min(c["n_obs"] - spec.window, 0)
        res["prohibited"] = c["seen_tag"] == int(_INT_MAX)
        res["window"] = c["hist_sm"][k["ar"][:, None], start[:, None] + k["offs"][None, :]]
        res.update({name: c[name] for name in _ANCHOR_KEYS})
    else:
        res["hist_idx"] = c["hist_sm"][:, : spec.iters, -1].to(torch.int32)
        res["hist_t"] = c["hist_sm"][:, : spec.iters, -2].to(torch.int32)
    return {name: v.cpu().numpy() for name, v in res.items()}


# ---------------------------------------------------------------------------
# Measurement tables and float64 records (host side)
# ---------------------------------------------------------------------------


def measurement_noise(seed: int, sigma: float, steps: int) -> np.ndarray:
    """(T, 2) noise block from the device RNG stream — bitwise the same
    draws as T sequential scalar ``measure`` calls (τ draw, then p)."""
    if sigma == 0.0:
        return np.zeros((steps, 2))
    return np.random.default_rng(seed).normal(0.0, sigma, size=(steps, 2))


def _fill_tables(
    meas_tau: np.ndarray,  # (U, T, N) float32 batch slot to fill at row b
    meas_p: np.ndarray,
    b: int,
    land_tau: np.ndarray,  # (T, N0) or (N0,) float64 landscape
    land_p: np.ndarray,
    z: np.ndarray,  # (T, 2) float64 noise
) -> None:
    """Write table b's float32 measurement tables: the float64
    landscape × noise product, rounded once on assignment — the same
    float64 values the scalar ``measure`` produces, cast to the engine's
    working precision. A drift landscape has one row per interval."""
    n0 = land_tau.shape[-1]
    lt = land_tau if land_tau.ndim == 2 else land_tau[None, :]
    lp = land_p if land_p.ndim == 2 else land_p[None, :]
    meas_tau[b, :, :n0] = np.maximum(lt * (1.0 + z[:, :1]), 1e-9)
    meas_p[b, :, :n0] = np.maximum(lp * (1.0 + z[:, 1:]), 1e-9)


def _fill_all(meas_tau, meas_p, reqs, steps) -> List[np.ndarray]:
    """Noise draws + table fills for every request; the per-episode
    float64 landscape×noise products run on a small thread pool (numpy
    releases the GIL for the array work). Returns the noise blocks in
    request order."""
    noises = [measurement_noise(r["seed"], r["noise"], steps) for r in reqs]

    def fill(i):
        _fill_tables(meas_tau, meas_p, i, reqs[i]["land_tau"], reqs[i]["land_p"], noises[i])

    workers = min(len(reqs), os.cpu_count() or 1)
    if workers > 1:
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            list(pool.map(fill, range(len(reqs))))
    else:
        for i in range(len(reqs)):
            fill(i)
    return noises


def _trace_f64(
    land_tau: np.ndarray, land_p: np.ndarray, z: np.ndarray, idxs: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Float64 measurement trace at the chosen configs — bitwise equal
    to the scalar loop's ``measure`` returns (same product, same
    clamp)."""
    steps = np.arange(idxs.shape[0])
    lt = land_tau[steps, idxs] if land_tau.ndim == 2 else land_tau[idxs]
    lp = land_p[steps, idxs] if land_p.ndim == 2 else land_p[idxs]
    taus = np.maximum(lt * (1.0 + z[:, 0]), 1e-9)
    powers = np.maximum(lp * (1.0 + z[:, 1]), 1e-9)
    return taus, powers


def _engine_tau_target(mode: str, targets) -> np.float32:
    """Throughput mode has no τ target: CORAL.__init__ replaces it with
    the +inf sentinel so Alg. 2 stays in its climb direction — the
    engine mirrors that here."""
    if mode == "throughput":
        return np.float32(np.inf)
    return np.float32(targets.tau_target)


@dataclasses.dataclass
class EpisodeResult:
    """One episode's outcome + per-step float64 trace, reconstructed
    host-side so τ/p match the scalar loop's measurements bitwise."""

    configs: List[tuple]
    taus: List[float]
    powers: List[float]
    rewards: List[float]
    outcome: Outcome
    exploring: Optional[List[bool]] = None
    budgets: Optional[List[float]] = None
    resets: int = 0
    result_config: Optional[tuple] = None

    def trace(self):
        """The episode as an ``evaluate.Trace`` (scalar-loop shape)."""
        from repro_torch.core.evaluate import Trace

        return Trace(
            list(self.configs), list(self.taus), list(self.powers),
            list(self.rewards),
        )


def _f64_reward(mode, tau, p, tau_target, p_budget):
    infeas = (
        (p > p_budget)
        if mode == "throughput"
        else (tau < tau_target) | (p > p_budget)
    )
    gain = tau if mode == "throughput" else tau / np.maximum(p, 1e-9)
    return np.where(infeas, -(p / np.maximum(tau, 1e-9)), gain)


def _f64_result(
    mode,
    idxs: np.ndarray,
    taus: np.ndarray,
    powers: np.ndarray,
    rewards: np.ndarray,
    tau_target: float,
    p_budget: float,
) -> Optional[int]:
    """CORAL.result() over a float64 history: position of the best
    feasible observation, else best by reward; None for empty input."""
    if idxs.size == 0:
        return None
    if mode == "throughput":
        feas = powers <= p_budget
        val = taus
    else:
        feas = (taus >= tau_target) & (powers <= p_budget)
        val = taus / np.maximum(powers, 1e-9)
    if feas.any():
        return int(np.argmax(np.where(feas, val, -np.inf)))
    return int(np.argmax(rewards))


def _batch_spaces(reqs: List[dict]) -> Tuple[ConfigSpace, ...]:
    """Ordered distinct spaces across a request batch (the EngineSpec
    key). Mixed dimensionalities cannot share one batch."""
    spaces: List[ConfigSpace] = []
    for r in reqs:
        if r["space"] not in spaces:
            spaces.append(r["space"])
    d = len(spaces[0].dims)
    for s in spaces:
        if len(s.dims) != d:
            raise ValueError("episode batch mixes grid dimensionalities")
    return tuple(spaces)


def run_coral_batch(
    space: ConfigSpace,
    land_tau: np.ndarray,  # (N,) float64 noise-free τ landscape
    land_p: np.ndarray,  # (N,) float64 noise-free p landscape
    targets,  # RegimeTargets (mode, tau_target, p_budget)
    seeds: Sequence[int],
    iters: int = 10,
    window: int = 10,
    noise: float = 0.02,
    device="cuda",
) -> List[EpisodeResult]:
    """Batched twin of N× ``run_coral``: one engine call over seeds."""
    reqs = [
        {
            "space": space,
            "land_tau": land_tau,
            "land_p": land_p,
            "targets": targets,
            "seed": s,
            "noise": noise,
        }
        for s in seeds
    ]
    return run_static_requests(reqs, iters=iters, window=window, device=device)


def run_static_requests(
    reqs: List[dict], iters: int = 10, window: int = 10, device="cuda"
) -> List[EpisodeResult]:
    """Run a batch of static CORAL episodes through the batched engine.

    Each request: {space, land_tau, land_p, targets, seed, noise}. The
    whole batch — every (cell × seed), any mix of spaces and modes — is
    ONE engine call of ``iters`` steps on ``device``; results return in
    input order.
    """
    if not reqs:
        return []
    spaces = _batch_spaces(reqs)
    spec = EngineSpec(spaces=spaces, iters=iters, window=window)
    b, n = len(reqs), spec.n
    meas_tau = np.zeros((b, iters, n), np.float32)
    meas_p = np.zeros((b, iters, n), np.float32)
    noises = _fill_all(meas_tau, meas_p, reqs, iters)
    ep = {
        "space_id": np.empty(b, np.int64),
        "table_id": np.arange(b, dtype=np.int64),
        "tau_target": np.empty(b, np.float32),
        "p_budget": np.empty(b, np.float32),
        "throughput": np.empty(b, bool),
    }
    for i, r in enumerate(reqs):
        ep["space_id"][i] = spaces.index(r["space"])
        ep["tau_target"][i] = _engine_tau_target(r["targets"].mode, r["targets"])
        ep["p_budget"][i] = np.float32(r["targets"].p_budget)
        ep["throughput"][i] = r["targets"].mode == "throughput"
    res = _run(spec, *_to_device(ep, meas_tau, meas_p, device), device)
    out: List[EpisodeResult] = []
    for i, r in enumerate(reqs):
        idxs = res["idx"][i]
        taus, powers = _trace_f64(r["land_tau"], r["land_p"], noises[i], idxs)
        mode = r["targets"].mode
        rewards = _f64_reward(
            mode, taus, powers, r["targets"].tau_target, r["targets"].p_budget
        )
        rows = space_rows(r["space"])
        configs = [rows[int(j)] for j in idxs]
        pick = _f64_result(
            mode, idxs, taus, powers, rewards,
            r["targets"].tau_target, r["targets"].p_budget,
        )
        outcome = Outcome(
            configs[pick], float(taus[pick]), float(powers[pick]), iters
        )
        out.append(
            EpisodeResult(
                configs=configs,
                taus=[float(v) for v in taus],
                powers=[float(v) for v in powers],
                rewards=[float(v) for v in rewards],
                outcome=outcome,
                result_config=configs[pick],
            )
        )
    return out


def _to_device(ep: Dict[str, np.ndarray], meas_tau, meas_p, device):
    """The per-episode data and the measurement tables on ``device``."""
    batch = {name: torch.from_numpy(v).to(device) for name, v in ep.items()}
    tables = {"tau": torch.from_numpy(meas_tau).to(device),
              "p": torch.from_numpy(meas_p).to(device)}
    return batch, tables


def _dedup_tables(keys: List[tuple]) -> Tuple[np.ndarray, List[int]]:
    """``table_id`` per request and the first request of each distinct
    key: requests whose landscape, seed, noise (and fault realization)
    agree read one shared measurement table."""
    uniq: Dict[tuple, int] = {}
    table_ids = np.empty(len(keys), np.int64)
    firsts: List[int] = []
    for i, key in enumerate(keys):
        if key not in uniq:
            uniq[key] = len(firsts)
            firsts.append(i)
        table_ids[i] = uniq[key]
    return table_ids, firsts


def run_drift_requests(
    reqs: List[dict],
    intervals: int,
    explore_budget: int = 10,
    window: int = 10,
    device="cuda",
) -> List[EpisodeResult]:
    """Run a batch of drift episodes through the batched engine.

    Each request: {space, land_tau (T, N), land_p (T, N), budget_scale
    (T,), targets, seed, noise, adaptive}. The drift variant (adaptive
    vs static ablation) is (B,) data, so the whole batch is ONE engine
    call of ``intervals`` steps on ``device``; the two variants of a
    (cell, seed) share one measurement table.
    """
    if not reqs:
        return []
    spaces = _batch_spaces(reqs)
    spec = EngineSpec(
        spaces=spaces,
        iters=intervals,
        window=window,
        drift=True,
        explore_budget=explore_budget,
        halflife=float(window),
    )
    b, n = len(reqs), spec.n
    table_ids, firsts = _dedup_tables(
        [(id(r["land_tau"]), id(r["land_p"]), r["seed"], r["noise"]) for r in reqs]
    )
    meas_tau = np.zeros((len(firsts), intervals, n), np.float32)
    meas_p = np.zeros((len(firsts), intervals, n), np.float32)
    uniq_noises = _fill_all(meas_tau, meas_p, [reqs[i] for i in firsts], intervals)
    noises = [uniq_noises[table_ids[i]] for i in range(b)]
    budgets64 = []
    ep = {
        "space_id": np.empty(b, np.int64),
        "table_id": table_ids,
        "tau_target": np.empty(b, np.float32),
        "p_budget0": np.empty(b, np.float32),
        "sigma": np.empty(b, np.float32),
        "throughput": np.empty(b, bool),
        "adaptive": np.empty(b, bool),
        "budgets": np.empty((b, intervals), np.float32),
    }
    for i, r in enumerate(reqs):
        # repro-lint: disable=RL04 — host f64 mirrors the scalar loop's budget trace
        b64 = r["targets"].p_budget * np.asarray(r["budget_scale"], np.float64)
        budgets64.append(b64)
        ep["space_id"][i] = spaces.index(r["space"])
        ep["tau_target"][i] = _engine_tau_target(r["targets"].mode, r["targets"])
        ep["p_budget0"][i] = np.float32(r["targets"].p_budget)
        ep["sigma"][i] = np.float32(r.get("sigma", r["noise"]))
        ep["throughput"][i] = r["targets"].mode == "throughput"
        ep["adaptive"][i] = bool(r["adaptive"])
        ep["budgets"][i] = b64
    res = _run(spec, *_to_device(ep, meas_tau, meas_p, device), device)
    out: List[EpisodeResult] = []
    for i, r in enumerate(reqs):
        idxs = res["idx"][i]
        taus, powers = _trace_f64(r["land_tau"], r["land_p"], noises[i], idxs)
        mode = r["targets"].mode
        rows = space_rows(r["space"])
        configs = [rows[int(j)] for j in idxs]
        # final result: the epoch's history rows re-read in float64. A
        # history row is an (interval, config) pair, so its measurement is
        # the trace value at its interval.
        n_obs = int(res["n_obs"][i])
        e0 = int(res["epoch_start"][i])
        h_t = res["hist_t"][i][e0:n_obs]
        h_idx = res["hist_idx"][i][e0:n_obs]
        final_budget = (
            float(budgets64[i][-1]) if r["adaptive"] else float(r["targets"].p_budget)
        )
        ep_taus = taus[h_t]
        ep_powers = powers[h_t]
        ep_budgets = (
            budgets64[i][h_t]
            if r["adaptive"]
            else np.full(h_t.shape, r["targets"].p_budget)
        )
        ep_rewards = _f64_reward(
            mode, ep_taus, ep_powers, r["targets"].tau_target, ep_budgets
        )
        pick = _f64_result(
            mode, h_idx, ep_taus, ep_powers, ep_rewards,
            r["targets"].tau_target, final_budget,
        )
        if pick is not None:
            result_config = rows[int(h_idx[pick])]
            outcome = Outcome(
                result_config, float(ep_taus[pick]), float(ep_powers[pick]), intervals
            )
        elif bool(res["best_valid"][i]):
            result_config = rows[int(res["best_idx"][i])]
            outcome = Outcome(result_config, 0.0, 0.0, intervals)
        else:
            result_config, outcome = None, Outcome(None, 0.0, 0.0, intervals)
        out.append(
            EpisodeResult(
                configs=configs,
                taus=[float(v) for v in taus],
                powers=[float(v) for v in powers],
                rewards=[],
                outcome=outcome,
                exploring=[bool(v) for v in res["exploring"][i]],
                budgets=[float(v) for v in budgets64[i]],
                resets=int(res["resets"][i]),
                result_config=result_config,
            )
        )
    return out


def _fill_fault_tables(
    meas_tau: np.ndarray,  # (U, T, N) float32 batch slot to fill at row u
    meas_p: np.ndarray,
    u: int,
    land_tau: np.ndarray,  # (N0,) float64 stationary landscape
    land_p: np.ndarray,
    z: np.ndarray,  # (T, 2) float64 noise
    ftab,  # realized core.faults.FaultTables
) -> None:
    """Write one fault episode's float32 measurement tables: the clean
    float64 landscape × noise product (same clamp as ``_fill_tables``),
    then the telemetry-spike factors in float64 — matching
    ``FaultySimulator.measure``'s op order exactly — then NaN on dropped
    intervals, cast to float32 once on assignment."""
    n0 = land_tau.shape[0]
    tau64 = np.maximum(land_tau[None, :] * (1.0 + z[:, :1]), 1e-9) * ftab.spike[:, 0:1]
    p64 = np.maximum(land_p[None, :] * (1.0 + z[:, 1:]), 1e-9) * ftab.spike[:, 1:2]
    meas_tau[u, :, :n0] = np.where(ftab.drop[:, None], np.nan, tau64)
    meas_p[u, :, :n0] = np.where(ftab.drop[:, None], np.nan, p64)


def fault_trace_f64(
    land_tau: np.ndarray,
    land_p: np.ndarray,
    z: np.ndarray,
    idxs: np.ndarray,  # (T,) applied grid rows
    ftab,
) -> Tuple[np.ndarray, np.ndarray]:
    """Float64 telemetry trace at the *applied* configs with the fault
    realization folded in — bitwise what ``FaultySimulator.measure``
    returned each interval (NaN on dropped samples)."""
    taus, powers = _trace_f64(land_tau, land_p, z, idxs)
    taus = np.where(ftab.drop, np.nan, taus * ftab.spike[:, 0])
    powers = np.where(ftab.drop, np.nan, powers * ftab.spike[:, 1])
    return taus, powers


def fault_pick(mode, h_idx, taus, powers, tau_target, p_budget) -> Optional[int]:
    """CORAL.result() over a fault episode's *recorded* history rows.

    NaN rewards (missing samples the ablation swallowed raw) rank below
    everything in the best-by-reward fallback — deterministic for both
    engines, since the matrix computes scalar and batched results
    through this one helper."""
    rewards = _f64_reward(mode, taus, powers, tau_target, p_budget)
    rewards = np.where(np.isnan(rewards), -np.inf, rewards)
    return _f64_result(mode, h_idx, taus, powers, rewards, tau_target, p_budget)


def run_fault_requests(
    reqs: List[dict],
    iters: int = 40,
    window: int = 10,
    robust: Optional[RobustConfig] = None,
    device="cuda",
) -> List[dict]:
    """Run a batch of fault episodes through the batched engine.

    Each request: {space, land_tau (N,), land_p (N,), targets, seed,
    noise, hardened, and either ``tables`` (a realized
    ``core.faults.FaultTables``) or ``schedule`` (a ``FaultSchedule``
    realized here at (iters, seed))}. A hardened run and its ablation
    that share the same ``tables`` *object* also share one measurement
    table. The whole batch is ONE engine call of ``iters`` steps on
    ``device``; ``robust`` sets the hardening constants.

    Returns per-request dicts: the commanded/applied row traces, the
    float64 telemetry trace (NaN on drops), per-interval accepted /
    fallback flags, the recorded-history rows, and the final pick
    (``fault_pick`` over the recorded history — the same helper the
    scalar cell runner uses).
    """
    if not reqs:
        return []
    rb = robust if robust is not None else RobustConfig()
    spaces = _batch_spaces(reqs)
    spec = EngineSpec(
        spaces=spaces,
        iters=iters,
        window=window,
        fault=True,
        gate_g=rb.gate_g,
        gate_eps=rb.gate_eps,
        min_accept=rb.min_accept,
        watchdog=rb.watchdog,
        act_retries=rb.act_retries,
    )
    b, n = len(reqs), spec.n
    ftabs = [
        r["tables"] if "tables" in r else r["schedule"].realize(iters, r["seed"])
        for r in reqs
    ]
    table_ids, firsts = _dedup_tables(
        [(id(r["land_tau"]), id(r["land_p"]), r["seed"], r["noise"], id(ftabs[i]))
         for i, r in enumerate(reqs)]
    )
    meas_tau = np.zeros((len(firsts), iters, n), np.float32)
    meas_p = np.zeros((len(firsts), iters, n), np.float32)
    noises = [measurement_noise(r["seed"], r["noise"], iters) for r in reqs]
    for u, i in enumerate(firsts):
        _fill_fault_tables(
            meas_tau, meas_p, u, reqs[i]["land_tau"], reqs[i]["land_p"], noises[i],
            ftabs[i],
        )
    ep = {
        "space_id": np.empty(b, np.int64),
        "table_id": table_ids,
        "tau_target": np.empty(b, np.float32),
        "p_budget": np.empty(b, np.float32),
        "throughput": np.empty(b, bool),
        "hardened": np.empty(b, bool),
        "boot_idx": np.empty(b, np.int32),
        "stick": np.empty((b, iters), np.int32),
        "reset": np.empty((b, iters), bool),
    }
    # hardened constraint back-off: the optimizer chases the margin-shrunk
    # budget (scoring always uses the full one) — the same float64
    # multiply evaluate.run_fault_regime hands its CORAL
    eff_budget = [
        r["targets"].p_budget * (1.0 - rb.p_margin) if r["hardened"]
        else r["targets"].p_budget
        for r in reqs
    ]
    for i, r in enumerate(reqs):
        sp = r["space"]
        ep["space_id"][i] = spaces.index(sp)
        ep["tau_target"][i] = _engine_tau_target(r["targets"].mode, r["targets"])
        ep["p_budget"][i] = np.float32(eff_budget[i])
        ep["throughput"][i] = r["targets"].mode == "throughput"
        ep["hardened"][i] = bool(r["hardened"])
        ep["boot_idx"][i] = _space_consts(sp)["max_idx"]
        ep["stick"][i] = ftabs[i].stick[:iters]
        ep["reset"][i] = ftabs[i].reset[:iters]
    res = _run(spec, *_to_device(ep, meas_tau, meas_p, device), device)
    out: List[dict] = []
    for i, r in enumerate(reqs):
        mode = r["targets"].mode
        rows = space_rows(r["space"])
        applieds = res["applied"][i]
        taus, powers = fault_trace_f64(
            r["land_tau"], r["land_p"], noises[i], applieds, ftabs[i]
        )
        n_obs = int(res["n_obs"][i])
        h_t = res["hist_t"][i][:n_obs]
        h_idx = res["hist_idx"][i][:n_obs]
        rec_taus, rec_powers = taus[h_t], powers[h_t]
        pick = fault_pick(
            mode, h_idx, rec_taus, rec_powers, r["targets"].tau_target, eff_budget[i]
        )
        if pick is not None:
            result_config = rows[int(h_idx[pick])]
            outcome = Outcome(
                result_config, float(rec_taus[pick]), float(rec_powers[pick]), iters
            )
        else:
            result_config, outcome = None, Outcome(None, 0.0, 0.0, iters)
        out.append(
            {
                "commanded": [rows[int(j)] for j in res["idx"][i]],
                "applied": [rows[int(j)] for j in applieds],
                "taus": [float(v) for v in taus],
                "powers": [float(v) for v in powers],
                "accepted": [bool(v) for v in res["taken"][i]],
                "fallback": [bool(v) for v in res["guard"][i]],
                "rec_idx": h_idx.astype(np.int64),
                "rec_t": h_t.astype(np.int64),
                "n_obs": n_obs,
                "result_config": result_config,
                "outcome": outcome,
            }
        )
    return out


def run_fleet_requests(
    reqs: List[dict],
    iters: int = 30,
    window: int = 12,
    stats: Optional[dict] = None,
    device="cuda",
) -> List[dict]:
    """Run a fleet of static CORAL episodes over heterogeneous device twins
    as one batched engine call of ``iters`` steps on ``device``, with the
    factored measurement model (``EngineSpec.fleet``).

    Each request::

        {space, land_tau (N0,) float64, land_p, targets, seed, noise,
         banned:  optional (N0,) bool — firmware-locked grid rows,
         warm:    optional dict — a converged neighbour's context:
                  {hist (w, D+4) float32 window rows (w <= window),
                   prohibit (N0,) bool,
                   best/sec/last anchor scalars (+ *_valid flags),
                   min_idx, max_idx}}

    Landscapes are cast to float32 once and deduped by array identity
    (``table_id``), so a warm re-run of a twin ships its (N,) rows once;
    the noise is drawn in float64 and cast to float32 once. Returns one
    dict per request: the chosen-row trace ``idx``, the final
    ``prohibited`` mask and last-W ``window`` rows (the seed of a next,
    warm-started wave), ``n_obs`` and the anchor scalars. When ``stats``
    is a dict it receives the bytes accounting (tables, batch, device
    constants) and the episode count.
    """
    if not reqs:
        return []
    spaces = _batch_spaces(reqs)
    spec = EngineSpec(spaces=spaces, iters=iters, window=window, fleet=True)
    b, n, d, w = len(reqs), spec.n, spec.d, spec.window
    if w > iters:
        raise ValueError("fleet window must not exceed iters")

    table_ids, firsts = _dedup_tables([(id(r["land_tau"]), id(r["land_p"])) for r in reqs])
    land_tau32 = np.zeros((len(firsts), n), np.float32)
    land_p32 = np.zeros((len(firsts), n), np.float32)
    for u, i in enumerate(firsts):
        n0 = reqs[i]["land_tau"].shape[0]
        land_tau32[u, :n0] = reqs[i]["land_tau"]
        land_p32[u, :n0] = reqs[i]["land_p"]

    f32, i32 = np.float32, np.int32
    ep: Dict[str, np.ndarray] = {
        "space_id": np.empty(b, np.int64),
        "table_id": table_ids,
        "tau_target": np.empty(b, f32),
        "p_budget": np.empty(b, f32),
        "throughput": np.empty(b, bool),
        "noise": np.zeros((b, iters, 2), f32),
        "banned": np.zeros((b, n), bool),
        "min_idx": np.empty(b, i32),
        "max_idx": np.empty(b, i32),
        "warm": np.zeros(b, bool),
        "warm_n": np.zeros(b, i32),
        "warm_hist": np.zeros((b, w, d + 4), f32),
        "warm_prohibit": np.zeros((b, n), bool),
    }
    # absent anchors stay invalid at r = -inf and row -1, as a cold carry's
    for name in ("best", "sec", "last"):
        ep[f"warm_{name}_idx"] = np.full(b, -1, i32)
        ep[f"warm_{name}_tau"] = np.zeros(b, f32)
        ep[f"warm_{name}_p"] = np.zeros(b, f32)
        ep[f"warm_{name}_valid"] = np.zeros(b, bool)
        if name != "last":
            ep[f"warm_{name}_r"] = np.full(b, -np.inf, f32)

    for i, r in enumerate(reqs):
        sp = r["space"]
        n0 = sp.size()
        consts = _space_consts(sp)
        ep["space_id"][i] = spaces.index(sp)
        ep["tau_target"][i] = _engine_tau_target(r["targets"].mode, r["targets"])
        ep["p_budget"][i] = np.float32(r["targets"].p_budget)
        ep["throughput"][i] = r["targets"].mode == "throughput"
        ep["noise"][i] = measurement_noise(r["seed"], r["noise"], iters)
        if r.get("banned") is not None:
            ep["banned"][i, :n0] = r["banned"]
        ep["min_idx"][i] = consts["min_idx"]
        ep["max_idx"][i] = consts["max_idx"]
        warm = r.get("warm")
        if warm is not None:
            rows = np.asarray(warm["hist"], f32)[-w:]
            ep["warm"][i] = True
            ep["warm_n"][i] = rows.shape[0]
            ep["warm_hist"][i, : rows.shape[0]] = rows
            ep["warm_prohibit"][i, :n0] = warm["prohibit"]
            for key in _ANCHOR_KEYS:
                if key in warm:
                    ep[f"warm_{key}"][i] = warm[key]
            ep["min_idx"][i] = warm.get("min_idx", consts["min_idx"])
            ep["max_idx"][i] = warm.get("max_idx", consts["max_idx"])

    if stats is not None:
        stats["table_bytes"] = int(land_tau32.nbytes + land_p32.nbytes)
        stats["batch_bytes"] = int(sum(v.nbytes for v in ep.values()))
        stats["consts_bytes"] = int(
            sum(v.numel() * v.element_size()
                for v in _device_consts(spec, str(device)).values())
        )
        stats["episodes"] = b
    if contracts.contracts_enabled():
        contracts.check_fleet_batch(ep, b=b, n=n, w=w, d=d, t=iters)
    res = _run(spec, *_to_device(ep, land_tau32, land_p32, device), device)
    out: List[dict] = []
    for i, r in enumerate(reqs):
        n0 = r["space"].size()
        one = {
            "idx": res["idx"][i].astype(np.int64),
            "prohibited": res["prohibited"][i][:n0].copy(),
            "window": res["window"][i],
            "n_obs": int(res["n_obs"][i]),
        }
        one.update({name: res[name][i].item() for name in _ANCHOR_KEYS})
        out.append(one)
    return out


# ---------------------------------------------------------------------------
# Open-loop baselines in the same harness: no sequential dependence, so
# each is a gather against the landscape, not an engine run.
# ---------------------------------------------------------------------------


def preset_outcome(
    space: ConfigSpace,
    land_tau: np.ndarray,
    land_p: np.ndarray,
    kind: str,
    noise: float,
    seed: int,
) -> Outcome:
    """Bitwise twin of ``baselines.preset`` against a landscape table."""
    idx = row_index(space, space.preset(kind))
    z = measurement_noise(seed, noise, 1)
    tau = max(float(land_tau[idx]) * (1.0 + z[0, 0]), 1e-9)
    p = max(float(land_p[idx]) * (1.0 + z[0, 1]), 1e-9)
    return Outcome(space.preset(kind), tau, p, 1)


def alert_online_outcome(
    space: ConfigSpace,
    land_tau: np.ndarray,
    land_p: np.ndarray,
    targets,
    noise: float,
    seed: int,
    iters: int = 10,
) -> Outcome:
    """Bitwise twin of ``baselines.alert_online``: the trial configs come
    from the same config-RNG stream, the measurements from the same
    device-noise stream, and the best-feasible-by-efficiency selection
    runs in float64 — identical Outcome, no engine run required."""
    cfg_rng = np.random.default_rng(seed)
    cfgs = [space.random(cfg_rng) for _ in range(iters)]
    idxs = np.asarray([row_index(space, c) for c in cfgs])
    z = measurement_noise(seed, noise, iters)
    taus = np.maximum(land_tau[idxs] * (1.0 + z[:, 0]), 1e-9)
    powers = np.maximum(land_p[idxs] * (1.0 + z[:, 1]), 1e-9)
    feas = (taus >= targets.tau_target) & (powers <= targets.p_budget)
    if feas.any():
        eff = taus / np.maximum(powers, 1e-9)
        best = int(np.argmax(np.where(feas, eff, -np.inf)))
    elif targets.tau_target <= 0:
        best = int(np.argmax(taus))
    else:
        return Outcome(None, 0.0, 0.0, iters)
    return Outcome(cfgs[best], float(taus[best]), float(powers[best]), iters)
