"""Batched episode engine: a batch of static CORAL episodes as one torch
step over B episodes, looped over T on the device.

The port of ``repro.core.episode``'s static path. The reference lifts a
``lax.scan`` over one episode with ``vmap`` and compiles it; here the
batch axis is written out, every carry field leads with B, and the step
runs eagerly T times. Its parts translate one for one:

  - history: one ``(B, T+W, D+4)`` append-only observation block — config
    values, τ, p, then the clock stamp and grid-row index as exact-
    integer float32 columns. Recording an observation is one indexed
    write over ``arange(B)`` (the reference's ``.at[].set``); the window
    is a (B, W) row gather at ``lo = max(epoch_start, n_obs − W)`` (the
    reference's ``lax.dynamic_slice``), so unwritten rows are the scalar
    path's zero padding and the window goes to the same dCor as the scalar
    spec's (``core.dcov.dcor_all_cols``, one dcov kernel launch per step
    for the whole batch on the card).
  - seen tag: one ``(B, N)`` int32 over ``space.grid()`` rows — a row is
    prohibited forever at ``INT_MAX`` (Alg. 1) or visited-this-epoch at
    the current ``epoch_id``; ``tag >= epoch_id`` is the whole revisit
    test. The canonical escape (CORAL._escape_prohibited) is one argmin
    over a row gathered from the device-resident ``(S, N, N)`` int32 key
    table of ``L1-level-distance · N + row``; argmin takes the first
    index on ties, as the reference's does.
  - anchors: best / second / last as (row-index, τ, p, reward) scalars
    with validity flags, replacing ``Observation`` objects; every update
    is a leaf gate (``where(cond, new, old)``).
  - the device twin is folded in as data: ``(B, T, N)`` float32
    measurement tables — the float64 landscape times the seed's exact
    numpy noise stream, built on the host and moved to the device once —
    so a measurement is one gather.

Decisions run in float32 on the device (``_reward``, Alg. 2 through
``search.alg2_levels``'s torch branch, the escape argmin); the records
are float64, rebuilt on the host from the landscape × noise products
(``_trace_f64``, ``_f64_reward``, ``_f64_result``), so the τ/p traces
equal the scalar loop's measurements bit for bit. The engine holds the
scalar spec's selections exactly (tests/test_torch_episode.py).

Not ported yet: the drift, fault and fleet engines (ROADMAP queue 1
items 7, 8, 11), and the reference's ``REPRO_CONTRACTS``/``REPRO_CHECKIFY``
lanes (item 17).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import search
from repro_torch.core.baselines import Outcome
from repro_torch.core.dcov import dcor_all_cols
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
    iters: int  # episode length T
    window: int  # dCor sliding window W

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
# Carry construction
# ---------------------------------------------------------------------------


def _init_carry(spec: EngineSpec, pad_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Fixed-size carry of B episodes, every field leading with B:
    ``hist_sm`` (B, T+W, D+4) float32, ``seen_tag`` (B, N) int32, and
    (B,) float32 / int32 / bool anchor and bookkeeping scalars."""
    t, w, d = spec.iters, spec.window, spec.d
    b, dev = pad_mask.shape[0], pad_mask.device
    f32, i32 = torch.float32, torch.int32

    def full(v, dtype):
        return torch.full((b,), v, dtype=dtype, device=dev)

    return {
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
        # whole revisit test
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


# ---------------------------------------------------------------------------
# CORAL step pieces (mirrors of repro_torch.core.coral, batched)
# ---------------------------------------------------------------------------


def _reward(thr, tau, p, tau_target, p_budget):
    """Alg. 1 in float32, spelled as ``core.reward`` spells it:
    (reward, infeasible)."""
    infeas = torch.where(thr, p > p_budget, (tau < tau_target) | (p > p_budget))
    penalty = -(p / torch.clamp_min(tau, 1e-9))
    gain = torch.where(thr, tau, tau / torch.clamp_min(p, 1e-9))
    return torch.where(infeas, penalty, gain), infeas


def _propose(spec: EngineSpec, k: Dict, c: Dict, thr, tau_target, p_budget):
    """CORAL.propose() for B episodes: returns (row indices (B,), probe
    bookkeeping updates)."""
    w, d = spec.window, spec.d
    ar = k["ar"]
    lo = torch.maximum(c["epoch_start"], c["n_obs"] - w)
    rows = lo[:, None] + torch.arange(w, device=lo.device)[None, :]  # (B, W)
    win = c["hist_sm"][ar[:, None], rows, : d + 2]  # (B, W, D+2)
    n_valid = c["n_obs"] - lo
    corr = dcor_all_cols(win, torch.clamp_min(n_valid, 1), d)  # (B, D, 2)
    uniform = (n_valid < 3)[:, None]
    alpha = torch.where(uniform, 1.0, corr[:, :, 0])
    beta = torch.where(uniform, 1.0, corr[:, :, 1])
    return _propose_tail(spec, k, c, thr, tau_target, p_budget, alpha, beta)


def _propose_tail(spec: EngineSpec, k: Dict, c: Dict, thr, tau_target, p_budget,
                  alpha, beta):
    """Steps 3+ of CORAL.propose — everything downstream of the window
    correlations. The power floor p_min is run_regime's, 0."""
    ar = k["ar"]
    epoch_n = c["n_obs"] - c["epoch_start"]
    p_min = 0.0

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


def _observe(k: Dict, c: Dict, cand, tau, p, thr, tau_target, p_budget):
    """CORAL.observe() for B episodes, in the scalar method's statement
    order (``aside`` reads the *old* best before the anchors shift). The
    (B, N) seen tags and the history block are written in place."""
    c = dict(c)
    ar = k["ar"]
    r, infeas = _reward(thr, tau, p, tau_target, p_budget)
    # one indexed write covers both Alg. 1's prohibit (pin at INT_MAX
    # forever) and the per-epoch revisit tag (raise to epoch_id)
    tag = c["seen_tag"][ar, cand]
    c["seen_tag"][ar, cand] = torch.where(infeas, int(_INT_MAX), torch.maximum(tag, c["epoch_id"]))
    c["aside"] = c["best_valid"] & (r <= c["best_r"])
    improves = ~c["best_valid"] | (r > c["best_r"])
    to_second = ~improves & (~c["sec_valid"] | (r > c["sec_r"]))
    old_best = (c["best_idx"], c["best_tau"], c["best_p"], c["best_r"])
    obs = (cand, tau, p, r)
    for name, bval, oval in zip(("sec_idx", "sec_tau", "sec_p", "sec_r"), old_best, obs):
        c[name] = torch.where(improves, bval, torch.where(to_second, oval, c[name]))
    c["sec_valid"] = torch.where(improves, c["best_valid"], c["sec_valid"] | to_second)
    for name, oval in zip(("best_idx", "best_tau", "best_p", "best_r"), obs):
        c[name] = torch.where(improves, oval, c[name])
    c["best_valid"] = torch.ones_like(c["best_valid"])
    for name, oval in zip(("last_idx", "last_tau", "last_p"), obs):
        c[name] = oval
    c["last_valid"] = torch.ones_like(c["last_valid"])
    obs_row = torch.cat(
        [
            k["grid32"][ar, cand],
            torch.stack([tau, p, c["clock"].to(torch.float32), cand.to(torch.float32)], 1),
        ],
        dim=1,
    )
    c["hist_sm"][ar, c["n_obs"]] = obs_row
    c["n_obs"] = c["n_obs"] + 1
    return c


def _static_step(spec: EngineSpec, k: Dict, ep: Dict, tables: Dict):
    """run_coral's loop body for B episodes: propose → measure → observe.
    Measuring is a point gather into each episode's (T, N) table."""
    thr, tau_target, p_budget = ep["throughput"], ep["tau_target"], ep["p_budget"]
    ar = k["ar"]

    def step(c, t: int):
        cand, probe_updates = _propose(spec, k, c, thr, tau_target, p_budget)
        c = {**c, **probe_updates}
        tau, p = tables["tau"][ar, t, cand], tables["p"][ar, t, cand]
        c = _observe(k, c, cand, tau, p, thr, tau_target, p_budget)
        c["clock"] = c["clock"] + 1
        return c, cand

    return step


def _run_static(spec: EngineSpec, ep: Dict, tables: Dict, device) -> np.ndarray:
    """The batched engine: T steps over B episodes on ``device``; returns
    the (B, T) chosen grid rows on the host."""
    consts = _device_consts(spec, str(device))
    sid = ep["space_id"]
    k = {name: v[sid] for name, v in consts.items() if name != "key_tab"}
    k["key_tab"] = consts["key_tab"]
    k["sid"] = sid
    k["ar"] = torch.arange(sid.shape[0], device=sid.device)
    c = _init_carry(spec, k["pad_mask"])
    step = _static_step(spec, k, ep, tables)
    idxs = []
    for t in range(spec.iters):
        c, cand = step(c, t)
        idxs.append(cand)
    return torch.stack(idxs, dim=1).cpu().numpy()


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
    meas_tau: np.ndarray,  # (B, T, N) float32 batch slot to fill at row b
    meas_p: np.ndarray,
    b: int,
    land_tau: np.ndarray,  # (N0,) float64 landscape
    land_p: np.ndarray,
    z: np.ndarray,  # (T, 2) float64 noise
) -> None:
    """Write episode b's float32 measurement tables: the float64
    landscape × noise product, rounded once on assignment — the same
    float64 values the scalar ``measure`` produces, cast to the engine's
    working precision."""
    n0 = land_tau.shape[0]
    meas_tau[b, :, :n0] = np.maximum(land_tau[None, :] * (1.0 + z[:, :1]), 1e-9)
    meas_p[b, :, :n0] = np.maximum(land_p[None, :] * (1.0 + z[:, 1:]), 1e-9)


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
    taus = np.maximum(land_tau[idxs] * (1.0 + z[:, 0]), 1e-9)
    powers = np.maximum(land_p[idxs] * (1.0 + z[:, 1]), 1e-9)
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
        "tau_target": np.empty(b, np.float32),
        "p_budget": np.empty(b, np.float32),
        "throughput": np.empty(b, bool),
    }
    for i, r in enumerate(reqs):
        ep["space_id"][i] = spaces.index(r["space"])
        ep["tau_target"][i] = _engine_tau_target(r["targets"].mode, r["targets"])
        ep["p_budget"][i] = np.float32(r["targets"].p_budget)
        ep["throughput"][i] = r["targets"].mode == "throughput"
    batch = {name: torch.from_numpy(v).to(device) for name, v in ep.items()}
    tables = {"tau": torch.from_numpy(meas_tau).to(device),
              "p": torch.from_numpy(meas_p).to(device)}
    idx_all = _run_static(spec, batch, tables, device)
    out: List[EpisodeResult] = []
    for i, r in enumerate(reqs):
        idxs = idx_all[i]
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
            )
        )
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
