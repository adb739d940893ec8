"""Fleet-scale CORAL: 1000+ heterogeneous device twins in one engine call.

The scenario matrix tunes *registry* devices — one twin per profile. A
deployed fleet is that profile times manufacturing spread: every unit
has its own silicon lottery, enclosure temperature and firmware ladder,
so (PolyThrottle's observation) every unit needs its own search. This
module turns ``device.hw.sample_perturbations`` into per-twin
landscapes/targets, runs the whole fleet through the batched episode
engine's fleet path (``run_fleet_requests`` — one call of T steps over
every twin, one dcov windows launch per step on the card), and then
re-runs a cohort *warm-started* from converged neighbors to price what
fleet memory is worth: measurements-to-feasible, cold vs warm.

Warm-start policy (EXPERIMENTS.md §Fleet):
  - a cohort twin's source is its nearest converged neighbor in
    perturbation space, same family (same ``ConfigSpace``), preferring
    the same firmware ladder variant;
  - the source contributes its last-W observation window (the dCor
    context), its prohibited set minus its own firmware bans, its
    best/second/last anchors re-scored under the *target's* constraints,
    and its observed cheapest/fastest rows as pmin/pmax probe anchors;
  - the warm re-run uses the twin's own noise stream, so cold vs warm is
    a paired comparison on identical measurement draws.

Everything is deterministic in the fleet seed: twin i's perturbation
and noise stream depend only on (seed, i), never on fleet size — the
64-twin CI smoke fleet is a prefix of the 1024-twin nightly fleet.

The port of ``repro.experiments.fleet``: its ``results`` block equals the
reference's, and at 1024 twins ``BENCH_fleet.json``'s, key for key
(tests/test_torch_fleet.py; on the card ``chip_smoke.py``). The
reference's ``check_twin`` (``REPRO_CONTRACTS=1``) waits for the
contracts lane (ROADMAP queue 1 item 17).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.episode import _f64_reward, run_fleet_requests
from repro_torch.core.evaluate import RegimeTargets
from repro_torch.core.space import ConfigSpace, space_grid
from repro_torch.device.hw import (
    FLEET_FAMILIES,
    DriftSchedule,
    FleetPerturbation,
    perturbed_profile,
    sample_perturbations,
)
from repro_torch.device.simulator import DriftingSimulator, build_cell_simulator
from repro_torch.experiments.scenarios import WORKLOADS

# One fleet regime: the τ floor is a fraction of each twin's own max
# throughput and the budget is slack over each twin's own cheapest
# τ-feasible draw — the strictest satisfiable shape in the matrix
# (the "pmin" anchor), resolved per twin so heterogeneous silicon gets
# heterogeneous absolute targets.
FLEET_MODEL = "qwen2.5-3b"
FLEET_WORKLOAD = "decode_steady"
FLEET_TAU_FRAC = 0.55
FLEET_P_SLACK = 1.30
FLEET_ITERS = 30
FLEET_WINDOW = 12
FLEET_WARM_EVERY = 4  # every 4th twin re-runs warm-started

_ACCEL_DIMS = ("gpu_freq", "tpu_freq")
_MEM_DIMS = ("mem_freq", "hbm_freq")


def ladder_banned_rows(space: ConfigSpace, variant: int) -> np.ndarray:
    """Firmware DVFS-ladder variant as a mask of locked-out grid rows.

    Variant 0 is stock firmware. Variant 1 caps the accelerator ladder
    below its top step (conservative thermals); variant 2 caps the
    memory ladder. Expressing variants as *bans* keeps every unit on its
    family's ``ConfigSpace`` — the engine's staged constants (escape key
    tables, ladders) are shared fleet-wide, and the engine's prohibited
    mechanism enforces the lockout from the first proposal.
    """
    banned = np.zeros(space.size(), bool)
    if variant == 0:
        return banned
    names = space.names
    cands = _ACCEL_DIMS if variant == 1 else _MEM_DIMS
    dim = next(i for i, nm in enumerate(names) if nm in cands)
    grid = space_grid(space)
    top = max(space.dims[dim].values)
    return grid[:, dim] == top


@dataclasses.dataclass
class FleetTwin:
    """One unit: its perturbation, resolved hardware, ground truth and
    per-twin absolute targets (over its *allowed* rows only):
    ``banned`` (N0,) bool, ``land_tau`` / ``land_p`` (N0,) float64, with
    N0 = space.size()."""

    pert: FleetPerturbation
    space: ConfigSpace
    banned: np.ndarray  # (N0,) bool — firmware-locked rows
    land_tau: np.ndarray  # (N0,) float64 noise-free landscape
    land_p: np.ndarray
    targets: RegimeTargets
    noise: float
    noise_seed: int

    @property
    def twin_id(self) -> int:
        return self.pert.twin_id


def build_twin(
    pert: FleetPerturbation,
    model: str = FLEET_MODEL,
    workload: str = FLEET_WORKLOAD,
    tau_frac: float = FLEET_TAU_FRAC,
    p_slack: float = FLEET_P_SLACK,
) -> FleetTwin:
    """Resolve one perturbation into landscapes + targets. The ambient
    derate is applied as a stationary one-event drift schedule, so the
    landscape math is exactly the drift simulator's."""
    profile = perturbed_profile(pert)
    w = WORKLOADS[workload]
    sim0 = build_cell_simulator(
        profile,
        get_config(model),
        kind=w.kind,
        batch=w.batch,
        seq=w.seq,
        noise=0.0,
        seed=0,
    )
    twin_sim = DriftingSimulator(sim0, DriftSchedule((pert.ambient(),)))
    land_tau, land_p = twin_sim.exact_all()
    space = profile.space()
    banned = ladder_banned_rows(space, pert.ladder_variant)
    allowed = ~banned
    tau_target = round(tau_frac * float(land_tau[allowed].max()), 3)
    feas = allowed & (land_tau >= tau_target)
    p_budget = float(land_p[feas].min()) * p_slack
    noise_seed = int(np.random.SeedSequence((pert.twin_id, 7, 0)).generate_state(1)[0])
    twin = FleetTwin(
        pert=pert,
        space=space,
        banned=banned,
        land_tau=land_tau,
        land_p=land_p,
        targets=RegimeTargets(mode="dual", tau_target=tau_target, p_budget=p_budget),
        noise=w.noise,
        noise_seed=noise_seed,
    )
    return twin


def build_fleet(
    n: int,
    seed: int,
    families: Sequence[str] = FLEET_FAMILIES,
    model: str = FLEET_MODEL,
    workload: str = FLEET_WORKLOAD,
) -> List[FleetTwin]:
    """Sample + resolve ``n`` twins (threaded: landscape sweeps are
    numpy and release the GIL; ``pool.map`` keeps the order)."""
    perts = sample_perturbations(n, seed, families)
    workers = min(n, os.cpu_count() or 1)
    if workers > 1:
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            return list(pool.map(lambda p: build_twin(p, model, workload), perts))
    return [build_twin(p, model, workload) for p in perts]


def _request(twin: FleetTwin, warm: Optional[dict] = None) -> dict:
    req = dict(
        space=twin.space,
        land_tau=twin.land_tau,
        land_p=twin.land_p,
        targets=twin.targets,
        seed=twin.noise_seed,
        noise=twin.noise,
        banned=twin.banned,
    )
    if warm is not None:
        req["warm"] = warm
    return req


def measurements_to_feasible(twin: FleetTwin, idxs: np.ndarray) -> Optional[int]:
    """1-based index of the first *truly* feasible measurement (noise-
    free landscape values at the chosen rows), None if the episode never
    lands one — the honest fleet-convergence statistic (the matrix's
    noisy-trace variant would credit lucky noise draws)."""
    t = twin.land_tau[idxs]
    p = twin.land_p[idxs]
    feas = (t >= twin.targets.tau_target) & (p <= twin.targets.p_budget)
    if not feas.any():
        return None
    return int(np.argmax(feas)) + 1


def twin_score(twin: FleetTwin, idxs: np.ndarray) -> Optional[float]:
    """Best truly-feasible measured efficiency (τ/p), normalized by the
    twin's exhaustive-search optimum over its allowed rows. None if no
    feasible row was measured."""
    t = twin.land_tau[idxs]
    p = twin.land_p[idxs]
    feas = (t >= twin.targets.tau_target) & (p <= twin.targets.p_budget)
    if not feas.any():
        return None
    allowed = ~twin.banned
    oracle_feas = (
        allowed
        & (twin.land_tau >= twin.targets.tau_target)
        & (twin.land_p <= twin.targets.p_budget)
    )
    best = float((t[feas] / p[feas]).max())
    opt = float((twin.land_tau[oracle_feas] / twin.land_p[oracle_feas]).max())
    return best / opt


def _pert_vec(p: FleetPerturbation) -> np.ndarray:
    return np.asarray(
        [
            p.compute_scale,
            p.mem_scale,
            p.host_scale,
            p.power_scale,
            p.ambient_derate,
        ]
    )


def match_neighbor(
    twin: FleetTwin,
    sources: List[Tuple[FleetTwin, dict]],
) -> Optional[Tuple[FleetTwin, dict]]:
    """Nearest converged source in perturbation space: same family
    (hence identical ``ConfigSpace``), preferring the same firmware
    ladder variant; falls back to any variant of the family."""
    fam = [
        (s, r)
        for s, r in sources
        if s.pert.family == twin.pert.family and s.twin_id != twin.twin_id
    ]
    same_ladder = [
        (s, r)
        for s, r in fam
        if s.pert.ladder_variant == twin.pert.ladder_variant
    ]
    pool = same_ladder or fam
    if not pool:
        return None
    me = _pert_vec(twin.pert)
    dists = [float(np.linalg.norm(_pert_vec(s.pert) - me)) for s, _ in pool]
    return pool[int(np.argmin(dists))]


def warm_context(source: FleetTwin, src_res: dict, twin: FleetTwin) -> dict:
    """The warm-start payload a converged source hands a new twin.

    Window rows transfer verbatim (the dCor patterns are what carry);
    anchors are re-scored under the *target's* constraints so the
    engine's best/second ordering is consistent with the rewards it will
    compute; the source's own firmware bans are stripped from the
    transferred prohibited set (they are policy, not physics, and the
    target's bans are re-imposed independently)."""
    w = src_res["window"]
    k = min(src_res["n_obs"], w.shape[0])
    rows = w[:k]
    d = len(twin.space.dims)
    taus, ps = rows[:, d].astype(np.float64), rows[:, d + 1].astype(np.float64)
    idxr = rows[:, d + 3].astype(np.int64)
    r = _f64_reward(
        twin.targets.mode,
        taus,
        ps,
        twin.targets.tau_target,
        twin.targets.p_budget,
    )
    order = np.argsort(-r, kind="stable")
    best = int(order[0])
    anchors = dict(
        best_idx=int(idxr[best]),
        best_tau=float(taus[best]),
        best_p=float(ps[best]),
        best_r=float(r[best]),
        best_valid=True,
    )
    if k > 1:
        sec = int(order[1])
        anchors.update(
            sec_idx=int(idxr[sec]),
            sec_tau=float(taus[sec]),
            sec_p=float(ps[sec]),
            sec_r=float(r[sec]),
            sec_valid=True,
        )
    anchors.update(
        last_idx=int(idxr[-1]),
        last_tau=float(taus[-1]),
        last_p=float(ps[-1]),
        last_valid=True,
    )
    return dict(
        hist=rows,
        prohibit=src_res["prohibited"] & ~source.banned,
        min_idx=int(idxr[int(np.argmin(ps))]),
        max_idx=int(idxr[int(np.argmax(taus))]),
        **anchors,
    )


def _curve(m2fs: List[Optional[int]], iters: int) -> List[float]:
    """Fraction of twins feasible within m measurements, m = 1..iters."""
    n = max(len(m2fs), 1)
    got = np.zeros(iters, np.int64)
    for m in m2fs:
        if m is not None:
            got[m - 1 :] += 1
    return [round(float(v) / n, 6) for v in got]


def _mean(vals: List[float]) -> Optional[float]:
    return round(float(np.mean(vals)), 6) if vals else None


def run_fleet(
    n_twins: int = 1024,
    seed: int = 0,
    iters: int = FLEET_ITERS,
    window: int = FLEET_WINDOW,
    warm_every: int = FLEET_WARM_EVERY,
    families: Sequence[str] = FLEET_FAMILIES,
    model: str = FLEET_MODEL,
    workload: str = FLEET_WORKLOAD,
    probe_steady: bool = False,
    device="cuda",
) -> dict:
    """The fleet experiment: one engine call tunes every twin cold,
    then every ``warm_every``-th twin re-runs warm-started from its
    nearest converged non-cohort neighbor. Returns the BENCH_fleet
    payload: a deterministic ``results`` block (same seed ⇒ byte-
    identical) plus an ``engine`` block of wall-clock / bytes accounting
    (machine-dependent, excluded from the determinism contract).

    ``probe_steady`` re-runs the cold wave once more to time the call
    again with the device constants staged and the dcov kernel built
    (twins/sec). The engine runs on ``device``; ``peak_device_bytes`` is
    the card's peak allocation over the run (None on the CPU)."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    twins = build_fleet(n_twins, seed, families, model, workload)
    prep_s = time.perf_counter() - t0

    stats: dict = {}
    t0 = time.perf_counter()
    cold = run_fleet_requests(
        [_request(tw) for tw in twins], iters, window, stats, device=device
    )
    cold_s = time.perf_counter() - t0

    steady_s = None
    if probe_steady:
        t0 = time.perf_counter()
        run_fleet_requests([_request(tw) for tw in twins], iters, window, device=device)
        steady_s = time.perf_counter() - t0

    m2f_cold = [measurements_to_feasible(tw, r["idx"]) for tw, r in zip(twins, cold)]
    scores = [twin_score(tw, r["idx"]) for tw, r in zip(twins, cold)]

    # ---- warm cohort: every warm_every-th twin, sources = the rest ----
    cohort = [i for i in range(n_twins) if i % warm_every == 0]
    sources = [
        (twins[i], cold[i])
        for i in range(n_twins)
        if i % warm_every != 0 and m2f_cold[i] is not None
    ]
    warm_reqs, warm_ids = [], []
    for i in cohort:
        match = match_neighbor(twins[i], sources)
        if match is None:
            continue
        src, src_res = match
        warm_reqs.append(_request(twins[i], warm=warm_context(src, src_res, twins[i])))
        warm_ids.append(i)
    t0 = time.perf_counter()
    warm = (
        run_fleet_requests(warm_reqs, iters, window, device=device) if warm_reqs else []
    )
    warm_s = time.perf_counter() - t0
    m2f_warm = {
        i: measurements_to_feasible(twins[i], r["idx"])
        for i, r in zip(warm_ids, warm)
    }

    # paired cohort comparison: same twin, same noise stream
    paired = [
        (m2f_cold[i], m2f_warm[i])
        for i in warm_ids
        if m2f_cold[i] is not None and m2f_warm[i] is not None
    ]
    mean_cold_cohort = _mean([float(c) for c, _ in paired])
    mean_warm_cohort = _mean([float(w) for _, w in paired])
    warm_gain = (
        round(mean_cold_cohort / mean_warm_cohort, 6)
        if paired and mean_warm_cohort
        else None
    )

    per_family: Dict[str, dict] = {}
    convergence: Dict[str, dict] = {}
    for fam in families:
        ids = [i for i in range(n_twins) if twins[i].pert.family == fam]
        fam_m2f = [m2f_cold[i] for i in ids]
        fam_warm = [m2f_warm[i] for i in warm_ids if twins[i].pert.family == fam]
        per_family[fam] = {
            "n_twins": len(ids),
            "feasible_rate": round(
                sum(m is not None for m in fam_m2f) / max(len(ids), 1), 6
            ),
            "mean_m2f": _mean([float(m) for m in fam_m2f if m is not None]),
            "mean_score": _mean([scores[i] for i in ids if scores[i] is not None]),
        }
        convergence[fam] = {
            "cold": _curve(fam_m2f, iters),
            "warm": _curve(fam_warm, iters),
        }
    convergence["all"] = {
        "cold": _curve(m2f_cold, iters),
        "warm": _curve(list(m2f_warm.values()), iters),
    }

    results = {
        "n_twins": n_twins,
        "seed": seed,
        "iters": iters,
        "window": window,
        "families": list(families),
        "model": model,
        "workload": workload,
        "feasible_rate": round(sum(m is not None for m in m2f_cold) / n_twins, 6),
        "mean_m2f_cold": _mean([float(m) for m in m2f_cold if m is not None]),
        "mean_score": _mean([s for s in scores if s is not None]),
        "warm_cohort": len(cohort),
        "warm_matched": len(warm_ids),
        "mean_m2f_cold_cohort": mean_cold_cohort,
        "mean_m2f_warm_cohort": mean_warm_cohort,
        "warm_gain": warm_gain,
        "per_family": per_family,
        "convergence": convergence,
    }

    engine = {
        "backend": "cuda" if on_card else "cpu",
        "prep_s": round(prep_s, 3),
        "cold_wall_s": round(cold_s, 3),
        "warm_wall_s": round(warm_s, 3),
        "steady_wall_s": round(steady_s, 3) if steady_s is not None else None,
        "twins_per_s": round(n_twins / steady_s, 2) if steady_s else None,
        "table_bytes": stats.get("table_bytes"),
        "batch_bytes": stats.get("batch_bytes"),
        "consts_bytes": stats.get("consts_bytes"),
        "peak_device_bytes": (
            int(torch.cuda.max_memory_allocated(device)) if on_card else None
        ),
    }
    return {"results": results, "engine": engine}
