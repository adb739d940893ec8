"""The CORAL optimizer (paper §III).

Per iteration:
  Step 1 — Reward evaluation (Alg. 1): measure (τ, p) for the current
           config; feasible → r = τ/p, infeasible → prohibited + penalty.
  Step 2 — Correlation analysis (§III-D): distance correlations
           α_i = dCor(τ, s_i), β_i = dCor(p, s_i) over a sliding window of
           the W most recent observations.
  Step 3 — Configuration search (Alg. 2): correlation-weighted step from
           (best, second-best) toward the feasible/efficient region.

The loop runs a fixed iteration budget (10 in the paper).

Drift awareness (beyond the paper, EXPERIMENTS.md §Drift): constructed
with a ``DriftConfig`` the optimizer becomes epoch-structured — it
explores for ``explore_budget`` measurements, then *holds* its best
feasible config while a CUSUM monitor watches that config's repeated
(τ, p) measurements. A detected change-point (or an externally commanded
power-budget change that the held config violates) triggers *bounded
re-exploration*: the correlation window, anchors and exploration state
reset to a fresh epoch while the prohibited-set memory is kept — a warm
restart, not a cold one.

The port of ``repro.core.coral``. The optimizer is plain Python and numpy
on the host; its one device call is the windowed dCor of Step 2
(``correlations``), which builds the zero-padded (W, D+2) window on
``device`` and launches the dcov kernel there once per call with n ≥ 3
(the host then reads α and β back, one sync per call).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core import search
from repro_torch.core.dcov import dcor_all
from repro_torch.core.drift import DriftConfig, DriftMonitor
from repro_torch.core.faults import RobustConfig, mad_reject_trace
from repro_torch.core.reward import reward
from repro_torch.core.space import (
    Config,
    ConfigSpace,
    index_coords,
    row_index,
    space_rows,
)


def joint_headroom(taus, floors) -> np.ndarray:
    """Scalarize per-tenant throughputs against per-tenant τ floors:
    min_k τ_k/floor_k over the leading (tenant) axis.

    This is how multi-tenant cells ride CORAL's *dual* mode unchanged
    (EXPERIMENTS.md §Multi-tenant): the optimizer's τ channel carries the
    joint headroom with ``tau_target = 1.0`` — headroom ≥ 1 ⇔ every
    tenant meets its floor — while the p channel stays the shared rail
    draw. The twin (``device.cotenant``), the batched joint oracle and
    the serving controller's measured feedback all call this one helper
    so the three paths can never disagree on the scalarization."""
    taus = np.asarray(taus, np.float64)
    f = np.asarray(floors, np.float64).reshape(-1, *([1] * (taus.ndim - 1)))
    return (taus / f).min(axis=0)


@dataclasses.dataclass
class Observation:
    """One measured (config, τ, p, reward) sample — the scalar-loop unit
    the batched engine flattens into a ``hist_sm`` row (its anchor
    scalars, ``best_*``/``sec_*``/``last_*``, are this)."""

    config: Config
    tau: float
    power: float
    reward: float
    t: int = 0  # control-interval clock at measurement time


@dataclasses.dataclass
class CoralState:
    """Everything Alg. 1–2 carry between iterations: the three anchors
    (best / second / last), the prohibited set, the full observation
    history, and the probe / epoch bookkeeping. The batched engine's
    fixed-size mirror of this object is its carry
    (``repro_torch.core.episode._init_carry``)."""

    best: Optional[Observation] = None
    second: Optional[Observation] = None
    last: Optional[Observation] = None
    prohibited: Set[Config] = dataclasses.field(default_factory=set)
    history: List[Observation] = dataclasses.field(default_factory=list)
    aside: bool = False
    # Lines 14-17 heuristic (cores→MIN, concurrency→MAX) state. With a
    # finite power budget the probe re-arms every time the best config
    # changes while still power-infeasible — the coordinated cores/
    # concurrency move is what jumps into narrow feasible bands that
    # one-notch walks straddle. Without a budget (single-target mode) it
    # fires once: permanent pinning would freeze two dimensions.
    probed_for: Optional[Config] = None
    power_probe_done: bool = False
    # Drift epochs: observations before ``epoch_start`` belong to earlier
    # epochs — they stay in ``history`` (and the prohibited set keeps its
    # memory) but anchors, correlation windows and revisit tracking only
    # see the current epoch.
    epoch_start: int = 0
    resets: int = 0


class CORAL:
    """Online throughput-power co-optimizer.

    Args:
      space: discrete hardware configuration space.
      tau_target: throughput target (τ(s*) ≥ τ_target).
      p_budget: power limit (p(s*) ≤ p_budget).
      p_min: power floor for the power-saving direction (paper's p_min).
      window: sliding-window length W for the correlation analysis.
      seed: RNG seed for tie-breaking / prohibited-escape jitter.
      mode: "dual" (Alg. 1 reward, τ target + power budget) or "throughput"
        (single-target §IV-B: maximize τ, optionally under p_budget; the
        τ target is ignored and the reward is τ itself, not efficiency).
      device: where the windowed dCor runs ("cuda": the dcov kernel; "cpu":
        its plain version).
    """

    def __init__(
        self,
        space: ConfigSpace,
        tau_target: float,
        p_budget: float = float("inf"),
        p_min: float = 0.0,
        window: int = 10,
        seed: int = 0,
        step_floor: bool = True,
        probe_policy: str = "budget_aware",  # budget_aware|oneshot|persistent|off
        gamma_mode: str = "max",  # max (paper) | directional (beyond-paper)
        mode: str = "dual",  # dual | throughput (single-target §IV-B)
        drift: Optional[DriftConfig] = None,
        robust: Optional[RobustConfig] = None,
        device="cuda",
    ):
        self.space = space
        self.device = torch.device(device)
        self.mode = mode
        # Throughput mode has no τ target: an unreachable target keeps
        # Alg. 2 in its climb direction (the reward path is mode-aware and
        # never prohibits a config for missing it).
        if mode == "throughput":
            tau_target = float("inf")
        self.tau_target = tau_target
        self.p_budget = p_budget
        self.p_min = p_min
        self.window = window
        self.rng = np.random.default_rng(seed)
        self.step_floor = step_floor
        self.probe_policy = probe_policy
        self.gamma_mode = gamma_mode
        self.state = CoralState()
        self.drift = drift
        self.robust = robust
        self.clock = 0  # control-interval counter (explore + hold)
        self._held: Optional[Observation] = None
        self._monitor: Optional[DriftMonitor] = None
        self._retries = 0  # infeasible-hold retry epochs since last trigger
        self._dark = 0  # consecutive rejected/missing telemetry samples

    # ------------------------------------------------------------------
    # Drift epochs
    # ------------------------------------------------------------------
    @property
    def epoch_history(self) -> List[Observation]:
        return self.state.history[self.state.epoch_start :]

    @property
    def epoch_n(self) -> int:
        return len(self.state.history) - self.state.epoch_start

    @property
    def exploring(self) -> bool:
        """True while the current epoch's exploration budget is unspent.
        Without a DriftConfig, CORAL explores forever (paper behavior)."""
        if self.drift is None:
            return True
        return self.epoch_n < self.drift.explore_budget

    def hold_config(self) -> Config:
        """The config held (and monitored) between exploration epochs:
        the epoch's best feasible pick, falling back to best-by-reward."""
        if self._held is None:
            held = self.result()
            if held is None:
                held = self.state.last
            self._held = held
            if self.drift is not None and self.drift.monitor:
                self._monitor = DriftMonitor(
                    held.tau,
                    held.power,
                    sigma=self.drift.sigma,
                    k_sigma=self.drift.k_sigma,
                    h_sigma=self.drift.h_sigma,
                    calibration=self.drift.calibration,
                )
        return self._held.config

    def _feasible(self, tau: float, power: float) -> bool:
        """Feasibility under the *current* constraints. The τ target is
        the inf sentinel in throughput mode, so that mode only gates on
        the power cap (matching ``reward``)."""
        if self.mode == "throughput":
            return power <= self.p_budget
        return tau >= self.tau_target and power <= self.p_budget

    def _hold_reward(self, tau: float, power: float) -> float:
        """Alg. 1's reward shape without its prohibited-set mutation —
        what a calm hold interval reports (mutating would prohibit the
        held config on a single unlucky noise sample)."""
        if not self._feasible(tau, power):
            return -(power / max(tau, 1e-9))
        return tau if self.mode == "throughput" else tau / max(power, 1e-9)

    def next_config(self) -> Config:
        """Unified control-loop entry: propose while exploring, otherwise
        re-apply the held configuration.

        If an exploration epoch ends without a pick that is feasible
        under the *current* constraints, holding it would monitor a
        stably-bad signal — spend another (bounded) exploration epoch
        instead. Feasibility is re-evaluated here rather than read off
        the stored reward sign: a commanded budget change can invalidate
        a pick whose reward was computed under the old budget. The
        static ablation (monitor off) never retries: one-shot tuning
        holds whatever it found.

        With a ``RobustConfig``, a tripped telemetry watchdog (K
        consecutive rejected/missing samples) pre-empts everything:
        degrade to the safe config and hold it — no proposal, no probe
        bookkeeping — until a sample is accepted again.
        """
        if self.robust is not None and self._dark >= self.robust.watchdog:
            return self.safe_config()
        if self.exploring:
            return self.propose()
        if self._held is None and self.drift is not None and self.drift.monitor:
            held = self.result() or self.state.last
            infeasible = held is None or not self._feasible(held.tau, held.power)
            if infeasible and self._retries < self.drift.max_retries:
                self._retries += 1
                self.re_explore()
                return self.propose()
        return self.hold_config()

    def record(self, config: Config, tau: float, power: float) -> float:
        """Unified observation entry: exploration measurements feed the
        optimizer, hold measurements feed the change-point monitor (a
        trigger starts the next exploration epoch, seeded with the held
        config's just-measured post-shift performance).

        With a ``RobustConfig``, the sample first passes the hardened
        ingest gate: missing (NaN/inf) samples and MAD-flagged outliers
        are dropped *before* they can reach the dCor window, the anchor
        cascade, or the CUSUM monitor — the clock still advances, and
        the consecutive-rejection counter feeds the watchdog."""
        if self.robust is not None:
            if self._robust_reject(tau, power):
                self._dark += 1
                self.clock += 1
                return 0.0
            self._dark = 0
        if self.exploring:
            return self.observe(config, tau, power)
        self.clock += 1
        changed = self._monitor is not None and self._monitor.update(tau, power)
        if changed:
            self._retries = 0  # a real change-point refreshes the allowance
            self.re_explore()
            # Seed the new epoch with the held config's just-taken
            # measurement only if it is *infeasible* — prohibiting the
            # broken config steers the fresh search away from it. A
            # feasible-looking sample is discarded: the detector fires
            # mid-transient, and carrying a half-shifted (plus lucky
            # noise) measurement in once let a truly-infeasible config
            # outrank every genuine post-shift observation.
            if not self._feasible(tau, power):
                self.clock -= 1  # observe() re-advances the clock
                return self.observe(config, tau, power)
            return 0.0
        return self._hold_reward(tau, power)

    def re_explore(self) -> None:
        """Bounded re-exploration after a change-point: fresh epoch for
        anchors/window/probe state, prohibited-set memory retained."""
        st = self.state
        st.epoch_start = len(st.history)
        st.best = None
        st.second = None
        st.last = None
        st.aside = False
        st.probed_for = None
        st.power_probe_done = False
        st.resets += 1
        self._held = None
        self._monitor = None

    def set_p_budget(self, p_budget: float) -> None:
        """Commanded budget change (e.g. a rack-level cap step). Unlike
        environment drift this is *known*, not detected: if the held
        config's calibrated draw violates the new budget, re-explore
        immediately."""
        old = self.p_budget
        self.p_budget = p_budget
        if old == p_budget or self.exploring:
            return
        if self._held is None:
            return
        draw = (
            self._monitor.ref_power if self._monitor is not None
            else self._held.power
        )
        if draw > p_budget:
            self._retries = 0
            self.re_explore()

    # ------------------------------------------------------------------
    # Hardened ingest (EXPERIMENTS.md §Fault tolerance)
    # ------------------------------------------------------------------
    def _feasible32(self, tau: float, power: float) -> bool:
        """Feasibility evaluated in float32 — the reference's compiled fault step
        checks the safe-fallback anchor against f32 carry scalars, and
        the scalar path must make the identical call on the boundary."""
        t32, p32 = np.float32(tau), np.float32(power)
        if self.mode == "throughput":
            return bool(p32 <= np.float32(self.p_budget))
        return bool(
            (t32 >= np.float32(self.tau_target))
            and (p32 <= np.float32(self.p_budget))
        )

    def safe_config(self) -> Config:
        """Graceful-degradation target while telemetry is dark: the best
        anchor if it is still feasible under the current constraints,
        ultimately the min-power row (never bust the power budget on a
        device we cannot observe)."""
        b = self.state.best
        if b is not None and self._feasible32(b.tau, b.power):
            return b.config
        return self.space.preset("min_power")

    def _robust_reject(self, tau: float, power: float) -> bool:
        """Hardened ingest decision for one (τ, p) sample: missing
        (non-finite) samples are always dropped; finite ones pass the
        shared MAD outlier gate (``faults.mad_reject_trace``) against the
        current epoch window's float32 τ/p columns, on the window slice
        the dCor sees (``lo = max(epoch_start, n − W)``)."""
        if not (math.isfinite(tau) and math.isfinite(power)):
            return True
        rb = self.robust
        st = self.state
        n = len(st.history)
        lo = max(st.epoch_start, n - self.window)
        rows = st.history[lo:]
        win_tau = np.zeros(self.window, np.float32)
        win_p = np.zeros(self.window, np.float32)
        for k, o in enumerate(rows):
            win_tau[k] = o.tau
            win_p[k] = o.power

        def t(v):
            return torch.as_tensor(v, dtype=torch.float32, device=self.device)

        return mad_reject_trace(
            t(win_tau), t(win_p), len(rows), t(np.float32(tau)), t(np.float32(power)),
            t(np.float32(rb.gate_g)), t(np.float32(rb.gate_eps)), rb.min_accept,
        )

    # ------------------------------------------------------------------
    # Step 2: correlation analysis over the sliding window
    # ------------------------------------------------------------------
    def correlations(self) -> Tuple[np.ndarray, np.ndarray]:
        """§III-D sensitivity weights: (α, β) arrays of length D — per-knob
        dCor against τ and p over the current epoch's last-W window
        (uniform weights below 3 samples). The window is zero-padded to a
        fixed W, the same padding the batched engine's window gather
        reproduces, and goes to the dcov kernel as one (1, W, D+2) block."""
        hist = self.epoch_history[-self.window :]
        if self.drift is not None and self.drift.halflife is not None:
            # Exponentially-decayed buffer, hard-truncated at the decay
            # horizon: a sample older than ~3 halflives carries <1/8 the
            # weight of a fresh one — below the dCor window's resolution —
            # so it is dropped rather than fractionally weighted.
            horizon = 3.0 * self.drift.halflife
            hist = [o for o in hist if self.clock - o.t <= horizon]
        d = len(self.space.dims)
        n = len(hist)
        if n < 3:  # not enough samples: uniform weights
            return np.ones(d), np.ones(d)
        # Pad the window to a fixed W, as the batched engine's window is.
        settings = np.zeros((self.window, d), np.float32)
        metrics = np.zeros((self.window, 2), np.float32)
        for k, o in enumerate(hist):
            settings[k] = o.config
            metrics[k, 0] = o.tau
            metrics[k, 1] = o.power
        corr = dcor_all(settings, metrics, n, device=self.device).cpu().numpy()
        return corr[:, 0], corr[:, 1]

    # ------------------------------------------------------------------
    # Step 3: propose the next configuration
    # ------------------------------------------------------------------
    def propose(self) -> Config:
        """Alg. 2: the next configuration to measure. First probe is the
        grid midpoint, second a correlation-free diversity preset; from
        the third on, a correlation-weighted step from (best, second)
        via ``search.alg2_levels`` — the exact float32 op sequence the
        batched engine runs — with the prohibited-escape argmin on top."""
        st = self.state
        n = self.epoch_n
        if n == 0:
            return self._escape_prohibited(self.space.midpoint())
        if n == 1 or st.second is None:
            # second probe: exploit correlation-free diversity — max preset
            # if target unmet, min if power-bound.
            if self.mode == "throughput":
                cand = (
                    self.space.preset("min_power")
                    if st.last is not None and st.last.power > self.p_budget
                    else self.space.preset("max_power")
                )
            elif st.last is not None and st.last.tau < self.tau_target:
                cand = self.space.preset("max_power")
            else:
                cand = self.space.preset("min_power")
            return self._escape_prohibited(cand)
        alpha, beta = self.correlations()
        if self.mode == "throughput":
            # The lines 14-17 move is a *power* optimization. With no
            # finite budget there is no power objective and the probe
            # stays off; with one, it re-arms per new best while the cap
            # is violated — the τ precondition is vacuously met (there is
            # no τ target), and comparing against the inf sentinel would
            # disable it entirely, the same class of bug as the old
            # inf-target reward. A violated cap also means every
            # observation so far is over it, so eff_target below is -inf
            # and the probe survives next_config's own guard.
            probe = (
                self.probe_policy != "off"
                and math.isfinite(self.p_budget)
                and st.best.config != st.probed_for
                and st.best.power > self.p_budget
            )
        elif self.probe_policy == "off":
            probe = False
        elif self.probe_policy == "persistent":  # Alg. 2 lines 14-17 verbatim
            probe = st.best.power > self.p_min and st.best.tau > self.tau_target
        elif self.probe_policy == "oneshot" or not math.isfinite(self.p_budget):
            probe = (
                not st.power_probe_done
                and st.best.power > self.p_min
                and st.best.tau > self.tau_target
            )
        else:  # budget_aware (default): re-arm per new best while p > budget
            probe = (
                st.best.config != st.probed_for
                and st.best.tau > self.tau_target
                and st.best.power > self.p_budget
            )
        # Throughput mode: Alg. 2's direction test (line 6) compares τ_last
        # against the target. With no target the search always climbs —
        # except over the power cap, where an always-met effective target
        # flips it into the power-saving direction.
        eff_target = self.tau_target
        if self.mode == "throughput" and st.last.power > self.p_budget:
            eff_target = -math.inf
        cand = search.next_config(
            self.space,
            st.best.config,
            st.second.config,
            alpha,
            beta,
            tau_last=st.last.tau,
            p_last=st.last.power,
            tau_target=eff_target,
            p_min=self.p_min,
            aside=st.aside,
            tau_best=st.best.tau,
            p_best=st.best.power,
            power_probe=probe,
            step_floor=self.step_floor,
            gamma_mode=self.gamma_mode,
        )
        if probe:
            st.power_probe_done = True
            st.probed_for = st.best.config
        return self._escape_prohibited(cand)

    def _escape_prohibited(self, cand: Config) -> Config:
        """Skip configs on the prohibited list (Alg. 1): jump to the
        *nearest unseen* config — minimum L1 distance in level-index
        space (the BFS level of the old frontier walk), ties broken by
        grid-row order. The canonical rule replaces the frontier BFS
        (whose within-level order depended on path enumeration) so the
        batched episode engine can evaluate the identical argmin over
        the grid; ``tests/test_torch_episode.py`` pins the two paths together.
        Revisit tracking is per-epoch: after a change-point, pre-shift
        measurements are stale, so re-measuring an old config is allowed
        (the prohibited set itself is kept — its entries were constraint
        violations)."""
        seen = self.state.prohibited | {o.config for o in self.epoch_history}
        if cand not in seen:
            return cand
        coords = index_coords(self.space)
        n = coords.shape[0]
        seen_mask = np.zeros(n, bool)
        for cfg in seen:
            seen_mask[row_index(self.space, cfg)] = True
        if seen_mask.all():  # exhausted grid — unreachable at episode scale
            return self.space.random(self.rng)
        ci = coords[row_index(self.space, cand)]
        dist = np.abs(coords - ci).sum(axis=1).astype(np.int32)
        key = dist * np.int32(n) + np.arange(n, dtype=np.int32)
        key = np.where(seen_mask, np.int32(np.iinfo(np.int32).max), key)
        return space_rows(self.space)[int(np.argmin(key))]

    # ------------------------------------------------------------------
    # Step 1: reward evaluation & state update
    # ------------------------------------------------------------------
    def observe(self, config: Config, tau: float, power: float) -> float:
        """Alg. 1: fold one measurement into the state — Eq. 3 reward
        (which may prohibit the config), history append, and the
        best/second/last anchor update. Returns the reward."""
        st = self.state
        r = reward(
            tau,
            power,
            config,
            st.prohibited,
            self.tau_target,
            self.p_budget,
            mode=self.mode,
        )
        obs = Observation(tuple(config), tau, power, r, t=self.clock)
        self.clock += 1
        st.history.append(obs)
        # aside: last probe failed to beat the current best → flip anchors
        st.aside = st.best is not None and r <= st.best.reward
        if st.best is None or r > st.best.reward:
            st.second = st.best
            st.best = obs
        elif st.second is None or r > st.second.reward:
            st.second = obs
        st.last = obs
        return r

    # ------------------------------------------------------------------
    def result(self) -> Optional[Observation]:
        """Best feasible observation (else best by reward).

        Dual mode ranks feasible observations by efficiency τ/p; throughput
        mode (no τ target) ranks the power-feasible ones by τ. Only the
        current epoch's observations are ranked — pre-shift measurements
        describe a device that no longer exists.
        """
        hist = self.epoch_history
        if self.mode == "throughput":
            feas = [o for o in hist if o.power <= self.p_budget]
            if feas:
                return max(feas, key=lambda o: o.tau)
            return self.state.best
        feas = [
            o
            for o in hist
            if o.tau >= self.tau_target and o.power <= self.p_budget
        ]
        if feas:
            return max(feas, key=lambda o: o.tau / max(o.power, 1e-9))
        return self.state.best

    # ------------------------------------------------------------------
    # Checkpoint / restore (docs/ARCHITECTURE.md §Checkpoint format)
    # ------------------------------------------------------------------
    def to_checkpoint(self) -> dict:
        """Serialize the full optimizer state to a JSON-compatible dict.

        Everything that influences a future decision goes in: the
        observation history and anchors, the prohibited set, probe and
        epoch bookkeeping, the control clock, drift-hold state (held
        config + CUSUM monitor), the hardened-ingest dark counter, the
        *current* constraints (a commanded budget change must survive a
        restart), and the tie-break RNG's bit-generator state. A
        restored optimizer continues byte-identically to one that never
        stopped (``tests/test_faults.py`` pins this).
        """

        def _obs(o: Optional[Observation]):
            if o is None:
                return None
            return [list(o.config), o.tau, o.power, o.reward, o.t]

        st = self.state
        mon = None
        if self._monitor is not None:
            m = self._monitor
            mon = {
                "ref_tau": m.ref_tau,
                "ref_power": m.ref_power,
                "sigma": m.sigma,
                "calibration": m.calibration,
                "calib_n": m._calib_n,
                "samples": m.samples,
                "k": m.tau_cusum.k,
                "h": m.tau_cusum.h,
                "tau_pos": m.tau_cusum.pos,
                "tau_neg": m.tau_cusum.neg,
                "p_pos": m.power_cusum.pos,
                "p_neg": m.power_cusum.neg,
            }
        return {
            "version": 1,
            "mode": self.mode,
            "dims": len(self.space.dims),
            "window": self.window,
            "tau_target": self.tau_target,
            "p_budget": self.p_budget,
            "clock": self.clock,
            "retries": self._retries,
            "dark": self._dark,
            "held": _obs(self._held),
            "monitor": mon,
            "rng": self.rng.bit_generator.state,
            "state": {
                "best": _obs(st.best),
                "second": _obs(st.second),
                "last": _obs(st.last),
                "prohibited": sorted(list(c) for c in st.prohibited),
                "history": [_obs(o) for o in st.history],
                "aside": st.aside,
                "probed_for": (
                    None if st.probed_for is None else list(st.probed_for)
                ),
                "power_probe_done": st.power_probe_done,
                "epoch_start": st.epoch_start,
                "resets": st.resets,
            },
        }

    def restore(self, ckpt: dict) -> None:
        """Load state from ``to_checkpoint`` output. The optimizer must
        have been constructed with the same space/mode/window as the
        checkpointed one (validated); constraints are taken from the
        checkpoint — the live values at checkpoint time win over the
        constructor arguments."""
        if ckpt.get("version") != 1:
            raise ValueError(f"unknown checkpoint version {ckpt.get('version')!r}")
        if ckpt["mode"] != self.mode or ckpt["dims"] != len(self.space.dims):
            raise ValueError("checkpoint does not match this optimizer's space/mode")
        if ckpt["window"] != self.window:
            raise ValueError("checkpoint window mismatch")

        def _obs(row) -> Optional[Observation]:
            if row is None:
                return None
            cfg, tau, power, r, t = row
            return Observation(tuple(cfg), tau, power, r, t=int(t))

        self.tau_target = ckpt["tau_target"]
        self.p_budget = ckpt["p_budget"]
        self.clock = int(ckpt["clock"])
        self._retries = int(ckpt["retries"])
        self._dark = int(ckpt["dark"])
        self._held = _obs(ckpt["held"])
        s = ckpt["state"]
        self.state = CoralState(
            best=_obs(s["best"]),
            second=_obs(s["second"]),
            last=_obs(s["last"]),
            prohibited={tuple(c) for c in s["prohibited"]},
            history=[_obs(o) for o in s["history"]],
            aside=bool(s["aside"]),
            probed_for=(
                None if s["probed_for"] is None else tuple(s["probed_for"])
            ),
            power_probe_done=bool(s["power_probe_done"]),
            epoch_start=int(s["epoch_start"]),
            resets=int(s["resets"]),
        )
        mon = ckpt["monitor"]
        if mon is None:
            self._monitor = None
        else:
            m = DriftMonitor(
                mon["ref_tau"],
                mon["ref_power"],
                sigma=mon["sigma"],
                k_sigma=mon["k"],
                h_sigma=mon["h"],
                calibration=int(mon["calibration"]),
            )
            # DriftMonitor's constructor clamps the references; restore
            # the exact running-mean values and CUSUM statistics on top.
            m.ref_tau = mon["ref_tau"]
            m.ref_power = mon["ref_power"]
            m._calib_n = int(mon["calib_n"])
            m.samples = int(mon["samples"])
            m.tau_cusum.pos = mon["tau_pos"]
            m.tau_cusum.neg = mon["tau_neg"]
            m.power_cusum.pos = mon["p_pos"]
            m.power_cusum.neg = mon["p_neg"]
            self._monitor = m
        self.rng = np.random.default_rng()
        self.rng.bit_generator.state = ckpt["rng"]
