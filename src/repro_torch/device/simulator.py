"""The tunable "device" that CORAL optimizes — the pod-level analogue of
the paper's Jetson + tegrastats measurement loop (Fig. 2).

``measure`` applies a configuration and returns noisy (throughput, power),
like a real 1-second tegrastats sample; ``exact`` is the noise-free ground
truth used only by ORACLE (exhaustive offline profiling).

The simulator is parameterized by RooflineTerms from a model's analytic
footprint (``build_cell_simulator``) or by synthetic terms in unit tests.
A plain numpy copy of ``repro.device.simulator``: the noise stays numpy
``default_rng``, draw for draw, so the port's episodes see the reference's
measurements exactly. ``DriftingSimulator`` (the drift cells' time-varying
twin) and ``FaultySimulator`` (the fault cells' fault-injected twin) wrap
a ``DeviceSimulator`` on a control-interval clock.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.space import Config, ConfigSpace
from repro_torch.device.hw import (
    DEFAULT_HW,
    DeviceProfile,
    DriftSchedule,
    DriftState,
    TPUv5eSpec,
)
from repro_torch.device.perfmodel import (
    PerfModel,
    RooflineTerms,
    canon_columns,
    model_roofline_terms,
)
from repro_torch.device.power import PowerModel


class DeviceSimulator:
    def __init__(
        self,
        space: ConfigSpace,
        terms: RooflineTerms,
        hw: TPUv5eSpec = DEFAULT_HW,
        noise: float = 0.02,
        seed: int = 0,
        contention_kappa: float = 0.06,
    ):
        self.space = space
        self.perf = PerfModel(terms, hw, contention_kappa)
        self.power_model = PowerModel(self.perf, hw)
        self.noise = noise
        self.rng = np.random.default_rng(seed)
        self.n_measurements = 0

    def _to_dict(self, config: Config) -> Dict[str, float]:
        from repro_torch.device.perfmodel import canon

        return canon(dict(zip(self.space.names, config)))

    def exact(self, config: Config) -> Tuple[float, float]:
        d = self._to_dict(config)
        return self.perf.throughput(d), self.power_model.power(d)

    def measure(self, config: Config) -> Tuple[float, float]:
        tau, p = self.exact(config)
        self.n_measurements += 1
        if self.noise:
            tau *= 1.0 + self.rng.normal(0.0, self.noise)
            p *= 1.0 + self.rng.normal(0.0, self.noise)
        return max(tau, 1e-9), max(p, 1e-9)

    # ------------------------------------------------------------------
    # Batched sweeps: one numpy evaluation over an (N, D) config matrix
    # instead of N Python calls — what ORACLE / ALERT profiling / the
    # Pareto figures run on.
    # ------------------------------------------------------------------
    def exact_all(
        self, configs: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Noise-free (τ, p) arrays for an (N, D) config matrix (defaults
        to the full ``space.grid()``)."""
        if configs is None:
            configs = self.space.grid()
        cols = canon_columns(self.space.names, np.asarray(configs, np.float64))
        tau, util, mem_frac = self.perf.stats_batch(cols)
        return tau, self.power_model.power_batch(cols, util, mem_frac)

    def measure_all(
        self, configs: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Noisy batched measurement. Draws the noise as an (N, 2) block in
        config-major order, so the RNG stream — and therefore every
        downstream selection — matches N sequential ``measure`` calls
        exactly."""
        if configs is None:
            configs = self.space.grid()
        tau, p = self.exact_all(configs)
        self.n_measurements += tau.size
        if self.noise:
            z = self.rng.normal(0.0, self.noise, size=(tau.size, 2))
            tau = tau * (1.0 + z[:, 0])
            p = p * (1.0 + z[:, 1])
        return np.maximum(tau, 1e-9), np.maximum(p, 1e-9)


class DriftingSimulator:
    """A time-varying device twin: the wrapped simulator's delivered
    clocks, host speed, stream contention and static power follow a
    ``DriftSchedule`` on a control-interval clock.

    ``set_time`` advances the clock; ``exact``/``measure``/``exact_all``
    evaluate at the current interval, so the same object serves both the
    noisy device the optimizer sees and (wrapped around a noise-free
    base) the ground-truth twin that scores it — including the post-shift
    oracle, which is just ``set_time(t_end)`` + the usual batched sweep.

    Drift semantics (see ``repro_torch.device.hw.DriftState``):
      - thermal throttling reduces the *delivered* clock by
        ``derate · f_rel`` of itself — quadratic in the requested level,
        so high DVFS points lose disproportionately more throughput;
      - dynamic power still follows the *requested* DVFS point (the
        governor throttles by duty-cycling, the rail voltage stays
        commanded) while static power inflates with temperature —
        post-shift, racing the clock costs the same watts for less τ;
      - a co-tenant inflates host time and per-stream DRAM contention;
      - ``budget_scale`` is carried but not applied here: budgets are an
        external constraint, the control loop reads them off the schedule.
    """

    def __init__(self, base: DeviceSimulator, schedule: DriftSchedule):
        self.base = base
        self.space = base.space
        self.schedule = schedule
        self.noise = base.noise
        self.rng = base.rng
        self.n_measurements = 0
        self.t = 0
        self._state = schedule.state_at(0)
        self._models: Dict[Tuple[float, float], Tuple[PerfModel, PowerModel]] = {}

    def set_time(self, t: int) -> None:
        self.t = int(t)
        self._state = self.schedule.state_at(self.t)

    @property
    def state(self) -> DriftState:
        return self._state

    def _drifted_models(
        self, state: DriftState
    ) -> Tuple[PerfModel, PowerModel]:
        key = (state.host_inflation, state.kappa_add)
        if key not in self._models:
            base_perf = self.base.perf
            terms = dataclasses.replace(
                base_perf.terms,
                t_host=base_perf.terms.t_host * (1.0 + state.host_inflation),
            )
            perf = PerfModel(
                terms,
                base_perf.hw,
                base_perf.contention_kappa + state.kappa_add,
            )
            self._models[key] = (perf, PowerModel(perf, base_perf.hw))
        return self._models[key]

    def _idle_power(self) -> float:
        hw = self.base.perf.hw
        n = self.base.perf.terms.n_chips
        n_hosts = max(n // hw.chips_per_host, 1)
        return n * hw.p_idle_chip + n_hosts * hw.p_host_idle

    def exact_all(
        self, configs: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Noise-free (τ, p) arrays at the current drift clock."""
        if configs is None:
            configs = self.space.grid()
        grid = np.asarray(configs, np.float64)
        cols = canon_columns(self.space.names, grid)
        state = self._state
        perf, power_model = self._drifted_models(state)
        hw = perf.hw
        f_rel = cols["tpu_freq"] / hw.nominal_tpu_freq
        m_rel = cols["hbm_freq"] / hw.nominal_hbm_freq
        delivered = dict(cols)
        delivered["tpu_freq"] = cols["tpu_freq"] * (
            1.0 - state.clock_derate * f_rel
        )
        delivered["hbm_freq"] = cols["hbm_freq"] * (
            1.0 - state.mem_derate * m_rel
        )
        tau, util, mem_frac = perf.stats_batch(delivered)
        p = power_model.power_batch(cols, util, mem_frac)
        p = p + state.static_inflation * self._idle_power()
        return tau, p

    def landscapes(
        self, intervals: int, configs: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Stacked noise-free (τ, p) landscapes for intervals 0..T-1:
        two (T, N) float64 arrays, row t bitwise-equal to ``set_time(t)``
        + ``exact_all``. Drift schedules are piecewise constant (a ramp
        holds after ``duration`` intervals), so the sweep runs once per
        *unique* ``DriftState`` and rows are fanned back out — the
        array-native replacement for per-interval ``set_time`` round
        trips in both the batched episode engine and post-shift
        scoring. The drift clock is restored afterwards."""
        t_saved = self.t
        states = [self.schedule.state_at(t) for t in range(intervals)]
        unique: Dict[DriftState, int] = {}
        rows = np.empty(intervals, np.int64)
        taus, ps = [], []
        try:
            for t, s in enumerate(states):
                if s not in unique:
                    unique[s] = len(taus)
                    self.t = t
                    self._state = s
                    tau, p = self.exact_all(configs)
                    taus.append(tau)
                    ps.append(p)
                rows[t] = unique[s]
        finally:
            self.set_time(t_saved)
        return np.stack(taus)[rows], np.stack(ps)[rows]

    def exact(self, config: Config) -> Tuple[float, float]:
        tau, p = self.exact_all(np.asarray([config], np.float64))
        return float(tau[0]), float(p[0])

    def measure(self, config: Config) -> Tuple[float, float]:
        tau, p = self.exact(config)
        self.n_measurements += 1
        if self.noise:
            tau *= 1.0 + self.rng.normal(0.0, self.noise)
            p *= 1.0 + self.rng.normal(0.0, self.noise)
        return max(tau, 1e-9), max(p, 1e-9)

    def measure_all(
        self, configs: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        if configs is None:
            configs = self.space.grid()
        tau, p = self.exact_all(configs)
        self.n_measurements += tau.size
        if self.noise:
            z = self.rng.normal(0.0, self.noise, size=(tau.size, 2))
            tau = tau * (1.0 + z[:, 0])
            p = p * (1.0 + z[:, 1])
        return np.maximum(tau, 1e-9), np.maximum(p, 1e-9)


class FaultySimulator:
    """A faulty device twin: a stationary simulator wrapped with realized
    ``FaultTables`` (``core.faults``) on a control-interval clock — the
    fault-family analogue of ``DriftingSimulator``.

    The *device* is stationary; what breaks is everything around it:

      ``measure``  returns the base twin's noisy sample scaled by the
          interval's telemetry-spike factors, or (NaN, NaN) on a sensor
          dropout. The base noise stream still advances on dropped
          intervals (the sample was taken, it just never arrived), so
          fault and fault-free runs stay draw-for-draw aligned — the
          batched engine's fault tables bake the identical values.
      ``actuate``  models the knob write path: the commanded config takes
          effect only if the interval's failed-attempt count is within
          the caller's retry budget (hardened readback+retry passes
          ``RobustConfig.act_retries``; the blind ablation passes 0),
          otherwise the knob silently sticks at the previous applied
          config. A firmware reset then snaps to the default row (the
          ``max_power`` preset) regardless. Returns the config actually
          in force; ``readback`` re-reads it without side effects.
      ``exact``/``exact_all`` stay the *fault-free* ground truth — what
          the device genuinely does at a config — which is exactly what
          oracle scoring must use.
    """

    def __init__(self, base: DeviceSimulator, tables):
        self.base = base
        self.space = base.space
        self.tables = tables
        self.noise = base.noise
        self.rng = base.rng
        self.n_measurements = 0
        self.t = 0
        # a rebooted device comes up on its firmware default row
        self._applied = self.space.preset("max_power")

    def set_time(self, t: int) -> None:
        self.t = int(t)

    @property
    def pod_down(self) -> bool:
        """True while the edge→pod link outage is active (serving layer)."""
        return bool(self.tables.pod_out[self.t])

    def actuate(self, config: Config, retries: int = 0) -> Config:
        """Attempt to apply ``config`` with ``retries`` extra attempts;
        returns the config actually in force afterwards."""
        if int(self.tables.stick[self.t]) <= int(retries):
            self._applied = tuple(config)
        if bool(self.tables.reset[self.t]):
            self._applied = self.space.preset("max_power")
        return self._applied

    def readback(self) -> Config:
        return self._applied

    def exact(self, config: Config) -> Tuple[float, float]:
        return self.base.exact(config)

    def exact_all(
        self, configs: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        return self.base.exact_all(configs)

    def measure(self, config: Config) -> Tuple[float, float]:
        tau, p = self.base.measure(config)
        self.n_measurements += 1
        t = self.t
        tau *= float(self.tables.spike[t, 0])
        p *= float(self.tables.spike[t, 1])
        if bool(self.tables.drop[t]):
            return float("nan"), float("nan")
        return tau, p


def synthetic_terms(kind: str = "balanced", n_chips: int = 256) -> RooflineTerms:
    """Workload stand-ins for tests/examples before a dry-run exists."""
    kinds = {
        # t_compute, t_memory, t_collective, t_host, items_per_step
        "balanced": (8e-3, 6e-3, 2e-3, 2.5e-3, 256.0),
        "compute_bound": (20e-3, 5e-3, 2e-3, 2.0e-3, 256.0),
        "memory_bound": (2e-3, 18e-3, 1e-3, 2.0e-3, 128.0),
        "collective_bound": (3e-3, 4e-3, 12e-3, 2.0e-3, 32.0),
        "host_bound": (2e-3, 2e-3, 1e-3, 12e-3, 64.0),
    }
    t = kinds[kind]
    return RooflineTerms(*t[:4], items_per_step=t[4], n_chips=n_chips)


def build_cell_simulator(
    profile: DeviceProfile,
    model_cfg,
    kind: str = "decode",
    batch: int = 8,
    seq: int = 256,
    noise: float = 0.02,
    seed: int = 0,
) -> "DeviceSimulator":
    """Simulator for one (device profile × model × workload-kind) cell.

    The profile supplies the knob grid, power curve and derating; the
    model config supplies the FLOP/byte footprint (its analytic active
    parameter count) — see ``model_roofline_terms``. This replaces the
    hand-wired single device per script with a constructor the scenario
    matrix can call for every cell.
    """
    terms = model_roofline_terms(model_cfg, profile, kind=kind, batch=batch, seq=seq)
    return DeviceSimulator(
        profile.space(),
        terms,
        profile.hw,
        noise=noise,
        seed=seed,
        contention_kappa=profile.contention_kappa,
    )


def jetson_like_simulator(
    space: ConfigSpace, model_scale: float = 1.0, seed: int = 0, noise: float = 0.02
) -> "DeviceSimulator":
    """A single-device (n_chips=1) simulator with Jetson-like magnitudes for
    the paper-figure benchmarks: throughput in fps, power in watts.

    ``model_scale`` scales compute/memory time (YOLO≈1, FRCNN≈6, RETINANET≈12
    — the paper's 20× parameter span maps to roughly this step-time span).
    """
    from repro_torch.device.hw import TPUv5eSpec

    hw = TPUv5eSpec(
        name="jetson-like",
        nominal_tpu_freq=space.dims[2].hi,
        nominal_hbm_freq=space.dims[3].hi,
        nominal_host_freq=space.dims[0].hi,
        p_idle_chip=2.2,
        p_dyn_chip=4.5,
        p_hbm_chip=1.2,
        chips_per_host=1,
        p_host_idle=1.0,
        p_host_core=0.35,
    )
    terms = RooflineTerms(
        t_compute=12e-3 * model_scale,
        t_memory=7e-3 * model_scale,
        t_collective=0.0,
        t_host=16e-3,  # CPU preprocessing dominates on Jetson-class hosts
        items_per_step=1.0,
        n_chips=1,
    )
    return DeviceSimulator(space, terms, hw, noise=noise, seed=seed,
                           contention_kappa=0.05)
