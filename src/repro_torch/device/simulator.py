"""The tunable "device" that CORAL optimizes — the pod-level analogue of
the paper's Jetson + tegrastats measurement loop (Fig. 2).

``measure`` applies a configuration and returns noisy (throughput, power),
like a real 1-second tegrastats sample; ``exact`` is the noise-free ground
truth used only by ORACLE (exhaustive offline profiling).

The simulator is parameterized by RooflineTerms from a model's analytic
footprint (``build_cell_simulator``) or by synthetic terms in unit tests.
A plain numpy copy of ``repro.device.simulator``: the noise stays numpy
``default_rng``, draw for draw, so the port's episodes see the reference's
measurements exactly.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.space import Config, ConfigSpace
from repro_torch.device.hw import (
    DEFAULT_HW,
    DeviceProfile,
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
    """The time-varying twin of the drift cells: not ported yet (ROADMAP
    queue 1 item 7, drift episodes)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DriftingSimulator is not ported yet (ROADMAP queue 1 item 7)"
        )


class FaultySimulator:
    """The fault-injected twin of the fault cells: not ported yet (ROADMAP
    queue 1 item 8, fault episodes)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "FaultySimulator is not ported yet (ROADMAP queue 1 item 8)"
        )


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
