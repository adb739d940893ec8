"""Multi-tenant co-inference twin: K models sharing one edge rail.

A plain numpy copy of ``repro.device.cotenant`` (float64 physics, numpy
``default_rng`` noise, draw for draw).

The drift regime's ``CotenantStep`` models the neighbor as exogenous drift — a kappa
bump the tuner can only react to. This twin makes the neighbor a *knob*:
each tenant k is a (model, workload) pair with its own decode-slot
allocation ``slots_t<k>`` in the joint space (``core.space.cotenant_space``)
while the DVFS clocks and the power rail stay shared. Interference flows
through the existing stream-contention kappa: every tenant's device step
is stretched by the *total* number of live streams, so granting one
tenant a slot genuinely slows the other.

Per-tenant steady state at a joint config (the two-stage pipeline of
``PerfModel``, with a fair device-share bound replacing the solo device
bound):

    t_dev_k  = max(t_c_k·f0/f, t_m_k·m0/m)·(1 + κ·(s_total − 1))
    t_host_k = t_host0_k·(f_cpu0/f_cpu)·(6/6)^0.7        (cores pinned)
    rate_k   = min( s_k / (t_host_k + t_dev_k),          # pipelining
                    (s_k / s_total) · 1 / t_dev_k )      # fair share
    τ_k      = rate_k · items_k

Shared rail power is the usual chip+host curve at the shared clocks with
``util = min(Σ_k rate_k·t_dev_k, 1)`` and the memory-boundedness averaged
across tenants weighted by their device occupancy — pod-style attribution
questions (who pays for which watt) live in the serving runtime's
``attribute_power``, not here: the twin's p channel is the one rail.

The measured channel is *scalarized* so CORAL's dual mode, the batched
joint oracle and the batched episode engine all run unchanged: the τ
channel is the joint **headroom** min_k τ_k/floor_k against the
per-tenant floors (feasible ⇔ headroom ≥ 1, so ``tau_target`` is 1.0),
and the p channel is the shared rail draw. The noise protocol is the
exact-RNG contract of ``DeviceSimulator``: sequential τ-then-p draws in
``measure``, one config-major (N, 2) block in ``measure_all``, 1e-9
clamps — byte-for-byte replayable by ``core.episode``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.coral import joint_headroom
from repro_torch.core.space import (
    Config,
    ConfigSpace,
    TENANT_SLOT_PREFIX,
    cotenant_space,
    tenant_slot_indices,
)
from repro_torch.device.hw import DeviceProfile
from repro_torch.device.perfmodel import PerfModel, model_roofline_terms

# The host stage runs with every core available — the cores ladder is
# not part of the joint space (the slot knobs own the tenant axis).
_FIXED_CORES = 6.0


class CotenantSimulator:
    """K-tenant twin over the joint slots × shared-DVFS space.

    ``model_cfgs`` is one registry ModelConfig per tenant; ``kinds`` /
    ``batches`` the per-tenant workload shape (decode by default).
    ``floors`` start at 1.0 per tenant and are pinned post-construction
    by the scenario's calibration (``resolve_cotenant_targets``) — the
    same pin-after-build pattern as ``OffloadSimulator.demand``.
    """

    def __init__(
        self,
        profile: DeviceProfile,
        model_cfgs: Sequence,
        kinds: Sequence[str] = ("decode", "decode"),
        batches: Sequence[int] = (8, 8),
        seqs: Sequence[int] = (256, 256),
        noise: float = 0.02,
        seed: int = 0,
        space: Optional[ConfigSpace] = None,
    ):
        self.profile = profile
        self.hw = profile.hw
        self.space = (
            cotenant_space(profile.space_kind, n_tenants=len(model_cfgs))
            if space is None
            else space
        )
        self.perfs = tuple(
            PerfModel(
                model_roofline_terms(m, profile, kind=k, batch=b, seq=s),
                profile.hw,
                profile.contention_kappa,
            )
            for m, k, b, s in zip(model_cfgs, kinds, batches, seqs)
        )
        self.n_tenants = len(self.perfs)
        self._slot_idx = tenant_slot_indices(self.space)
        if len(self._slot_idx) != self.n_tenants:
            raise ValueError(
                f"space has {len(self._slot_idx)} {TENANT_SLOT_PREFIX}* dims "
                f"for {self.n_tenants} tenants"
            )
        self.floors: Tuple[float, ...] = (1.0,) * self.n_tenants
        self.noise = noise
        self.rng = np.random.default_rng(seed)
        self.n_measurements = 0

    # ------------------------------------------------------------------
    # Ground truth: per-tenant rates and the shared rail
    # ------------------------------------------------------------------
    def _columns(self, configs: Optional[np.ndarray]) -> dict:
        if configs is None:
            configs = self.space.grid()
        grid = np.asarray(configs, np.float64)
        return {n: grid[:, i] for i, n in enumerate(self.space.names)}

    def tenant_stats(
        self, configs: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-tenant noise-free stats at each joint config: (K, N) τ,
        (K, N) device occupancy rate_k·t_dev_k, (K, N) mem-boundedness."""
        cols = self._columns(configs)
        slots = [cols[self.space.names[i]] for i in self._slot_idx]
        total = np.sum(slots, axis=0)
        taus, busys, fracs = [], [], []
        for k, perf in enumerate(self.perfs):
            t_dev = perf.device_time_batch(
                cols["gpu_freq"], cols["mem_freq"], total
            )
            t_host = perf.host_time_batch(
                cols["cpu_freq"], np.full_like(total, _FIXED_CORES)
            )
            s_k = slots[k]
            rate = np.minimum(
                s_k / (t_host + t_dev), (s_k / total) / t_dev
            )
            taus.append(rate * perf.terms.items_per_step)
            busys.append(rate * t_dev)
            t_c = perf.terms.t_compute * (
                perf.hw.nominal_tpu_freq / cols["gpu_freq"]
            )
            t_m = perf.terms.t_memory * (
                perf.hw.nominal_hbm_freq / cols["mem_freq"]
            )
            fracs.append(t_m / np.maximum(t_c + t_m, 1e-12))
        return np.stack(taus), np.stack(busys), np.stack(fracs)

    def tenant_taus(self, configs: Optional[np.ndarray] = None) -> np.ndarray:
        """(K, N) noise-free per-tenant throughput at each joint config."""
        return self.tenant_stats(configs)[0]

    def rail_power(self, configs: Optional[np.ndarray] = None) -> np.ndarray:
        """(N,) shared-rail power: one chip+host curve at the shared
        clocks, utilization summed across tenants (capped at busy)."""
        cols = self._columns(configs)
        _, busy, fracs = self.tenant_stats(configs)
        util = np.minimum(busy.sum(axis=0), 1.0)
        occ = np.maximum(busy.sum(axis=0), 1e-12)
        mem_frac = (busy * fracs).sum(axis=0) / occ
        hw = self.hw
        n = self.perfs[0].terms.n_chips
        f_rel = cols["gpu_freq"] / hw.nominal_tpu_freq
        m_rel = cols["mem_freq"] / hw.nominal_hbm_freq
        p_chip = (
            hw.p_idle_chip
            + hw.p_dyn_chip * (f_rel**3) * util
            + hw.p_hbm_chip * m_rel * mem_frac * util
        )
        n_hosts = max(n // hw.chips_per_host, 1)
        c_rel = cols["cpu_freq"] / hw.nominal_host_freq
        p_host = hw.p_host_idle + _FIXED_CORES * hw.p_host_core * c_rel**2
        return n * p_chip + n_hosts * p_host

    def solo_max(self, k: int) -> float:
        """Tenant k's best achievable τ anywhere on the joint grid — the
        calibration anchor the scenario's τ-floor fractions scale."""
        return float(self.tenant_taus()[k].max())

    # ------------------------------------------------------------------
    # The measured channel: (joint headroom, rail power) — the exact-RNG
    # protocol of DeviceSimulator on the scalarized pair.
    # ------------------------------------------------------------------
    def exact_all(
        self, configs: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Noise-free (headroom, power) arrays; feasible ⇔ headroom ≥ 1."""
        taus = self.tenant_taus(configs)
        return joint_headroom(taus, self.floors), self.rail_power(configs)

    def exact(self, config: Config) -> Tuple[float, float]:
        h, p = self.exact_all(np.asarray([config], np.float64))
        return float(h[0]), float(p[0])

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
        """Noisy batched measurement; (N, 2) config-major noise block so
        the stream matches N sequential ``measure`` calls exactly."""
        if configs is None:
            configs = self.space.grid()
        tau, p = self.exact_all(configs)
        self.n_measurements += tau.size
        if self.noise:
            z = self.rng.normal(0.0, self.noise, size=(tau.size, 2))
            tau = tau * (1.0 + z[:, 0])
            p = p * (1.0 + z[:, 1])
        return np.maximum(tau, 1e-9), np.maximum(p, 1e-9)
