"""Edge↔pod network link model and the joint offload device twin.

A plain numpy copy of ``repro.device.network``: the physics stays float64
and the noise stays numpy ``default_rng``, draw for draw, so the port's
episodes see the reference's measurements exactly.

The offload scenario (arxiv 2504.14611's joint offloading/batching/DVFS
setting mapped onto this repo's registry) gives CORAL a *placement* knob
on top of DVFS: a fraction ``offload_frac`` of admitted requests is
shipped over a radio link to the shared ``pod-v5e`` profile instead of
running on the local edge silicon. The pieces:

  ``NetworkProfile``   — the static link: uplink bandwidth, round-trip
      latency, radio energy per shipped byte, bytes shipped per item,
      the in-flight window, and the edge's fair-share divisor of the
      pod slice.
  ``NetworkSchedule``  — link degradation over the control-interval
      clock (bandwidth drops, RTT inflation ramps), the same declarative
      event shape as ``repro_torch.device.hw.DriftSchedule``.
  ``OffloadSimulator`` — the measurable twin over the joint
      ``offload_space`` grid. It implements the exact
      ``exact``/``measure``/``exact_all``/``measure_all`` protocol of
      ``DeviceSimulator`` (sequential τ-then-p noise draws; (N, 2)
      config-major noise blocks), so ORACLE, ALERT-style profiling, the
      scalar CORAL loop and the batched episode engine all run on it
      unchanged.

Throughput model (items/s, float64 throughout): a route split φ sends
φ of the admitted stream to the pod and 1−φ to the edge. The system is
a two-path capacity network —

    edge path  : τ_edge(gpu_freq, mem_freq, concurrency) / (1 − φ)
    pod path   : min(bandwidth/ship_bytes,                 (uplink)
                     max_inflight / (rtt + tenants/τ_pod), (window)
                     τ_pod(pod_tpu_freq) / tenants) / φ    (slice)
    served τ   = min(edge path, pod path, demand λ)

so φ=0 degenerates to the plain edge twin and a demand λ far above the
edge's best τ makes every φ=0 row SLO-infeasible — the regime the
offload scenario cells are built around. The measured power channel is
the *edge device rail only*: edge compute power, plus the radio
(idle hold + per-shipped-byte energy) whenever φ>0. Pod-side power
never appears on the edge rail.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.space import ConfigSpace, Config, offload_space
from repro_torch.device.hw import DeviceProfile, get_profile
from repro_torch.device.perfmodel import PerfModel, model_roofline_terms
from repro_torch.device.power import PowerModel


# ---------------------------------------------------------------------------
# The link
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NetworkProfile:
    """One edge↔pod link: bandwidth/latency/energy per shipped item.

    ``bandwidth`` is the sustained uplink in bytes/s and ``ship_bytes``
    the bytes shipped per offloaded item (tokens + context), so
    ``bandwidth / ship_bytes`` is the uplink item rate. ``max_inflight``
    is the transport window in items; with a pod-slice service time of
    ``pod_tenants / τ_pod`` the window caps the rate at
    ``max_inflight / (rtt_s + pod_tenants/τ_pod)`` — which is what makes
    pod DVFS visible from the edge. ``energy_per_byte`` and
    ``radio_idle_w`` are the radio's per-shipped-byte and hold-active
    draws on the edge power rail."""

    name: str
    bandwidth: float  # B/s uplink
    rtt_s: float  # round-trip latency, seconds
    energy_per_byte: float  # J/B on the edge radio
    radio_idle_w: float  # W while the link is held active (φ > 0)
    ship_bytes: float  # B shipped per offloaded item
    max_inflight: float  # transport window, items
    slice_chips: int  # pod chips provisioned behind the tenant slice
    pod_tenants: float  # edge tenants sharing the provisioned slice
    token_bytes: float = 1e3  # B shipped per token at the serving layer

    @property
    def ship_energy_j(self) -> float:
        """Radio energy per shipped item (J)."""
        return self.energy_per_byte * self.ship_bytes

    @property
    def ship_energy_per_token_j(self) -> float:
        """Radio energy per shipped token (J) — the serving runtime's
        per-token metering unit (``ServingRuntime.network_energy_j``)."""
        return self.energy_per_byte * self.token_bytes

    @property
    def uplink_items_s(self) -> float:
        """Bandwidth-bound item rate of the uplink."""
        return self.bandwidth / self.ship_bytes


# Link registry, one entry per deployment class. Magnitudes are
# LTE/fiber-class: a shipped item carries its context/frame (~256 KB),
# radio energy per byte is the cellular-uplink figure scaled to a
# modem+RF chain that is not the dominant board rail, and each edge
# tenant gets a 2-chip provisioned slice of the pod shared ~14 ways.
NETWORKS: Dict[str, NetworkProfile] = {
    n.name: n
    for n in (
        NetworkProfile(
            name="lte-uplink",
            bandwidth=40e6,  # 40 MB/s class uplink
            rtt_s=0.045,
            energy_per_byte=0.15e-6,
            radio_idle_w=1.2,
            ship_bytes=256e3,
            max_inflight=24.0,
            slice_chips=2,
            pod_tenants=14.0,
        ),
        NetworkProfile(
            name="fiber-metro",
            bandwidth=120e6,
            rtt_s=0.018,
            energy_per_byte=0.05e-6,
            radio_idle_w=0.8,
            ship_bytes=256e3,
            max_inflight=32.0,
            slice_chips=2,
            pod_tenants=14.0,
        ),
    )
}


def get_network(name: str) -> NetworkProfile:
    """Look up a network profile by registry name (KeyError lists the
    known names)."""
    if name not in NETWORKS:
        raise KeyError(f"unknown network profile {name!r}; known: {sorted(NETWORKS)}")
    return NETWORKS[name]


# ---------------------------------------------------------------------------
# Link degradation: the drift-event shape on the network
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NetworkState:
    """The link's operating condition at one control interval.

    ``bw_scale`` multiplies the deliverable bandwidth (congestion,
    fading); ``rtt_inflation`` adds that fraction of the nominal RTT
    (queueing delay, jitter). Mirrors ``repro_torch.device.hw.DriftState``."""

    bw_scale: float = 1.0
    rtt_inflation: float = 0.0

    @property
    def stationary(self) -> bool:
        return self == NET_NOMINAL


NET_NOMINAL = NetworkState()


@dataclasses.dataclass(frozen=True)
class LinkDegrade:
    """A congestion step: bandwidth drops to ``bw_scale``× and RTT
    inflates at ``start`` (recovering at ``until`` if set)."""

    start: int
    bw_scale: float = 0.5
    rtt_inflation: float = 0.5
    until: Optional[int] = None

    def state_at(self, t: int) -> NetworkState:
        active = t >= self.start and (self.until is None or t < self.until)
        if not active:
            return NET_NOMINAL
        return NetworkState(bw_scale=self.bw_scale, rtt_inflation=self.rtt_inflation)

    @property
    def end(self) -> int:
        return self.start


@dataclasses.dataclass(frozen=True)
class RttRamp:
    """Queueing delay builds linearly over ``duration`` intervals from
    ``start`` and then holds — the link analogue of ``ThermalRamp``."""

    start: int
    duration: int = 6
    rtt_inflation: float = 1.0

    def state_at(self, t: int) -> NetworkState:
        ramp = min(max((t - self.start) / max(self.duration, 1), 0.0), 1.0)
        return NetworkState(rtt_inflation=ramp * self.rtt_inflation)

    @property
    def end(self) -> int:
        return self.start + self.duration


NetworkEvent = object  # LinkDegrade | RttRamp


@dataclasses.dataclass(frozen=True)
class NetworkSchedule:
    """Link-degradation events composed over the control-interval clock:
    ``bw_scale`` factors multiply (floored at 0.05), ``rtt_inflation``
    terms sum — the composition rules of ``DriftSchedule``."""

    events: Tuple[NetworkEvent, ...] = ()

    def state_at(self, t: int) -> NetworkState:
        bw, rtt = 1.0, 0.0
        for ev in self.events:
            s = ev.state_at(t)
            bw *= s.bw_scale
            rtt += s.rtt_inflation
        return NetworkState(bw_scale=max(bw, 0.05), rtt_inflation=rtt)

    @property
    def shift_start(self) -> int:
        return min((ev.start for ev in self.events), default=0)

    @property
    def shift_end(self) -> int:
        return max((ev.end for ev in self.events), default=0)

    def states_stacked(self, intervals: int) -> Dict[str, np.ndarray]:
        """(intervals,) float64 arrays of every ``NetworkState`` field."""
        states = [self.state_at(t) for t in range(intervals)]
        return {
            f.name: np.asarray([getattr(s, f.name) for s in states], np.float64)
            for f in dataclasses.fields(NetworkState)
        }


NO_DEGRADATION = NetworkSchedule(())


# ---------------------------------------------------------------------------
# The joint offload twin
# ---------------------------------------------------------------------------


class OffloadSimulator:
    """Measurable twin over the joint edge↔pod ``offload_space`` grid.

    Evaluates the two-path capacity model in the module docstring for
    (N, 5) config matrices over the dims (gpu_freq, mem_freq,
    concurrency, offload_frac, pod_tpu_freq). Dims the joint space does
    not expose (edge CPU knobs, pod HBM/host/concurrency) are pinned at
    their nominal operating points so the edge and pod ``PerfModel``s
    evaluate on full canonical columns.

    ``demand`` is the offered arrival rate λ (items/s): served τ
    saturates at it, and ``float('inf')`` (the default) reads the raw
    path capacity — which is how ``edge_only_max`` calibrates λ before
    the scenario pins it. The measurement protocol is byte-compatible
    with ``DeviceSimulator``: ``measure`` draws τ then p noise from the
    same ``default_rng(seed)`` stream, ``measure_all`` draws the (N, 2)
    block config-major, so the batched episode engine's replayed noise
    matches the scalar loop's exactly.
    """

    def __init__(
        self,
        edge_profile: DeviceProfile,
        model_cfg,
        network: NetworkProfile,
        pod_profile: Optional[DeviceProfile] = None,
        kind: str = "decode",
        batch: int = 8,
        seq: int = 256,
        noise: float = 0.02,
        seed: int = 0,
        demand: float = float("inf"),
        schedule: NetworkSchedule = NO_DEGRADATION,
    ):
        pod_profile = pod_profile or get_profile("pod-v5e")
        self.space: ConfigSpace = offload_space(edge_profile.space_kind)
        self.network = network
        self.demand = float(demand)
        self.noise = noise
        self.rng = np.random.default_rng(seed)
        self.n_measurements = 0
        self.schedule = schedule
        self._state = schedule.state_at(0)

        edge_terms = model_roofline_terms(
            model_cfg, edge_profile, kind=kind, batch=batch, seq=seq
        )
        self.edge_perf = PerfModel(
            edge_terms, edge_profile.hw, edge_profile.contention_kappa
        )
        self.edge_power = PowerModel(self.edge_perf, edge_profile.hw)
        # The tenant slice is provisioned as a few dedicated pod chips —
        # device-bound at that scale, so the pod power-state ladder
        # (which scales core and HBM clocks together, see offload_cap)
        # genuinely moves the slice's throughput.
        slice_profile = dataclasses.replace(
            pod_profile, n_chips=network.slice_chips
        )
        pod_terms = model_roofline_terms(
            model_cfg, slice_profile, kind=kind, batch=batch, seq=seq
        )
        self.pod_perf = PerfModel(
            pod_terms, pod_profile.hw, pod_profile.contention_kappa
        )
        # pinned operating points for dims absent from the joint space
        self._edge_fixed = {
            "host_cpu_freq": edge_profile.hw.nominal_host_freq,
            "host_cores": 6.0,
        }
        self._pod_fixed = {
            "hbm_freq": pod_profile.hw.nominal_hbm_freq,
            "host_cpu_freq": pod_profile.hw.nominal_host_freq,
            "host_cores": 6.0,
            "concurrency": 4.0,
        }

    # -------------------------------------------------------------- clock
    def set_time(self, t: int) -> None:
        """Advance the link-degradation clock (no-op without events)."""
        self._state = self.schedule.state_at(int(t))

    @property
    def state(self) -> NetworkState:
        return self._state

    # ----------------------------------------------------------- evaluate
    def _columns(self, grid: np.ndarray) -> Dict[str, np.ndarray]:
        return {n: grid[:, i] for i, n in enumerate(self.space.names)}

    def offload_cap(self, pod_freq: np.ndarray) -> np.ndarray:
        """Item rate the pod path can carry (N,): the min of the uplink,
        the transport window over the effective round trip, and the
        edge's fair share of the provisioned pod slice. The pod
        power-state ladder scales core and HBM clocks together (coupled
        DVFS domains), so ``pod_tpu_freq`` moves the slice rate even for
        memory-bound decode."""
        net, state = self.network, self._state
        freq = np.asarray(pod_freq, np.float64)
        pod_cols = {k: np.full_like(freq, v) for k, v in self._pod_fixed.items()}
        pod_cols["tpu_freq"] = freq
        pod_cols["hbm_freq"] = self._pod_fixed["hbm_freq"] * (
            freq / self.pod_perf.hw.nominal_tpu_freq
        )
        tau_pod = self.pod_perf.stats_batch(pod_cols)[0]
        slice_rate = tau_pod / net.pod_tenants
        rtt = net.rtt_s * (1.0 + state.rtt_inflation)
        window_rate = net.max_inflight / (rtt + 1.0 / np.maximum(slice_rate, 1e-12))
        uplink_rate = net.uplink_items_s * state.bw_scale
        return np.minimum(np.minimum(uplink_rate, window_rate), slice_rate)

    def capacity_all(
        self, configs: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Noise-free (capacity, edge-rail power) over an (N, 5) config
        matrix, *before* the demand saturation — ``exact_all`` is
        ``min(capacity, demand)`` on the τ channel."""
        if configs is None:
            configs = self.space.grid()
        grid = np.asarray(configs, np.float64)
        g = self._columns(grid)
        edge_cols = {
            "tpu_freq": g["gpu_freq"],
            "hbm_freq": g["mem_freq"],
            "concurrency": g["concurrency"],
            "host_cpu_freq": np.full(grid.shape[0], self._edge_fixed["host_cpu_freq"]),
            "host_cores": np.full(grid.shape[0], self._edge_fixed["host_cores"]),
        }
        tau_edge, util, mem_frac = self.edge_perf.stats_batch(edge_cols)
        p_edge = self.edge_power.power_batch(edge_cols, util, mem_frac)

        phi = g["offload_frac"]
        off_cap = self.offload_cap(g["pod_tpu_freq"])
        with np.errstate(divide="ignore"):
            edge_rate = np.where(phi < 1.0, tau_edge / np.maximum(1.0 - phi, 1e-12), np.inf)
            off_rate = np.where(phi > 0.0, off_cap / np.maximum(phi, 1e-12), np.inf)
        capacity = np.minimum(edge_rate, off_rate)
        return capacity, p_edge

    def exact_all(
        self, configs: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Noise-free served (τ, edge-rail p) for an (N, 5) config matrix
        (defaults to the full ``space.grid()``). τ saturates at the
        offered demand; the power channel adds the radio hold + the
        per-shipped-item energy of what actually ships."""
        if configs is None:
            configs = self.space.grid()
        grid = np.asarray(configs, np.float64)
        capacity, p_edge = self.capacity_all(grid)
        phi = self._columns(grid)["offload_frac"]
        tau = np.minimum(capacity, self.demand)
        shipped = phi * tau  # items/s actually routed to the pod
        net = self.network
        p = p_edge + np.where(
            phi > 0.0, net.radio_idle_w + net.ship_energy_j * shipped, 0.0
        )
        return tau, p

    def edge_only_max(self) -> float:
        """Best served τ over the φ=0 rows at unlimited demand — the
        un-offloaded edge capacity the scenario scales λ against."""
        grid = self.space.grid()
        phi = self._columns(grid)["offload_frac"]
        cap, _ = self.capacity_all(grid)
        return float(cap[phi == 0.0].max())

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
        """Noisy batched measurement — the (N, 2) config-major noise
        block of ``DeviceSimulator.measure_all``."""
        if configs is None:
            configs = self.space.grid()
        tau, p = self.exact_all(configs)
        self.n_measurements += tau.size
        if self.noise:
            z = self.rng.normal(0.0, self.noise, size=(tau.size, 2))
            tau = tau * (1.0 + z[:, 0])
            p = p * (1.0 + z[:, 1])
        return np.maximum(tau, 1e-9), np.maximum(p, 1e-9)
