"""Hardware constants and the device-profile registry.

``TPUv5eSpec`` holds one accelerator's DVFS/power constants (the same
constants the roofline analysis uses — EXPERIMENTS.md §Roofline). A
``DeviceProfile`` bundles a spec with the knob grid it exposes and the
efficiency/contention parameters needed to turn a model's FLOP/byte
footprint into ``RooflineTerms`` — the unit the scenario matrix
enumerates over (the paper's "Xavier NX vs Orin Nano" axis).

``DriftSchedule`` describes how a device's operating conditions change
over a run: thermal-throttle ramps (per-level clock derating plus
static-power inflation), co-tenant interference steps (host slowdown and
extra per-stream memory contention), and power-budget steps. A schedule
is a pure function of the control-interval clock ``t``, applied to a
simulator by ``repro_torch.device.simulator.DriftingSimulator``.

A plain copy of ``repro.device.hw`` up to its drift schedules. The
reference's fleet sampling (``ConstantDerate``, ``FleetPerturbation``,
``sample_perturbations``) waits for the fleet (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TPUv5eSpec:
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12  # per chip, at nominal clock
    hbm_bw: float = 819e9  # B/s per chip, at nominal HBM clock
    ici_bw: float = 50e9  # B/s per link
    hbm_per_chip: float = 16e9  # bytes
    nominal_tpu_freq: float = 940.0  # MHz — knob reference point
    nominal_hbm_freq: float = 2665.0  # MHz — knob reference point
    # power model (per chip) — plausible v5e-class numbers; the *structure*
    # (static + dynamic·f³ + HBM term) is what CORAL exploits, as on Jetson.
    p_idle_chip: float = 60.0  # W
    p_dyn_chip: float = 120.0  # W at nominal clock, full utilization
    p_hbm_chip: float = 30.0  # W at nominal HBM clock, fully streaming
    # host (per pod-slice host, 1 host per 8 chips on v5e)
    chips_per_host: int = 8
    p_host_idle: float = 90.0  # W
    p_host_core: float = 9.0  # W per active core at nominal host clock
    nominal_host_freq: float = 2600.0  # MHz


DEFAULT_HW = TPUv5eSpec()


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """One deployable target: accelerator spec + knob grid + derating.

    ``compute_eff``/``mem_eff`` are the achievable fractions of peak
    FLOP/s and DRAM bandwidth for dense inference (MXU/tensor-core
    utilization and streaming efficiency); ``t_host_per_item`` is the
    host-side preprocess/dispatch cost per inference item at nominal
    host clocks. Together with a model's analytic FLOP/byte footprint
    (``ModelConfig.flops_per_token``/``bytes_per_token``) they produce
    the per-(device, model) ``RooflineTerms`` the simulator runs on —
    see ``repro_torch.device.perfmodel.model_roofline_terms``.
    """

    name: str
    hw: TPUv5eSpec
    space_kind: str  # key understood by ``space()``
    n_chips: int = 1
    t_host_per_item: float = 2.5e-3  # s per item at nominal host clocks
    contention_kappa: float = 0.05  # DRAM contention per extra stream
    compute_eff: float = 0.45
    mem_eff: float = 0.70

    def space(self):
        """The profile's DVFS knob grid (its ``ConfigSpace``)."""
        from repro_torch.core.space import profile_space

        return profile_space(self.space_kind)


# Two heterogeneous edge profiles (the paper's Jetson pair analogue:
# different DVFS ladders — see ``profile_space`` — different peak
# FLOP/s, DRAM bandwidth and power curves) plus the pod target. Nominal
# clocks are each grid's top step so f_rel ≤ 1 on every knob. The power
# split is dynamic-dominated (idle is a small fraction of load power, as
# on real Jetson power rails): that is what makes "meet the target at
# low clocks" more efficient than racing to idle, i.e. what gives the
# matrix's τ-targeted regimes a non-trivial optimum.
EDGE_XAVIER_NX = DeviceProfile(
    name="edge-xavier-nx",
    hw=TPUv5eSpec(
        name="xavier-nx",
        peak_flops_bf16=1.69e12,  # Volta-class fp16
        hbm_bw=59.7e9,
        hbm_per_chip=8e9,
        nominal_tpu_freq=1010.0,
        nominal_hbm_freq=1866.0,
        nominal_host_freq=1890.0,
        p_idle_chip=1.0,
        p_dyn_chip=6.0,
        p_hbm_chip=2.5,  # LPDDR4x streaming draw is a first-class term
        chips_per_host=1,
        p_host_idle=0.5,
        p_host_core=0.35,
    ),
    space_kind="edge_xavier_nx",
    t_host_per_item=1.5e-3,
    contention_kappa=0.03,
    compute_eff=0.45,
    mem_eff=0.70,
)

EDGE_ORIN_NANO = DeviceProfile(
    name="edge-orin-nano",
    hw=TPUv5eSpec(
        name="orin-nano",
        peak_flops_bf16=1.28e12,  # Ampere-class fp16 at lower clocks
        hbm_bw=68.0e9,
        hbm_per_chip=8e9,
        nominal_tpu_freq=624.0,
        nominal_hbm_freq=3199.0,
        nominal_host_freq=1506.0,
        p_idle_chip=0.8,
        p_dyn_chip=4.0,
        p_hbm_chip=2.0,
        chips_per_host=1,
        p_host_idle=0.4,
        p_host_core=0.25,
    ),
    space_kind="edge_orin_nano",
    t_host_per_item=1.8e-3,
    contention_kappa=0.02,
    compute_eff=0.40,
    mem_eff=0.75,
)

# Orin NX class: same Ampere family as the Nano but a faster ladder in
# every dimension (more SMs, LPDDR5 at higher clocks, beefier host).
# Like the Nano — and unlike Xavier NX, whose efficiency optimum sits in
# the corner of a τ plateau — its efficiency optimum is *interior* to
# the DVFS grid, which is what makes it drift-sensitive: thermal or
# co-tenant derating genuinely reorders its configurations, so it is one
# of the two devices the dynamic (drift) scenario cells run on.
EDGE_ORIN_NX = DeviceProfile(
    name="edge-orin-nx",
    hw=TPUv5eSpec(
        name="orin-nx",
        peak_flops_bf16=1.88e12,
        hbm_bw=102.4e9,
        hbm_per_chip=16e9,
        nominal_tpu_freq=918.0,
        nominal_hbm_freq=3733.0,
        nominal_host_freq=1984.0,
        p_idle_chip=1.0,
        p_dyn_chip=5.5,
        p_hbm_chip=2.8,
        chips_per_host=1,
        p_host_idle=0.5,
        p_host_core=0.3,
    ),
    space_kind="edge_orin_nx",
    t_host_per_item=1.6e-3,
    contention_kappa=0.025,
    compute_eff=0.42,
    mem_eff=0.72,
)

POD_V5E = DeviceProfile(
    name="pod-v5e",
    hw=DEFAULT_HW,
    space_kind="tpu_pod",
    n_chips=256,
    t_host_per_item=0.1e-3,
    contention_kappa=0.06,
    compute_eff=0.50,
    mem_eff=0.80,
)

DEVICE_PROFILES: Dict[str, DeviceProfile] = {
    p.name: p
    for p in (EDGE_XAVIER_NX, EDGE_ORIN_NANO, EDGE_ORIN_NX, POD_V5E)
}


def get_profile(name: str) -> DeviceProfile:
    """Look up a device profile by registry name (KeyError lists the
    known names)."""
    if name not in DEVICE_PROFILES:
        raise KeyError(
            f"unknown device profile {name!r}; known: {sorted(DEVICE_PROFILES)}"
        )
    return DEVICE_PROFILES[name]


# ---------------------------------------------------------------------------
# Non-stationary operating conditions: drift schedules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DriftState:
    """The device's operating condition at one control interval.

    ``clock_derate``/``mem_derate`` are the fractional loss of *delivered*
    accelerator/memory clock at the top DVFS level (throttling scales
    quadratically with the requested level, so racing the clock loses more
    than idling at the bottom of the ladder — the per-level shape real
    thermal governors produce). ``static_inflation`` inflates the idle
    power draw (hot silicon leaks more). ``host_inflation`` and
    ``kappa_add`` model a co-tenant stealing host cycles and DRAM
    bandwidth. ``budget_scale`` rescales the external power budget — a
    commanded change, not a device property, so the control loop reads it
    from the schedule rather than detecting it.
    """

    clock_derate: float = 0.0
    mem_derate: float = 0.0
    static_inflation: float = 0.0
    host_inflation: float = 0.0
    kappa_add: float = 0.0
    budget_scale: float = 1.0

    @property
    def stationary(self) -> bool:
        return self == DRIFT_NONE


DRIFT_NONE = DriftState()


@dataclasses.dataclass(frozen=True)
class ThermalRamp:
    """Thermal throttling: derating ramps linearly over ``duration``
    intervals starting at ``start`` and then holds."""

    start: int
    duration: int = 6
    clock_derate: float = 0.30
    mem_derate: float = 0.15
    static_inflation: float = 0.30

    def state_at(self, t: int) -> DriftState:
        ramp = min(max((t - self.start) / max(self.duration, 1), 0.0), 1.0)
        return DriftState(
            clock_derate=ramp * self.clock_derate,
            mem_derate=ramp * self.mem_derate,
            static_inflation=ramp * self.static_inflation,
        )

    @property
    def end(self) -> int:
        return self.start + self.duration


@dataclasses.dataclass(frozen=True)
class CotenantStep:
    """A co-located job lands at ``start`` (and leaves at ``until`` if
    set): host preprocessing slows down, per-stream DRAM contention
    rises, and the co-tenant's own draw shows up on the shared power
    rail — the Fulcrum concurrent-workload setting."""

    start: int
    host_inflation: float = 0.8
    kappa_add: float = 0.12
    static_inflation: float = 0.0  # co-tenant draw, as a fraction of idle
    until: Optional[int] = None

    def state_at(self, t: int) -> DriftState:
        active = t >= self.start and (self.until is None or t < self.until)
        if not active:
            return DRIFT_NONE
        return DriftState(
            host_inflation=self.host_inflation,
            kappa_add=self.kappa_add,
            static_inflation=self.static_inflation,
        )

    @property
    def end(self) -> int:
        return self.start


@dataclasses.dataclass(frozen=True)
class BudgetStep:
    """The external power budget is rescaled at ``start`` — an operator
    command (e.g. battery-saver or a rack-level cap), carried on the same
    drift clock so the control loop sees it at the interval it lands."""

    start: int
    scale: float = 0.8

    def state_at(self, t: int) -> DriftState:
        if t < self.start:
            return DRIFT_NONE
        return DriftState(budget_scale=self.scale)

    @property
    def end(self) -> int:
        return self.start


DriftEvent = object  # ThermalRamp | CotenantStep | BudgetStep


@dataclasses.dataclass(frozen=True)
class DriftSchedule:
    """A set of drift events composed over the control-interval clock.

    Additive terms (derates, inflations, contention) sum and clip;
    ``budget_scale`` factors multiply. ``shift_start``/``shift_end``
    bracket the non-stationary transient for scoring (recovery windows
    are measured from ``shift_start``; "fully shifted" means
    ``t >= shift_end``).
    """

    events: Tuple[DriftEvent, ...] = ()

    def state_at(self, t: int) -> DriftState:
        clock = mem = static = host = kappa = 0.0
        budget = 1.0
        for ev in self.events:
            s = ev.state_at(t)
            clock += s.clock_derate
            mem += s.mem_derate
            static += s.static_inflation
            host += s.host_inflation
            kappa += s.kappa_add
            budget *= s.budget_scale
        return DriftState(
            clock_derate=min(clock, 0.9),
            mem_derate=min(mem, 0.9),
            static_inflation=static,
            host_inflation=host,
            kappa_add=kappa,
            budget_scale=budget,
        )

    @property
    def shift_start(self) -> int:
        return min((ev.start for ev in self.events), default=0)

    @property
    def shift_end(self) -> int:
        return max((ev.end for ev in self.events), default=0)

    def states_stacked(self, intervals: int) -> Dict[str, "object"]:
        """Per-interval drift vectors for a batched control loop.

        Returns (intervals,)-shaped float64 numpy arrays of every
        ``DriftState`` field — ``state_at(t)`` evaluated once per
        interval up front, so the batched episode engine (and the
        batched post-shift scoring) can index arrays instead of calling
        back into Python per interval.
        """
        states = [self.state_at(t) for t in range(intervals)]
        return {
            f.name: np.asarray(
                [getattr(s, f.name) for s in states], np.float64
            )
            for f in dataclasses.fields(DriftState)
        }


NO_DRIFT = DriftSchedule(())
