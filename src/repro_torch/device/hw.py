"""Hardware constants and the device-profile registry.

``TPUv5eSpec`` holds one accelerator's DVFS/power constants (the same
constants the roofline analysis uses — EXPERIMENTS.md §Roofline). A
``DeviceProfile`` bundles a spec with the knob grid it exposes and the
efficiency/contention parameters needed to turn a model's FLOP/byte
footprint into ``RooflineTerms`` — the unit the scenario matrix
enumerates over (the paper's "Xavier NX vs Orin Nano" axis).

A plain copy of ``repro.device.hw`` up to the profile registry. The
reference's drift schedules (``DriftSchedule`` and its events) wait for
the drift episodes (ROADMAP queue 1 item 7), its fleet sampling
(``FleetPerturbation``, ``sample_perturbations``) for the fleet (item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Dict


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
