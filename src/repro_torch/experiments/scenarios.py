"""Declarative scenario grid: which cells exist and what each one means.

A *cell* is one (device profile × model config × workload trace ×
constraint regime) combination — the paper's evaluation grid (two Jetson
devices × three detection models × single-target and strict dual
regimes) generalized so new devices, models, traces or regimes are one
registry entry away.

Everything here is declarative and deterministic: ``enumerate_cells``
yields the full cartesian product in a fixed order, and
``resolve_targets`` turns a regime's *relative* knobs (fraction of the
cell's max throughput, slack over the oracle's power draw) into absolute
(τ target, power budget) numbers for that cell — the paper sets targets
per device/model the same way (§IV-A).

The static part of ``repro.experiments.scenarios``, copied. The
reference's other regime families are named in ``PENDING_FAMILIES`` with
the ROADMAP item that ports each; ``check_static`` raises for their cells.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.registry import get_config
from repro_torch.core.baselines import oracle
from repro_torch.core.evaluate import RegimeTargets
from repro_torch.device.hw import get_profile
from repro_torch.device.simulator import DeviceSimulator, build_cell_simulator


@dataclasses.dataclass(frozen=True)
class Workload:
    """One workload trace: the step shape and the measurement regime.

    ``kind`` selects the roofline shape (decode: memory-bound weight
    streaming amortized over ``batch``; prefill: compute-bound over
    ``seq`` prompt tokens). ``noise`` is the relative σ of the 1-second
    tegrastats-style samples — bursty traffic reads noisier (τ, p).
    """

    name: str
    kind: str  # decode | prefill
    batch: int = 8
    seq: int = 256
    noise: float = 0.02


@dataclasses.dataclass(frozen=True)
class Regime:
    """One stationary constraint regime, relative to the cell's own
    landscape.

    ``tau_frac`` — τ target as a fraction of the cell's max throughput
    (0 → no target). ``p_slack`` — power budget as a multiple of the
    power the oracle draws at the τ target (None → uncapped): strict but
    satisfiable. ``mode`` is the CORAL objective ("dual" or
    "throughput"). The reference's other budget anchors ("pmin",
    "max_power") serve only its drift regimes.
    """

    name: str
    mode: str
    tau_frac: float = 0.0
    p_slack: Optional[float] = None

    @property
    def single_target(self) -> bool:
        return self.p_slack is None

    @property
    def dual_constraint(self) -> bool:
        return self.p_slack is not None


@dataclasses.dataclass(frozen=True)
class Cell:
    device: str
    model: str
    workload: str
    regime: str

    def key(self) -> Tuple[str, str, str, str]:
        return (self.device, self.model, self.workload, self.regime)


WORKLOADS: Dict[str, Workload] = {
    w.name: w
    for w in (
        Workload("decode_steady", kind="decode", batch=8, noise=0.02),
        Workload("decode_bursty", kind="decode", batch=8, noise=0.04),
        Workload("prefill_steady", kind="prefill", seq=256, noise=0.02),
    )
}

REGIMES: Dict[str, Regime] = {
    r.name: r
    for r in (
        # single-target: meet a τ floor at best efficiency (paper Fig. 3/4)
        Regime("single_tau", mode="dual", tau_frac=0.55),
        # single-target: maximize raw throughput (paper §IV-B)
        Regime("max_throughput", mode="throughput"),
        # strict dual: τ floor AND a tight power cap (paper Fig. 5/6).
        # The higher τ floor + 1.2× slack keeps every cell's feasible set
        # at ~10-20% of the grid — strict enough that presets and ALERT
        # bust the cap, wide enough that CORAL's 10-measurement budget
        # reliably lands inside (the paper's §IV-C operating point).
        Regime("strict_dual", mode="dual", tau_frac=0.7, p_slack=1.2),
    )
}

# The reference's other regime families, by regime name, and the ROADMAP
# queue 1 item that ports each. Their cells raise NotImplementedError.
PENDING_FAMILIES: Dict[str, Tuple[Tuple[str, ...], int]] = {
    "drift": (("thermal-ramp", "cotenant-step", "budget-step"), 7),
    "fault": (("fault-telemetry", "fault-blackout", "fault-actuator"), 8),
    "offload": (("offload_mmpp", "offload_diurnal"), 9),
    "cotenant": (("cotenant_balanced", "cotenant_skewed"), 10),
}

# Default grid axes: the paper's 2 devices × 3 models × 2 regimes shape,
# with the model axis spanning a ~6× active-parameter range (the paper's
# detectors span ~20× — same heavy-tail idea on registry architectures).
MATRIX_DEVICES: Tuple[str, ...] = ("edge-xavier-nx", "edge-orin-nano")
MATRIX_MODELS: Tuple[str, ...] = ("qwen2.5-3b", "granite-8b", "internlm2-20b")
MATRIX_WORKLOADS: Tuple[str, ...] = ("decode_steady",)
MATRIX_REGIMES: Tuple[str, ...] = ("single_tau", "max_throughput", "strict_dual")

# The committed static grid (BENCH_matrix.json ``cells``): 2 devices ×
# 3 models × these 3 workloads × 3 regimes = 54 cells.
FULL_MATRIX_WORKLOADS: Tuple[str, ...] = (
    "decode_steady",
    "decode_bursty",
    "prefill_steady",
)


def check_static(cell: Cell) -> None:
    """Raise NotImplementedError for a cell of a family the port does not
    run yet (naming its ROADMAP item), KeyError for an unknown regime."""
    for family, (names, item) in PENDING_FAMILIES.items():
        if cell.regime in names:
            raise NotImplementedError(
                f"{family} cells ({cell.regime!r}) are not ported yet "
                f"(ROADMAP queue 1 item {item})"
            )
    if cell.regime not in REGIMES:
        raise KeyError(f"unknown regime {cell.regime!r}")


def enumerate_cells(
    devices: Sequence[str] = MATRIX_DEVICES,
    models: Sequence[str] = MATRIX_MODELS,
    workloads: Sequence[str] = MATRIX_WORKLOADS,
    regimes: Sequence[str] = MATRIX_REGIMES,
) -> List[Cell]:
    """The exhaustive cell list, in deterministic axis-major order
    (devices outermost, regimes innermost). Unknown names fail fast."""
    for d in devices:
        get_profile(d)
    for m in models:
        get_config(m)
    unknown = [w for w in workloads if w not in WORKLOADS]
    unknown += [r for r in regimes if r not in REGIMES]
    if unknown:
        raise KeyError(f"unknown workload/regime names: {unknown}")
    return [
        Cell(d, m, w, r)
        for d in devices
        for m in models
        for w in workloads
        for r in regimes
    ]


def cell_simulator(
    cell: Cell, noise: Optional[float] = None, seed: int = 0
) -> DeviceSimulator:
    """Build the cell's device: profile knobs + model footprint + workload
    shape. ``noise=None`` uses the workload's trace noise; ``noise=0.0``
    gives the noise-free ground-truth twin ORACLE and scoring use."""
    w = WORKLOADS[cell.workload]
    return build_cell_simulator(
        get_profile(cell.device),
        get_config(cell.model),
        kind=w.kind,
        batch=w.batch,
        seq=w.seq,
        noise=w.noise if noise is None else noise,
        seed=seed,
    )


def resolve_targets(
    cell: Cell, sim0: Optional[DeviceSimulator] = None
) -> RegimeTargets:
    """Absolute (τ target, power budget) for a cell, from its noise-free
    landscape: τ target = tau_frac · max-τ; budget = p_slack × the power
    the oracle draws at that target."""
    regime = REGIMES[cell.regime]
    if sim0 is None:
        sim0 = cell_simulator(cell, noise=0.0)
    tau_target = 0.0
    if regime.tau_frac > 0.0:
        om = oracle(sim0.space, sim0, tau_target=0.0)
        tau_target = round(regime.tau_frac * om.tau, 3)
    p_budget = float("inf")
    if regime.p_slack is not None:
        p_budget = oracle(sim0.space, sim0, tau_target).power * regime.p_slack
    return RegimeTargets(mode=regime.mode, tau_target=tau_target, p_budget=p_budget)
