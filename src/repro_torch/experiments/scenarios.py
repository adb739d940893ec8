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

``repro.experiments.scenarios``, copied for the families the port runs:
the static grid, the dynamic (drift) regimes and the fault regimes. The
reference's offload and cotenant families are named in
``PENDING_FAMILIES`` with the ROADMAP item that ports each;
``check_ported`` raises for their cells.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.registry import get_config
from repro_torch.core.baselines import oracle
from repro_torch.core.evaluate import RegimeTargets
from repro_torch.core.faults import (
    ActuationFailure,
    FaultSchedule,
    FaultTables,
    FirmwareReset,
    SensorDropout,
    TelemetrySpike,
)
from repro_torch.device.hw import (
    BudgetStep,
    CotenantStep,
    DriftSchedule,
    ThermalRamp,
    get_profile,
)
from repro_torch.device.simulator import (
    DeviceSimulator,
    DriftingSimulator,
    FaultySimulator,
    build_cell_simulator,
)


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
    """One constraint regime, relative to the cell's own landscape.

    ``tau_frac`` — τ target as a fraction of the cell's max throughput
    (0 → no target). ``p_slack`` — power budget as a multiple of the
    cell's budget anchor (None → uncapped). ``mode`` is the CORAL
    objective ("dual" or "throughput").

    ``p_anchor`` names the landscape statistic the budget multiplies:
      "oracle"    — the single-target oracle's draw (the static grid's
                    convention: strict but satisfiable);
      "pmin"      — the minimum power that meets the τ floor (the
                    cheapest operating point satisfying the SLO — the
                    edge-deployment operating point drift knocks out);
      "max_power" — the grid's maximum draw (for throughput-mode board
                    caps).

    ``drift`` names a ``DRIFTS`` schedule for dynamic (non-stationary)
    regimes; None is a stationary cell.
    """

    name: str
    mode: str
    tau_frac: float = 0.0
    p_slack: Optional[float] = None
    p_anchor: str = "oracle"
    drift: Optional[str] = None

    @property
    def single_target(self) -> bool:
        return self.p_slack is None

    @property
    def dual_constraint(self) -> bool:
        return self.p_slack is not None

    @property
    def dynamic(self) -> bool:
        return self.drift is not None


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

# Control-interval timeline shared by every dynamic cell: explore, hold,
# shift at SHIFT_START, and enough post-shift intervals for detection +
# bounded re-exploration (up to 1 + max_retries epochs) + a settled hold.
DRIFT_INTERVALS = 64
DRIFT_SHIFT_START = 20

# Named drift schedules. Each one was validated against the dynamic grid
# below: the *static* one-shot tuner's held config demonstrably breaks
# (constraint bust or large score loss) while the post-shift landscape
# keeps a feasible region wide enough (≥ ~5% of the grid) for bounded
# re-exploration to reach ≥0.85 of the post-shift oracle.
DRIFTS: Dict[str, DriftSchedule] = {
    # Thermal throttling: delivered clocks derate per-level (quadratic in
    # the requested step) over a 6-interval ramp; hot silicon leaks extra
    # idle power. Breaks clock-racing helds; low-step configs shelter.
    "thermal-ramp": DriftSchedule(
        (
            ThermalRamp(
                DRIFT_SHIFT_START,
                duration=6,
                clock_derate=0.25,
                mem_derate=0.2,
                static_inflation=0.15,
            ),
        )
    ),
    # A co-located job lands on the host: preprocessing slows ~4×, mild
    # extra DRAM contention, and the co-tenant's own draw appears on the
    # shared rail. Moves the optimum toward deeper concurrency (hide the
    # host stage behind the device) — host-sensitive cells reorder.
    "cotenant-step": DriftSchedule(
        (
            CotenantStep(
                DRIFT_SHIFT_START,
                host_inflation=3.0,
                kappa_add=0.05,
                static_inflation=0.05,
            ),
        )
    ),
    # The operator cuts the board power cap to 55% (battery saver / rack
    # cap): a commanded change carried on the drift clock, not detected.
    "budget-step": DriftSchedule((BudgetStep(DRIFT_SHIFT_START, scale=0.55),)),
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
        # ---- dynamic regimes (EXPERIMENTS.md §Drift) -------------------
        # τ floor + a cap anchored at the cheapest SLO-meeting draw: the
        # efficiency pick sits near the floor, so thermal derating knocks
        # it out while headroom higher up the ladder stays feasible.
        Regime(
            "thermal-ramp",
            mode="dual",
            tau_frac=0.55,
            p_slack=1.6,
            p_anchor="pmin",
            drift="thermal-ramp",
        ),
        Regime(
            "cotenant-step",
            mode="dual",
            tau_frac=0.5,
            p_slack=1.4,
            p_anchor="pmin",
            drift="cotenant-step",
        ),
        # max-τ under a board cap (85% of max draw); the commanded cut to
        # 55% strands the cap-adjacent held config above the new budget.
        Regime(
            "budget-step",
            mode="throughput",
            p_slack=0.85,
            p_anchor="max_power",
            drift="budget-step",
        ),
    )
}

# The reference's regime families not ported yet, by regime name, and the
# ROADMAP queue 1 item that ports each. Their cells raise
# NotImplementedError.
PENDING_FAMILIES: Dict[str, Tuple[Tuple[str, ...], int]] = {
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


# Dynamic (drift) cells: each regime is paired with devices/models where
# its physics genuinely reorders the landscape — thermal throttling bites
# the clock-racing Orin NX; the commanded budget cut strands the
# efficiency-tuned Nano; host-side co-tenancy reorders the host-bound
# small models. Xavier NX is deliberately absent: its efficiency optimum
# sits in the corner of a τ plateau that every drift axis derates
# uniformly, so one-shot tuning there is drift-*insensitive* — the same
# device-dependent sensitivity PolyThrottle reports (EXPERIMENTS.md
# §Drift documents the reasoning).
MATRIX_DRIFT_CELLS: Tuple[Cell, ...] = (
    Cell("edge-orin-nx", "qwen2.5-3b", "decode_steady", "thermal-ramp"),
    Cell("edge-orin-nx", "granite-8b", "decode_steady", "thermal-ramp"),
    Cell("edge-orin-nx", "hymba-1.5b", "decode_steady", "cotenant-step"),
    Cell("edge-orin-nano", "whisper-medium", "decode_steady", "cotenant-step"),
    Cell("edge-orin-nano", "qwen2.5-3b", "decode_steady", "budget-step"),
    Cell("edge-orin-nano", "granite-8b", "decode_steady", "budget-step"),
)

# QUICK (CI-smoke) subset: one cell per dynamic regime.
QUICK_DRIFT_CELLS: Tuple[Cell, ...] = (
    MATRIX_DRIFT_CELLS[0],
    MATRIX_DRIFT_CELLS[2],
    MATRIX_DRIFT_CELLS[4],
)


@dataclasses.dataclass(frozen=True)
class FaultRegime:
    """One fault regime: a stationary base regime (whose constraint shape
    and landscape the cell keeps — faults corrupt the *measurement and
    actuation path*, never the device physics) plus a named ``FAULTS``
    schedule injected into it (EXPERIMENTS.md §Fault tolerance)."""

    name: str
    base: str  # REGIMES key supplying the (τ target, power budget) shape
    fault: str  # FAULTS schedule key

    @property
    def dual_constraint(self) -> bool:
        return REGIMES[self.base].dual_constraint

    @property
    def mode(self) -> str:
        return REGIMES[self.base].mode


# Control-interval timeline shared by every fault cell: the 10-sample
# static budget is too short to even see a blackout + recovery, so fault
# episodes run 40 intervals (explore → fault window → recover).
FAULT_INTERVALS = 40

# Named fault schedules. Each was validated against the fault grid below:
# hardened CORAL holds ≥ 0.85 of the fault-free oracle with zero budget
# violations on every cell, while the non-hardened ablation — same twin,
# same realization — ends infeasible or violating on every cell
# (``BENCH_matrix.json`` records both directions).
FAULTS: Dict[str, FaultSchedule] = {
    # Garbage telemetry under load: heavy-tailed spikes on both channels
    # plus lost samples. The τ channel wraps *upward* (counter-wrap /
    # unit-mismatch reads huge) — the decisive poison for a blind
    # ingester: one up-spiked τ on an in-budget row that truly misses
    # the floor anoints it best-feasible forever. The p channel glitches
    # both ways, prohibiting good rows. The MAD gate rejects all of it.
    "telemetry-storm": FaultSchedule(
        "telemetry-storm",
        (
            # a stuck counter spews garbage for 6 straight exploration
            # intervals (right after the gate's 5-sample calibration
            # prefix — the probes measured there are mostly infeasible
            # rows, which is what makes the poison fatal to the ablation)
            TelemetrySpike(
                start=6, stop=10, rate=1.0, magnitude=1000.0, axis="tau",
                direction="up",
            ),
            TelemetrySpike(
                start=10, rate=0.25, magnitude=1000.0, axis="power",
                direction="up",
            ),
            SensorDropout(start=10, rate=0.2),
        ),
    ),
    # The telemetry daemon dies for 8 straight intervals, then comes back
    # glitchy: trips the watchdog (dark ≥ K) → degrade to the safe anchor
    # → resume exploration when samples return.
    "sensor-blackout": FaultSchedule(
        "sensor-blackout",
        (
            SensorDropout(start=12, stop=20, rate=1.0),
            # the daemon comes back glitchy: the blind ingester learned
            # nothing from eight NaN intervals, so it is still probing
            # infeasible rows when the garbage window opens
            TelemetrySpike(
                start=20, stop=25, rate=1.0, magnitude=1000.0, axis="tau",
                direction="up",
            ),
            SensorDropout(start=26, rate=0.15),
        ),
    ),
    # Sticky knobs + governor resets: commanded ≠ applied, so the blind
    # writer attributes the max-power boot row's draw (or a stale
    # config's τ) to whatever it commanded; readback + bounded retry
    # keeps the hardened ledger attributed to the config in force.
    "flaky-actuator": FaultSchedule(
        "flaky-actuator",
        (
            ActuationFailure(start=3, rate=0.35, mean_tries=2.0),
            FirmwareReset(at=(14, 26)),
            TelemetrySpike(
                start=6, stop=8, rate=1.0, magnitude=1000.0, axis="tau",
                direction="up",
            ),
            SensorDropout(start=10, rate=0.15),
        ),
    ),
}

FAULT_REGIMES: Dict[str, FaultRegime] = {
    r.name: r
    for r in (
        FaultRegime("fault-telemetry", base="strict_dual", fault="telemetry-storm"),
        FaultRegime("fault-blackout", base="strict_dual", fault="sensor-blackout"),
        FaultRegime("fault-actuator", base="strict_dual", fault="flaky-actuator"),
    )
}

# Fault cells: every fault regime on both matrix devices — fault
# injection corrupts the measurement/actuation path, so unlike drift
# there is no device whose *landscape* shelters it.
MATRIX_FAULT_CELLS: Tuple[Cell, ...] = (
    Cell("edge-xavier-nx", "qwen2.5-3b", "decode_steady", "fault-telemetry"),
    Cell("edge-orin-nano", "granite-8b", "decode_steady", "fault-telemetry"),
    Cell("edge-xavier-nx", "granite-8b", "decode_steady", "fault-blackout"),
    Cell("edge-orin-nano", "qwen2.5-3b", "decode_steady", "fault-blackout"),
    Cell("edge-xavier-nx", "qwen2.5-3b", "decode_steady", "fault-actuator"),
    Cell("edge-orin-nano", "granite-8b", "decode_steady", "fault-actuator"),
)

# QUICK (CI-smoke) subset: one telemetry-path and one actuation-path cell.
QUICK_FAULT_CELLS: Tuple[Cell, ...] = (
    MATRIX_FAULT_CELLS[0],
    MATRIX_FAULT_CELLS[5],
)


def _fault_base_cell(cell: Cell) -> Cell:
    """The stationary cell a fault cell corrupts (same device/model/
    workload, the regime swapped for the fault regime's base)."""
    return Cell(
        cell.device, cell.model, cell.workload, FAULT_REGIMES[cell.regime].base
    )


def fault_tables(cell: Cell, seed: int, intervals: int = FAULT_INTERVALS) -> FaultTables:
    """The cell's realized fault tables at one seed — deterministic, so
    the scalar twin, the batched engine and the scoring path all consume
    byte-identical realizations without sharing objects."""
    return FAULTS[FAULT_REGIMES[cell.regime].fault].realize(intervals, seed)


def fault_cell_simulator(
    cell: Cell, noise: Optional[float] = None, seed: int = 0
) -> FaultySimulator:
    """Build the cell's fault-injected twin: the base regime's stationary
    simulator wrapped in the schedule's realization at this seed.
    ``noise=0.0`` still injects faults — the ground-truth twin for fault
    cells is the *base* cell's simulator (``build_twin`` on
    ``_fault_base_cell``), because scoring asks what the chosen config
    delivers once the glitch is gone."""
    return FaultySimulator(
        cell_simulator(_fault_base_cell(cell), noise=noise, seed=seed),
        fault_tables(cell, seed),
    )


# Fault cells re-center the τ target at this fraction of the
# budget-constrained frontier (the best τ any in-budget row achieves).
# With the base regime's slack target, every in-budget row on the larger
# devices already meets τ, so a corrupted pick can only waste power —
# never violate. Fault tolerance is scored where it matters: near the
# feasibility boundary, where one swallowed outlier is the difference
# between a valid pick and a violating one.
FAULT_TAU_TIGHTEN = 0.9


def resolve_fault_targets(cell: Cell) -> RegimeTargets:
    """Absolute targets for a fault cell: the base regime's power budget
    (faults never move the power goalpost), with the τ target raised to
    ``FAULT_TAU_TIGHTEN`` of the budget-constrained frontier so the
    feasible set is a boundary sliver on every device class."""
    import numpy as np

    base = resolve_targets(_fault_base_cell(cell))
    sim0 = cell_simulator(_fault_base_cell(cell), noise=0.0)
    tau_all, p_all = (np.asarray(a) for a in sim0.exact_all())
    frontier = float(tau_all[p_all <= base.p_budget].max())
    tau_target = round(max(base.tau_target, FAULT_TAU_TIGHTEN * frontier), 3)
    return RegimeTargets(
        mode=base.mode, tau_target=tau_target, p_budget=base.p_budget
    )


def check_ported(cell: Cell) -> None:
    """Raise NotImplementedError for a cell of a family the port does not
    run yet (naming its ROADMAP item), KeyError for an unknown regime."""
    for family, (names, item) in PENDING_FAMILIES.items():
        if cell.regime in names:
            raise NotImplementedError(
                f"{family} cells ({cell.regime!r}) are not ported yet "
                f"(ROADMAP queue 1 item {item})"
            )
    if cell.regime not in REGIMES and cell.regime not in FAULT_REGIMES:
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
    landscape: τ target = tau_frac · max-τ; budget = p_slack × the
    regime's budget anchor — the single-target oracle's draw ("oracle",
    strict but satisfiable), the cheapest draw meeting the τ floor
    ("pmin"), or the grid's max draw ("max_power")."""
    regime = REGIMES[cell.regime]
    if sim0 is None:
        sim0 = cell_simulator(cell, noise=0.0)
    tau_target = 0.0
    if regime.tau_frac > 0.0:
        om = oracle(sim0.space, sim0, tau_target=0.0)
        tau_target = round(regime.tau_frac * om.tau, 3)
    p_budget = float("inf")
    if regime.p_slack is not None:
        if regime.p_anchor == "oracle":
            p_anchor = oracle(sim0.space, sim0, tau_target).power
        else:
            tau_all, p_all = sim0.exact_all()
            if regime.p_anchor == "pmin":
                p_anchor = float(p_all[tau_all >= tau_target].min())
            elif regime.p_anchor == "max_power":
                p_anchor = float(p_all.max())
            else:
                raise KeyError(f"unknown p_anchor {regime.p_anchor!r}")
        p_budget = p_anchor * regime.p_slack
    return RegimeTargets(mode=regime.mode, tau_target=tau_target, p_budget=p_budget)


def drifting_cell_simulator(
    cell: Cell, noise: Optional[float] = None, seed: int = 0
) -> DriftingSimulator:
    """The cell's time-varying device twin: its stationary simulator
    wrapped in the regime's drift schedule."""
    regime = REGIMES[cell.regime]
    if regime.drift is None:
        raise ValueError(f"regime {cell.regime!r} is stationary")
    return DriftingSimulator(
        cell_simulator(cell, noise=noise, seed=seed), DRIFTS[regime.drift]
    )
